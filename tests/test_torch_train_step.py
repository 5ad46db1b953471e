"""The port's train step (mxnet_tpu_torch.models.make_train_step) held
against the JAX package's (mxnet_tpu.models.make_train_step on a one-device
mesh) on the CPU: the same numpy weights, carried across with
``convert.params_from_numpy``, and the same batches go through both, and the
losses, params and Adam/LAMB moments are compared.

The JAX step donates its inputs, so every JAX run starts from fresh arrays.

The port's step is captured by default (a program of the program store; on
the CPU its body runs through the program's static buffers): it is also
held bitwise against its eager body (``MXNET_COMPILED_STEP=0``), and, in
the ``cuda``-marked tests, replayed as a CUDA graph on the card.
"""
import dataclasses
import gc
import time
import weakref

from types import SimpleNamespace

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.models import transformer_lm as ttl

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jm = LazyModule("mxnet_tpu.models")
par = LazyModule("mxnet_tpu.parallel")

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEPS = 3
LR = 1e-3
# fp32, after 3 steps: the same arithmetic summed in other orders. Losses
# and moments agree to about 1e-6 relative; a param moves by at most a few
# lr, and Adam's m / sqrt(v) amplifies the gradients' last-bit differences
# where g is near 0, so params get an absolute bound of lr / 100.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=LR / 100)
MOMENT_RTOL, MOMENT_ATOL_FRAC = 1e-4, 1e-5   # atol: fraction of max |ref|
# bf16, after 3 steps: the two frameworks round activations and gradients
# to bf16 (2^-8 relative) at different places (XLA keeps fp32 inside a
# fusion). Bounds on the loss, and on the relative L2 error of all params /
# all m / all v together; about 5x what was measured.
BF16_LOSS_ATOL = 2e-3
BF16_REL_L2 = {"params": 5e-3, "m": 3e-2, "v": 5e-2}


def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=128, num_layers=2, num_heads=2, hidden=32,
                mlp_hidden=64, max_len=64)
    base.update(kw)
    flash = base.pop("use_flash_attention", False)
    return (jm.TransformerLMConfig(dtype=getattr(jnp, dtype),
                                   use_flash_attention=flash,
                                   **base),
            tm.TransformerLMConfig(dtype=_TORCH_DTYPE[dtype],
                                   use_flash_attention=flash, **base))


def _weights(jcfg, seed=0):
    return {k: onp.asarray(v)
            for k, v in jm.init_params(jax.random.PRNGKey(seed), jcfg).items()}


def _batch(shape, vocab=128, seed=0):
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, vocab, shape).astype(onp.int32)
    labels = onp.where(rng.rand(*shape) < 0.3, toks, -1).astype(onp.int32)
    return toks, labels


def _jax_run(jcfg, weights, toks, labels, steps=STEPS, **kw):
    mesh = par.make_mesh({"dp": 1})
    with mesh:
        step = jm.make_train_step(jcfg, mesh, lr=LR, **kw)
        p = {k: jnp.asarray(v) for k, v in weights.items()}
        m, v = jm.init_opt_state(p)
        losses = []
        for t in range(1, steps + 1):
            p, m, v, loss = step(p, m, v, jnp.asarray(toks),
                                 jnp.asarray(labels), jnp.float32(t))
            losses.append(float(loss))
    return losses, [{k: onp.asarray(x, onp.float32) for k, x in d.items()}
                    for d in (p, m, v)]


def _port_run(tcfg, weights, toks, labels, steps=STEPS, **kw):
    p = params_from_numpy(weights, tcfg, device="cpu")
    m, v = tm.init_opt_state(p)
    step = tm.make_train_step(tcfg, lr=LR, device="cpu", **kw)
    losses = []
    for t in range(1, steps + 1):
        p, m, v, loss = step(p, m, v, toks, labels, t)
        losses.append(float(loss))
    return losses, [{k: x.float().numpy() for k, x in d.items()}
                    for d in (p, m, v)]


def _assert_state_close(port, ref):
    for what, t_d, j_d in zip(("params", "m", "v"), port, ref):
        assert set(t_d) == set(j_d)
        for k, j in j_d.items():
            if what == "params":
                tol = PARAM_TOL
            else:
                tol = dict(rtol=MOMENT_RTOL,
                           atol=MOMENT_ATOL_FRAC * float(abs(j).max()))
            onp.testing.assert_allclose(t_d[k], j, err_msg=f"{what} {k}",
                                        **tol)


@pytest.mark.parametrize("optimizer,grad_accum,remat", [
    ("adam", 1, False), ("adam", 2, False), ("lamb", 1, False),
    ("lamb", 2, False), ("adam", 1, True)])
def test_train_step_matches_jax_fp32(optimizer, grad_accum, remat):
    jcfg, tcfg = _cfgs(remat=remat)
    weights = _weights(jcfg)
    toks, labels = _batch((4, 16))
    kw = dict(optimizer=optimizer, grad_accum=grad_accum)
    j_losses, j_state = _jax_run(jcfg, weights, toks, labels, **kw)
    t_losses, t_state = _port_run(tcfg, weights, toks, labels, **kw)
    onp.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    _assert_state_close(t_state, j_state)


def test_train_step_matches_jax_fp32_flash():
    # the JAX side runs the Pallas kernels (forward and both backward
    # kernels) in the interpreter; s 256 gives two 128-row blocks
    jcfg, tcfg = _cfgs(num_layers=1, max_len=256, use_flash_attention=True)
    weights = _weights(jcfg, seed=1)
    toks, labels = _batch((2, 256), seed=1)
    j_losses, j_state = _jax_run(jcfg, weights, toks, labels)
    t_losses, t_state = _port_run(tcfg, weights, toks, labels)
    onp.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    _assert_state_close(t_state, j_state)


def test_train_step_matches_jax_bf16_grad_accum():
    jcfg, tcfg = _cfgs("bfloat16")
    weights = _weights(jcfg)
    toks, labels = _batch((4, 16))
    j_losses, j_state = _jax_run(jcfg, weights, toks, labels, grad_accum=2)
    t_losses, t_state = _port_run(tcfg, weights, toks, labels, grad_accum=2)
    onp.testing.assert_allclose(t_losses, j_losses, rtol=0,
                                atol=BF16_LOSS_ATOL)
    for what, t_d, j_d in zip(("params", "m", "v"), t_state, j_state):
        a = onp.concatenate([t_d[k].ravel() for k in sorted(j_d)])
        b = onp.concatenate([j_d[k].ravel() for k in sorted(j_d)])
        rel = onp.linalg.norm(a - b) / onp.linalg.norm(b)
        assert rel <= BF16_REL_L2[what], (what, rel)


def test_grad_accum_sums_micro_gradients_in_fp32():
    # bf16 params: each micro-gradient is bf16, their sum is taken in fp32
    # buffers (as the reference's scan does), not through .grad, which would
    # sum in bf16 and leave every entry a bf16 value
    _, tcfg = _cfgs("bfloat16")
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks, labels = (torch.from_numpy(a).long() for a in _batch((4, 16)))
    loss, grads = ttl._grads(p, toks, labels, tcfg, 2, 0.01, "cpu")
    assert loss.dtype == torch.float32 and loss.dim() == 0
    g = torch.cat([x.ravel() for x in grads])
    assert g.dtype == torch.float32
    off_grid = (g != g.to(torch.bfloat16).float()).float().mean().item()
    assert off_grid > 0.2
    assert all(not w.requires_grad for w in p.values())


def test_remat_gives_the_same_loss_and_params():
    _, tcfg = _cfgs()
    weights = _weights(_cfgs()[0])
    toks, labels = _batch((4, 16))
    plain = _port_run(tcfg, weights, toks, labels, steps=2)
    remat = _port_run(dataclasses.replace(tcfg, remat=True), weights, toks,
                      labels, steps=2)
    assert plain[0] == remat[0]
    for a, b in zip(plain[1], remat[1]):
        for k in a:
            onp.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_step_updates_in_place_and_never_leaves_grad_on():
    _, tcfg = _cfgs()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    m, v = tm.init_opt_state(p)
    before = {k: w.clone() for k, w in p.items()}
    ptrs = {k: w.data_ptr() for k, w in p.items()}
    step = tm.make_train_step(tcfg, lr=LR, device="cpu")
    toks, labels = _batch((2, 16))
    p2, m2, v2, loss = step(p, m, v, toks, labels, 1)
    assert p2 is p and m2 is m and v2 is v
    assert {k: w.data_ptr() for k, w in p.items()} == ptrs
    assert all(not w.requires_grad for w in p.values())
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert loss.dtype == torch.float32 and loss.requires_grad is False
    assert any(not torch.equal(before[k], p[k]) for k in p)
    assert all(x.abs().sum() > 0 for x in m.values())


def test_init_opt_state_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    weights = _weights(jcfg)
    j_m, j_v = jm.init_opt_state({k: jnp.asarray(v)
                                  for k, v in weights.items()})
    t_m, t_v = tm.init_opt_state(params_from_numpy(weights, tcfg,
                                                   device="cpu"))
    for j_d, t_d in ((j_m, t_m), (j_v, t_v)):
        assert list(t_d) == list(j_d)
        for k, j in j_d.items():
            assert tuple(t_d[k].shape) == tuple(j.shape)
            assert j.dtype == jnp.float32 and t_d[k].dtype == torch.float32
            assert not bool(t_d[k].any())


@pytest.mark.parametrize("case", ["batch_not_divisible", "mesh", "moe",
                                  "optimizer"])
def test_train_step_refuses(case):
    _, tcfg = _cfgs()
    if case == "batch_not_divisible":
        p = tm.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        m, v = tm.init_opt_state(p)
        step = tm.make_train_step(tcfg, grad_accum=2, device="cpu")
        toks, labels = _batch((3, 16))
        with pytest.raises(ValueError, match="grad_accum"):
            step(p, m, v, toks, labels, 1)
    elif case == "mesh":
        # a mesh runs (tests/test_torch_lm_mesh.py); something else raises
        with pytest.raises(TypeError, match="mesh"):
            tm.make_train_step(tcfg, mesh=object(), device="cpu")
    elif case == "moe":
        # mixture-of-experts layers with ring attention build; experts the
        # 'ep' axis does not split refuse
        cfg = dataclasses.replace(tcfg, num_experts=4,
                                  use_ring_attention=True)
        tm.make_train_step(cfg, device="cpu")
        mesh = SimpleNamespace(shape={"ep": 3}, device=torch.device("cpu"),
                               coordinate=lambda axis: 0)
        with pytest.raises(ValueError, match="num_experts=4"):
            tm.make_train_step(cfg, mesh=mesh)
    else:
        with pytest.raises(ValueError, match="optimizer"):
            tm.make_train_step(tcfg, optimizer="sgd", device="cpu")


# ---------------------------------------------------------------------------
# the captured step (a program of the program store's train_step namespace)
# ---------------------------------------------------------------------------


@pytest.fixture
def compiled(monkeypatch):
    """``compiled(on)`` sets MXNET_COMPILED_STEP for the rest of one test,
    refreshing the port's config cache on the way in and out."""
    from mxnet_tpu_torch import config as tconfig

    def set_(on):
        monkeypatch.setenv("MXNET_COMPILED_STEP", "1" if on else "0")
        tconfig.refresh("MXNET_COMPILED_STEP")

    yield set_
    monkeypatch.delenv("MXNET_COMPILED_STEP", raising=False)
    tconfig.refresh("MXNET_COMPILED_STEP")


def _steps(tcfg, weights, toks, labels, ts, **kw):
    """Run ``make_train_step(**kw)`` at step numbers ``ts``; returns the
    losses and the params and moments, as tensors."""
    p = params_from_numpy(weights, tcfg, device="cpu")
    m, v = tm.init_opt_state(p)
    step = tm.make_train_step(tcfg, lr=LR, device="cpu", **kw)
    losses = []
    for t in ts:
        p, m, v, loss = step(p, m, v, toks, labels, t)
        losses.append(loss)
    return losses, [x for d in (p, m, v) for x in d.values()]


@pytest.mark.parametrize("t_kind", ["int", "tensor"])
@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_captured_step_equals_the_eager_body_bitwise(t_kind, optimizer,
                                                    compiled):
    from mxnet_tpu_torch import cached_step as tcs

    _, tcfg = _cfgs()
    weights = {k: v.numpy() for k, v in tm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu").items()}
    toks, labels = _batch((4, 16))
    ts = [1, 2, 3] if t_kind == "int" else \
        [torch.tensor(t, dtype=torch.int32) for t in (1, 2, 3)]
    t0, d0 = tcs.trace_count(), tcs.dispatch_count()
    got = _steps(tcfg, weights, toks, labels, ts, optimizer=optimizer)
    assert (tcs.trace_count() - t0, tcs.dispatch_count() - d0) == (1, 3)
    compiled(False)
    want = _steps(tcfg, weights, toks, labels, ts, optimizer=optimizer)
    assert tcs.dispatch_count() - d0 == 3          # the eager body: none
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    # the losses are the step's own tensors, not one overwritten buffer
    assert len({x.data_ptr() for x in got[0]}) == 3


def test_captured_step_recaptures_on_a_new_shape_or_new_params():
    from mxnet_tpu_torch import cached_step as tcs
    from mxnet_tpu_torch import program_store as tps

    _, tcfg = _cfgs()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    m, v = tm.init_opt_state(p)
    step = tm.make_train_step(tcfg, lr=LR, device="cpu")
    t0 = tcs.trace_count()
    for shape, want in (((2, 16), 1), ((2, 16), 1), ((2, 8), 2),
                        ((2, 16), 2)):
        step(p, m, v, *_batch(shape), 1)
        assert tcs.trace_count() - t0 == want
    # new params: a new capture, and the programs over the old params
    # (one per shape) are dropped, freeing them
    e0 = tps.namespace("train_step").evictions
    old = weakref.ref(p["embed.weight"])
    p2 = {k: w.clone() for k, w in p.items()}
    step(p2, m, v, *_batch((2, 16)), 1)
    assert tcs.trace_count() - t0 == 3
    assert tps.namespace("train_step").evictions - e0 == 2
    del p
    gc.collect()
    assert old() is None


def test_device_lr_t_matches_jax_over_5_adam_steps():
    """Adam's lr_t taken on the device from the step scalar t, over 5
    steps, against the reference's jitted step at the file's bounds."""
    jcfg, tcfg = _cfgs()
    weights = _weights(jcfg, seed=2)
    toks, labels = _batch((4, 16), seed=2)
    j_losses, j_state = _jax_run(jcfg, weights, toks, labels, steps=5)
    t_losses, t_state = _port_run(tcfg, weights, toks, labels, steps=5)
    onp.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    _assert_state_close(t_state, j_state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_PROFILER_WARM = []


def traced_launches(fn, trace=True):
    """``fn()``, under a profiler if ``trace``: its result, the launches of
    the port's kernels that the wrappers counted, and those the trace saw
    run on the device (a replayed graph's among them), by wrapper (None
    untraced)."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    if trace and not _PROFILER_WARM:
        # the first trace of a process can miss its first kernels
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        _PROFILER_WARM.append(True)
    c0 = ck.launch_counts()
    if not trace:
        out, traced = fn(), None
    else:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a trace can miss the first kernels of work that starts as
            # soon as it does (chip_smoke.TRACE_SETTLE_S)
            time.sleep(0.05)
            out = fn()
            torch.cuda.synchronize()
        traced = {}
        for evt in prof.events():
            name = ck.kernel_of(evt.name) \
                if evt.device_type == torch.autograd.DeviceType.CUDA else None
            if name:
                traced[name] = traced.get(name, 0) + 1
    c1 = ck.launch_counts()
    return out, {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}, traced


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_captured_step_replays_like_the_eager_body_on_card(cuda_device,
                                                           optimizer,
                                                           compiled):
    """A 2-layer bf16 LM (flash kernels on): 4 steps replayed as a CUDA
    graph against the eager body, bitwise where two eager runs are
    bitwise equal, else within 3x their spread; the kernels that run on
    the device in each replay, counted in a profiler trace, are the eager
    body's. The wrappers count what they launch: every eager step's, the
    first captured call's eager run and capture (twice a step's), no
    replay."""
    from mxnet_tpu_torch import cached_step as tcs

    _, tcfg = _cfgs("bfloat16", num_heads=2, hidden=64, mlp_hidden=128,
                    use_flash_attention=None)
    init = tm.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks, labels = (torch.from_numpy(a).long().to(cuda_device)
                    for a in _batch((4, 64)))
    want = {k: tcfg.num_layers for k in ("flash_attention_fwd",
                                         "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv")}
    runs, launches = [], []
    for capture in (False, False, True):
        compiled(capture)
        p = {k: w.to(cuda_device) for k, w in init.items()}
        m, v = tm.init_opt_state(p)
        step = tm.make_train_step(tcfg, optimizer=optimizer, lr=LR,
                                  device=cuda_device)
        t0 = tcs.trace_count()
        losses = []
        for t in range(1, 5):
            # a run's first step is not traced: it captures, or launches
            # a kernel for the first time in the process, which a trace
            # can miss
            (p, m, v, loss), counted, traced = traced_launches(
                lambda: step(p, m, v, toks, labels, t), trace=t > 1)
            if t == 1:
                assert counted == {k: (2 if capture else 1) * n
                                   for k, n in want.items()}
            else:
                launches.append(traced)
                assert counted == ({} if capture else traced)
            losses.append(loss)
        assert tcs.trace_count() - t0 == (1 if capture else 0)
        torch.cuda.synchronize()
        runs.append(losses + [x for d in (p, m, v) for x in d.values()])
    assert launches == [want] * 9
    a, b, c = runs
    for u, v, w in zip(a, b, c):
        if torch.equal(u, v):
            assert torch.equal(w, u)
        else:
            assert (w.float() - u.float()).abs().max() <= \
                3 * (v.float() - u.float()).abs().max()
    assert len({x.data_ptr() for x in c[:4]}) == 4   # cloned losses


@pytest.mark.cuda
def test_captured_forward_returns_clones_on_card(cuda_device):
    """The LM forward through program_store.capture: each call's logits
    are its own, and equal the eager forward's bitwise."""
    from mxnet_tpu_torch import program_store as tps

    _, tcfg = _cfgs("bfloat16", num_heads=2, hidden=64, mlp_hidden=128,
                    use_flash_attention=None)
    p = tm.init_params(tcfg, torch.Generator(device=cuda_device)
                       .manual_seed(0), device=cuda_device)
    fwd = tps.capture(lambda toks: tm.forward(p, toks, tcfg)[0])
    a, b = (torch.from_numpy(x).long().to(cuda_device)
            for x in (_batch((2, 64), seed=1)[0], _batch((2, 64), seed=2)[0]))
    with torch.no_grad():
        want_a = tm.forward(p, a, tcfg)[0]
        want_b = tm.forward(p, b, tcfg)[0]
        first = fwd(a)
        again = fwd(a)
        second = fwd(b)
    torch.cuda.synchronize()
    assert torch.equal(first, want_a) and torch.equal(again, want_a)
    assert torch.equal(second, want_b)
    assert len(fwd.programs) == 1
