"""The port's train step (mxnet_tpu_torch.models.make_train_step) held
against the JAX package's (mxnet_tpu.models.make_train_step on a one-device
mesh) on the CPU: the same numpy weights, carried across with
``convert.params_from_numpy``, and the same batches go through both, and the
losses, params and Adam/LAMB moments are compared.

The JAX step donates its inputs, so every JAX run starts from fresh arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import models as jm
from mxnet_tpu import parallel as par
from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.models import transformer_lm as ttl

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
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


def _cfgs(dtype=jnp.float32, **kw):
    base = dict(vocab_size=128, num_layers=2, num_heads=2, hidden=32,
                mlp_hidden=64, max_len=64)
    base.update(kw)
    flash = base.pop("use_flash_attention", False)
    return (jm.TransformerLMConfig(dtype=dtype, use_flash_attention=flash,
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
    jcfg, tcfg = _cfgs(jnp.bfloat16)
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
    _, tcfg = _cfgs(jnp.bfloat16)
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
    jcfg, tcfg = _cfgs(jnp.bfloat16)
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
        with pytest.raises(NotImplementedError, match="mesh"):
            tm.make_train_step(tcfg, mesh=object(), device="cpu")
    elif case == "moe":
        with pytest.raises(NotImplementedError, match="mixture-of-experts"):
            tm.make_train_step(dataclasses.replace(tcfg, num_experts=4),
                               device="cpu")
    else:
        with pytest.raises(ValueError, match="optimizer"):
            tm.make_train_step(tcfg, optimizer="sgd", device="cpu")
