"""The port's mixture of experts on one device
(``mxnet_tpu_torch/parallel/moe.py``, the LM's ``num_experts`` path and the
aux fold in ``cached_step.TrainStep``) against the JAX package's on the
CPU:

- ``top_k_gating``: dispatch bitwise, combine within 1e-6 (the softmax's
  exp and division round in other orders), the aux loss within 1e-6,
  with and without capacity drops, and the count of surviving slots equal
  to the reference's (``test_moe_step.py:238-281``'s counterparts);
- ``moe_layer`` within 1e-5, dropped tokens exactly zero;
- ``MoEBlock``: the reference's parameter names; its forward within 1e-5;
  ``aux_scope`` nesting; ``MXNET_MOE_AUX_WEIGHT`` declared and validated,
  and reaching the optimizer through ``compile_step`` and through the
  eager tape, against the reference over 3 SGD-momentum steps
  (``test_moe_step.py:123-173``'s counterparts);
- the MoE LM: parameter names, shapes and init scales; the forward's
  logits, aux and loss within the dense LM tests' fp32 2e-4 and the bf16
  loss within 1e-2; ``make_train_step`` with Adam and LAMB at
  ``grad_accum`` 1 and 2 (and ``remat``) against the reference on a
  one-device mesh within the bounds of ``tests/test_torch_train_step.py``;
  the captured step bitwise its eager body; ring attention and a mesh
  still refused.

The ``cuda``-marked tests run the MoE LM step and ``MoEBlock`` on the card
and skip without one.
"""
import contextlib
import dataclasses
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.parallel import moe as tmoe

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jm = LazyModule("mxnet_tpu.models")
rmx = LazyModule("mxnet_tpu")
rmoe = LazyModule("mxnet_tpu.parallel.moe")
par = LazyModule("mxnet_tpu.parallel")

G, S, M, H, E = 4, 6, 8, 16, 4     # groups, tokens, model, hidden, experts
COMBINE_TOL = 1e-6   # gates are softmax probabilities <= 1
AUX_TOL = 1e-6
LAYER_TOL = 1e-5     # moe_layer / MoEBlock outputs, fp32
RTOL, ATOL = 2e-4, 2e-4          # test_torch_transformer_lm's fp32 bound
BF16_LOSS_ATOL = 1e-2            # its bf16 bound
LR = 1e-3
# the train-step bounds of tests/test_torch_train_step.py (fp32, 3 steps)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=LR / 100)
MOMENT_RTOL, MOMENT_ATOL_FRAC = 1e-4, 1e-5
# MoEBlock trained by SGD momentum: the reference pin's own bound
# (test_moe_step.py:170) on params after 3 steps
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return onp.asarray(x)


def _gating_inputs(seed, g, s, scale=0.3):
    rng = onp.random.RandomState(seed)
    x = rng.randn(g, s, M).astype(onp.float32)
    gw = (rng.randn(M, E) * scale).astype(onp.float32)
    return x, gw


# ---------------------------------------------------------------------------
# gating and the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,g,s,k,capacity", [
    (0, 2, 8, 2, 2), (1, 1, 8, 2, 1), (2, G, S, 2, None), (3, G, S, 1, None),
    (4, 2, 16, 3, None), (5, 3, 5, 2, 7)])
def test_top_k_gating_matches_reference(seed, g, s, k, capacity):
    x, gw = _gating_inputs(seed, g, s)
    d, c, a = tmoe.top_k_gating(torch.from_numpy(x), torch.from_numpy(gw),
                                num_experts=E, k=k, capacity=capacity)
    rd, rc, ra = rmoe.top_k_gating(jnp.asarray(x), jnp.asarray(gw),
                                   num_experts=E, k=k, capacity=capacity)
    assert d.dtype == torch.float32 and tuple(d.shape) == _np(rd).shape
    assert onp.array_equal(d.numpy(), _np(rd))
    assert onp.abs(c.numpy() - _np(rc)).max() <= COMBINE_TOL
    assert abs(float(a) - float(ra)) <= AUX_TOL
    # the surviving slots: the reference's exact count, and where the
    # capacity is below S * k / E some tokens must drop
    survivors = int(d.sum())
    assert survivors == int(_np(rd).sum())
    if capacity is not None and capacity * E < s * k:
        assert survivors < g * s * k
    # a repeat is bitwise (drops are a function of the gating state)
    d2, c2, a2 = tmoe.top_k_gating(torch.from_numpy(x), torch.from_numpy(gw),
                                   num_experts=E, k=k, capacity=capacity)
    assert torch.equal(d, d2) and torch.equal(c, c2) and torch.equal(a, a2)


def test_moe_layer_matches_reference_and_drops_to_zero():
    rng = onp.random.RandomState(1)
    x = rng.randn(1, 8, M).astype(onp.float32)
    gw = (rng.randn(M, E) * 0.3).astype(onp.float32)
    w_in = (rng.randn(E, M, H) * 0.2).astype(onp.float32)
    w_out = (rng.randn(E, H, M) * 0.2).astype(onp.float32)
    for capacity in (1, None):
        out, aux = tmoe.moe_layer(*map(torch.from_numpy,
                                       (x, gw, w_in, w_out)),
                                  k=2, capacity=capacity)
        rout, raux = rmoe.moe_layer(*map(jnp.asarray, (x, gw, w_in, w_out)),
                                    k=2, capacity=capacity)
        assert onp.abs(out.numpy() - _np(rout)).max() <= LAYER_TOL
        assert abs(float(aux) - float(raux)) <= AUX_TOL
    _d, c, _a = tmoe.top_k_gating(torch.from_numpy(x), torch.from_numpy(gw),
                                  num_experts=E, k=2, capacity=1)
    out, _aux = tmoe.moe_layer(*map(torch.from_numpy, (x, gw, w_in, w_out)),
                               k=2, capacity=1)
    dropped = c.sum(dim=(2, 3)) == 0
    assert dropped.any()
    assert not out[dropped].any()


def test_aux_scope_records_and_nests():
    assert tmoe.record_aux(1.0) is False          # no scope open: no-op
    with tmoe.aux_scope() as outer:
        assert tmoe.record_aux(2.0) is True
        with tmoe.aux_scope() as inner:
            tmoe.record_aux(3.0)
        assert inner == [3.0]
        tmoe.record_aux(4.0)
    assert outer == [2.0, 4.0]
    assert tmoe.record_aux(5.0) is False          # scope restored shut
    # the reference's scope behaves the same
    with rmoe.aux_scope() as router:
        rmoe.record_aux(2.0)
    assert router == [2.0] and rmoe.record_aux(1.0) is False


def test_moe_aux_weight_declared(monkeypatch):
    monkeypatch.delenv("MXNET_MOE_AUX_WEIGHT", raising=False)
    assert tconfig.get("MXNET_MOE_AUX_WEIGHT") == pytest.approx(0.01)
    monkeypatch.setenv("MXNET_MOE_AUX_WEIGHT", "-1")
    with pytest.raises(ValueError):
        tconfig.get("MXNET_MOE_AUX_WEIGHT")
    monkeypatch.setenv("MXNET_MOE_AUX_WEIGHT", "0.25")
    assert tconfig.get("MXNET_MOE_AUX_WEIGHT") == 0.25


# ---------------------------------------------------------------------------
# MoEBlock and the aux fold in TrainStep
# ---------------------------------------------------------------------------
_TARGET = onp.random.RandomState(99).randn(G, S, M).astype(onp.float32)


def _block_weights(seed=0):
    """The reference pin's weights: numpy draws in sorted name order."""
    rng = onp.random.RandomState(seed)
    shapes = {"expert.ffn_1.weight": (E, M, H),
              "expert.ffn_2.weight": (E, H, M), "gate.weight": (M, E)}
    return {n: (rng.randn(*shapes[n]) * 0.2).astype(onp.float32)
            for n in sorted(shapes)}


def _port_block(seed=0):
    net = tmoe.MoEBlock(units=M, hidden=H, num_experts=E, k=2)
    net.initialize(ctx=tmx.cpu())
    for name, w in _block_weights(seed).items():
        net.collect_params()[name].set_data(torch.from_numpy(w))
    return net


def _ref_block(seed=0):
    net = rmoe.MoEBlock(units=M, hidden=H, num_experts=E, k=2)
    net.initialize(ctx=rmx.cpu())
    for name, w in _block_weights(seed).items():
        net.collect_params()[name].data()._set_data(
            rmx.nd.array(w)._data)
    return net


def _xs(steps=3):
    rng = onp.random.RandomState(7)
    return [rng.randn(G, S, M).astype(onp.float32) for _ in range(steps)]


@contextlib.contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port_run(aux_weight, compiled=True, steps=3):
    net = _port_block()
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.01, "momentum": 0.9})

    def loss_fn(n, x):
        y = n(x)
        return ((y - tmx.nd.array(_TARGET, ctx=x.ctx)) ** 2).sum()

    with _env(MXNET_MOE_AUX_WEIGHT=aux_weight,
              MXNET_COMPILED_STEP=int(compiled)):
        tconfig.refresh()
        try:
            step = trainer.compile_step(net, loss_fn)
            losses = []
            for x in _xs(steps):
                loss = step(tmx.nd.array(x, ctx=tmx.cpu()), batch_size=G)
                assert step.last_step_compiled is compiled
                losses.append(float(loss.asnumpy().ravel()[0]))
        finally:
            tconfig.refresh()
    return {k: p.data().numpy().copy()
            for k, p in net.collect_params().items()}, losses


def _ref_run(aux_weight, steps=3):
    from mxnet_tpu import gluon as rgluon

    net = _ref_block()
    with _env(MXNET_MOE_AUX_WEIGHT=aux_weight, MXNET_SPMD_MESH="1",
              MXNET_FSDP_MIN_SIZE="1"):
        trainer = rgluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.01, "momentum": 0.9},
                                 kvstore="tpu")

        def loss_fn(n, x):
            y = n(x)
            return ((y - rmx.nd.array(_TARGET, ctx=x.ctx)) ** 2).sum()

        step = trainer.compile_step(net, loss_fn)
        losses = []
        for x in _xs(steps):
            loss = step(rmx.nd.array(x), batch_size=G)
            losses.append(float(loss.asnumpy().ravel()[0]))
        rmx.engine.waitall()
    return {k: p.data().asnumpy() for k, p in
            net.collect_params().items()}, losses


def test_moe_block_names_and_forward_match_reference():
    net, ref = _port_block(), _ref_block()
    assert list(net.collect_params()) == list(ref.collect_params()) == [
        "gate.weight", "expert.ffn_1.weight", "expert.ffn_2.weight"]
    x = _xs(1)[0]
    with tmoe.aux_scope() as auxes:
        out = net(torch.from_numpy(x))
    with rmoe.aux_scope() as rauxes:
        rout = ref(rmx.nd.array(x))
    assert onp.abs(out.numpy() - rout.asnumpy()).max() <= LAYER_TOL
    assert len(auxes) == len(rauxes) == 1
    assert abs(float(auxes[0]) - float(_np(rauxes[0]))) <= AUX_TOL
    # fed an NDArray, the block answers with one
    nd_out = net(tmx.nd.array(x, ctx=tmx.cpu()))
    assert torch.equal(nd_out._data, out)


@pytest.mark.parametrize("aux_weight", [0.0, 0.5])
def test_aux_reaches_optimizer_through_compiled_step(aux_weight):
    """3 compiled SGD-momentum steps against the reference's: losses and
    every parameter within the reference pin's bound, for the weight 0
    and 0.5; the gate and the experts move with the weight (the balance
    penalty flows through the program's heads into the update)."""
    port, losses = _port_run(aux_weight)
    ref, rlosses = _ref_run(aux_weight)
    onp.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    for k in ref:
        onp.testing.assert_allclose(port[k], ref[k], err_msg=k, **BLOCK_TOL)
    if aux_weight:
        other, _ = _port_run(0.0)
        assert not onp.array_equal(port["gate.weight"], other["gate.weight"])
        assert not onp.array_equal(port["expert.ffn_1.weight"],
                                   other["expert.ffn_1.weight"])


def test_eager_tape_matches_compiled_with_aux():
    """MXNET_COMPILED_STEP=0 runs the eager tape, which folds the same aux
    head: the two paths track each other (the reference pin's bound) and
    the reference's eager tape."""
    pc, lc = _port_run(0.25, compiled=True)
    pe, le = _port_run(0.25, compiled=False)
    ref, rl = _ref_run(0.25)
    onp.testing.assert_allclose(lc, le, rtol=1e-6)
    for k in pc:
        onp.testing.assert_allclose(pc[k], pe[k], err_msg=k, **BLOCK_TOL)
        onp.testing.assert_allclose(pe[k], ref[k], err_msg=k, **BLOCK_TOL)


def test_compile_step_takes_ndarray_arguments():
    """The fault this slice fixed: a compiled step fed NDArrays (as the
    reference's tests feed it) raised TypeError (an NDArray in the program
    key); it now runs on their tensors, hands loss_fn NDArrays, and answers
    with an NDArray, equal to a tensor-fed step's loss."""
    net = _port_block()
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.01})

    def loss_fn(n, x):
        assert isinstance(x, tmx.nd.NDArray)
        return (n(x) ** 2).sum()

    step = trainer.compile_step(net, loss_fn)
    x = _xs(1)[0]
    loss = step(tmx.nd.array(x, ctx=tmx.cpu()), batch_size=G)
    assert isinstance(loss, tmx.nd.NDArray) and step.last_step_compiled
    net2 = _port_block()
    trainer2 = tgluon.Trainer(net2.collect_params(), "sgd",
                              {"learning_rate": 0.01})
    step2 = trainer2.compile_step(net2, lambda n, x: (n(x) ** 2).sum())
    loss2 = step2(torch.from_numpy(x), batch_size=G)
    assert torch.equal(loss._data, loss2)


# ---------------------------------------------------------------------------
# the MoE LM
# ---------------------------------------------------------------------------
def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=128, num_layers=2, num_heads=2, hidden=32,
                mlp_hidden=64, max_len=64, num_experts=E, moe_top_k=2,
                capacity_factor=1.25)
    base.update(kw)
    return (jm.TransformerLMConfig(dtype=getattr(jnp, dtype),
                                   use_flash_attention=False, **base),
            tm.TransformerLMConfig(dtype=_TORCH_DTYPE[dtype],
                                   use_flash_attention=False, **base))


def _weights(jcfg, seed=0):
    return {k: onp.asarray(v)
            for k, v in jm.init_params(jax.random.PRNGKey(seed), jcfg).items()}


def _batch(shape, vocab=128, seed=0):
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, vocab, shape).astype(onp.int32)
    labels = onp.where(rng.rand(*shape) < 0.3, toks, -1).astype(onp.int32)
    return toks, labels


def test_moe_param_names_shapes_and_init_scales():
    jcfg, tcfg = _cfgs()
    want = {k: (v.shape, str(v.dtype)) for k, v in _weights(jcfg).items()}
    got = {k: (shape, str(dt).replace("torch.", ""))
           for k, (shape, dt) in tm.param_shapes(tcfg).items()}
    assert got == want
    assert "layer0.moe.gate.weight" in got and \
        "layer0.ffn_1.weight" not in got
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    resid = 0.02 / (2 * tcfg.num_layers) ** 0.5
    for name, scale in (("layer0.moe.gate.weight", 0.02),
                        ("layer1.expert.ffn_1.weight", 0.02),
                        ("layer1.expert.ffn_2.weight", resid)):
        w = p[name]
        assert w.abs().max().item() <= 2 * scale + 1e-7, name
        assert abs(w.std().item() - scale * 0.88) < 0.25 * scale, name


@pytest.mark.parametrize("layers,seq", [(1, 16), (2, 16), (2, 48)])
def test_moe_forward_and_loss_match_reference_fp32(layers, seq):
    jcfg, tcfg = _cfgs(num_layers=layers)
    w = _weights(jcfg, seed=layers)
    tp = params_from_numpy(w, tcfg, device="cpu")
    toks, labels = _batch((2, seq))
    j_logits, j_aux = jm.forward({k: jnp.asarray(v) for k, v in w.items()},
                                 jnp.asarray(toks), jcfg)
    t_logits, t_aux = tm.forward(tp, toks, tcfg, device="cpu")
    onp.testing.assert_allclose(t_logits.numpy(), _np(j_logits), rtol=RTOL,
                                atol=ATOL)
    assert t_aux.dtype == torch.float32 and float(t_aux) > 0
    onp.testing.assert_allclose(float(t_aux), float(j_aux), rtol=RTOL,
                                atol=ATOL)
    j_loss = jm.loss_fn({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(toks), jnp.asarray(labels), jcfg,
                        aux_weight=0.5)
    t_loss = tm.loss_fn(tp, toks, labels, tcfg, aux_weight=0.5,
                        device="cpu")
    onp.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL,
                                atol=ATOL)


def test_moe_loss_matches_reference_bf16():
    jcfg, tcfg = _cfgs("bfloat16")
    w = _weights(jcfg)
    tp = params_from_numpy(w, tcfg, device="cpu")
    assert tp["layer0.expert.ffn_1.weight"].dtype == torch.bfloat16
    toks, labels = _batch((2, 16))
    j_loss = jm.loss_fn({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(toks), jnp.asarray(labels), jcfg)
    t_loss = tm.loss_fn(tp, toks, labels, tcfg, device="cpu")
    assert abs(float(t_loss) - float(j_loss)) <= BF16_LOSS_ATOL


def _jax_steps(jcfg, weights, toks, labels, steps=3, **kw):
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
    return losses, [{k: _np(x).astype(onp.float32) for k, x in d.items()}
                    for d in (p, m, v)]


def _port_steps(tcfg, weights, toks, labels, steps=3, **kw):
    p = params_from_numpy(weights, tcfg, device="cpu")
    m, v = tm.init_opt_state(p)
    step = tm.make_train_step(tcfg, lr=LR, device="cpu", **kw)
    losses = []
    for t in range(1, steps + 1):
        p, m, v, loss = step(p, m, v, toks, labels, t)
        losses.append(float(loss))
    return losses, [{k: x.float().numpy() for k, x in d.items()}
                    for d in (p, m, v)]


@pytest.mark.parametrize("optimizer,grad_accum,remat", [
    ("adam", 1, False), ("adam", 2, False), ("lamb", 1, False),
    ("lamb", 2, False), ("adam", 2, True)])
def test_moe_train_step_matches_reference_fp32(optimizer, grad_accum,
                                               remat):
    """3 steps with an aux weight of 0.5 (so the balance loss moves the
    gates visibly): losses, params and moments against the reference;
    under grad_accum=2 both take the aux per micro-batch divided by 2."""
    jcfg, tcfg = _cfgs(remat=remat)
    weights = _weights(jcfg, seed=3)
    toks, labels = _batch((4, 16), seed=3)
    kw = dict(optimizer=optimizer, grad_accum=grad_accum, aux_weight=0.5)
    j_losses, j_state = _jax_steps(jcfg, weights, toks, labels, **kw)
    t_losses, t_state = _port_steps(tcfg, weights, toks, labels, **kw)
    onp.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    for what, t_d, j_d in zip(("params", "m", "v"), t_state, j_state):
        assert set(t_d) == set(j_d)
        for k, j in j_d.items():
            tol = PARAM_TOL if what == "params" else dict(
                rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL_FRAC * float(abs(j).max()))
            onp.testing.assert_allclose(t_d[k], j, err_msg=f"{what} {k}",
                                        **tol)


def test_moe_grad_accum_aux_is_per_micro_batch():
    """The reference's documented semantics (transformer_lm.py:455-461),
    kept: under grad_accum=2 the loss is the sum of the micro objectives,
    each with the aux of its own half divided by 2. (The gating groups are
    the batch rows and the aux is their mean, so here the sum equals the
    full batch's aux up to rounding.)"""
    _jcfg, tcfg = _cfgs()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    for i in range(tcfg.num_layers):
        # sharp gates, so that the routing and its balance loss depend on
        # the batch's make-up
        p[f"layer{i}.moe.gate.weight"] *= 200
    toks, labels = _batch((4, 16), seed=1)
    tt, tl = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    valid = max(int((tl >= 0).sum()), 1)
    want = 0.0
    for half in (slice(0, 2), slice(2, 4)):
        logits, aux = tm.forward(p, tt[half], tcfg, device="cpu")
        nll, _ = tm.transformer_lm._masked_nll(logits, tl[half])
        want += float(nll.sum()) / valid + 0.5 * float(aux) / 2
    m, v = tm.init_opt_state(p)
    step = tm.make_train_step(tcfg, grad_accum=2, aux_weight=0.5, lr=0.0,
                              wd=0.0, device="cpu")
    _p, _m, _v, loss = step(p, m, v, toks, labels, 1)
    assert abs(float(loss) - want) <= 1e-5
    full = float(tm.loss_fn(p, toks, labels, tcfg, aux_weight=0.5,
                            device="cpu"))
    assert abs(full - want) <= 1e-5


def test_moe_captured_step_equals_eager_body_bitwise(monkeypatch):
    _jcfg, tcfg = _cfgs()
    toks, labels = _batch((4, 16), seed=2)
    runs = []
    for compiled in ("1", "0"):
        monkeypatch.setenv("MXNET_COMPILED_STEP", compiled)
        tconfig.refresh()
        p = tm.init_params(tcfg, torch.Generator().manual_seed(2),
                           device="cpu")
        m, v = tm.init_opt_state(p)
        step = tm.make_train_step(tcfg, grad_accum=2, device="cpu")
        losses = [step(p, m, v, toks, labels, t)[3] for t in (1, 2)]
        runs.append((losses, p, m, v))
    tconfig.refresh()
    (la, pa, ma, va), (lb, pb, mb, vb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for da, db in ((pa, pb), (ma, mb), (va, vb)):
        assert all(torch.equal(da[k], db[k]) for k in da)


def test_moe_with_ring_attention_or_mesh_still_refuses():
    # ring attention and meshes are ported (tests/test_torch_lm_mesh.py):
    # without an 'sp' axis the ring flag leaves the MoE forward as it is,
    # bit for bit, and something other than a mesh still refuses
    _jcfg, tcfg = _cfgs()
    p = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks, _labels = _batch((1, 8))
    ring = tm.forward(p, toks, dataclasses.replace(tcfg,
                                                   use_ring_attention=True),
                      device="cpu")
    dense = tm.forward(p, toks, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ring, dense))
    with pytest.raises(TypeError, match="mesh"):
        tm.make_train_step(tcfg, mesh=object(), device="cpu")


def test_moe_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jcfg, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.make_train_step(tcfg)
    net = tmoe.MoEBlock(units=M, hidden=H, num_experts=E)
    with pytest.raises(RuntimeError, match="CUDA"):
        net.initialize()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_gating_on_card_matches_cpu(cuda_device):
    """Dispatch bitwise and combine within 1e-6 of the CPU's, fp32 (TF32
    off), with capacity drops."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, gw = _gating_inputs(0, 2, 8)
        d, c, a = tmoe.top_k_gating(torch.from_numpy(x),
                                    torch.from_numpy(gw), num_experts=E,
                                    k=2, capacity=2)
        dc, cc, ac = tmoe.top_k_gating(torch.from_numpy(x).cuda(),
                                       torch.from_numpy(gw).cuda(),
                                       num_experts=E, k=2, capacity=2)
        assert torch.equal(dc.cpu(), d)
        assert (cc.cpu() - c).abs().max() <= COMBINE_TOL
        assert abs(float(ac) - float(a)) <= AUX_TOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_moe_lm_step_on_card_captured_equals_eager(cuda_device,
                                                   monkeypatch):
    """The MoE LM step on the card, bf16 with the flash kernels: the
    captured step bitwise its eager body over 3 steps, finite losses."""
    tcfg = tm.TransformerLMConfig(
        vocab_size=128, num_layers=2, num_heads=2, hidden=64, mlp_hidden=128,
        max_len=64, num_experts=E)
    toks, labels = _batch((4, 32), seed=4)
    runs = []
    for compiled in ("1", "0"):
        monkeypatch.setenv("MXNET_COMPILED_STEP", compiled)
        tconfig.refresh()
        p = tm.init_params(tcfg, torch.Generator(device="cuda")
                           .manual_seed(4), device="cuda")
        m, v = tm.init_opt_state(p)
        step = tm.make_train_step(tcfg, device="cuda")
        losses = [step(p, m, v, torch.from_numpy(toks).cuda(),
                       torch.from_numpy(labels).cuda(), t)[3].clone()
                  for t in (1, 2, 3)]
        runs.append((losses, p))
    tconfig.refresh()
    (la, pa), (lb, pb) = runs
    assert all(torch.isfinite(x) for x in la)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
