"""The port's compiled whole train step (mxnet_tpu_torch.cached_step through
``Trainer.compile_step``), its hybridized forward and the program store
behind both, on the CPU, where a program runs its body through its static
buffers with no graph:

- 3 SGD-momentum steps of a narrow bottleneck ResNet v1 against the JAX
  package's ``Trainer.compile_step`` on the same numpy weights and batch
  (the reference's outputs computed here: its own bit-exact pins are red),
  and against the port's own eager tape, bitwise, on each route;
- the reference's counters (``trace_count``, ``dispatch_count``,
  ``cache_stats``), eviction past the cap, a new learning rate without a
  new capture, and what re-captures (``cast``) or does not (``set_data``);
- the setups that run the eager tape and name their reason, and the
  window that refuses it;
- the hybridized predict-mode forward against the reference's and against
  the port's eager forward, bitwise, with cloned outputs.

The ``cuda``-marked tests replay the same steps and forwards as CUDA graphs
on the card and skip without one.
"""
import gc
import weakref

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

from test_torch_gluon_resnet import (CHANNELS, CLASSES, LAYERS, OUT_TOL,
                                     SITES, STEP_TOL, _narrow_pair,
                                     _numpy_params)
from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jmx = LazyModule("mxnet_tpu")
jag = LazyModule("mxnet_tpu.autograd")
jconfig = LazyModule("mxnet_tpu.config")
jgluon = LazyModule("mxnet_tpu.gluon")

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
ROUTES = {"unfused": {}, "epilogue": {"MXNET_FUSED_EPILOGUE": "2"},
          "conv_bn": {"MXNET_FUSED_CONV_BN": "2"}}


@pytest.fixture
def knobs(monkeypatch):
    """Set the port's knobs for one test, refreshing its config cache on
    the way in and out."""
    names = []

    def set_(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
            names.append(k)
            tconfig.refresh(k)

    yield set_
    for k in names:
        monkeypatch.delenv(k, raising=False)
        tconfig.refresh(k)


def _batch(n=2, seed=0, hw=16):
    rng = onp.random.RandomState(seed)
    x = rng.randn(n, hw, hw, 3).astype(onp.float32)
    y = rng.randint(0, CLASSES, n).astype(onp.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _net(seed=0):
    """The narrow bottleneck ResNet v1 on the CPU, Xavier from a seeded
    generator, probed once (deferred shapes) and hybridized."""
    net = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                           classes=CLASSES, layout="NHWC", input_layout="NHWC")
    net.initialize(tmx.initializer.Xavier(
        generator=torch.Generator().manual_seed(seed)), ctx=tmx.cpu())
    with torch.no_grad():
        net(_batch()[0])
    net.hybridize()
    return net


def _twin(net):
    """A second net with ``net``'s values."""
    twin = _net()
    twin.load_dict({k: p.data().clone()
                    for k, p in net.collect_params().items()})
    return twin


_ce = tgluon.loss.SoftmaxCrossEntropyLoss()


def _loss(net, x, y):
    return _ce(net(x), y)


def _eager_step(net, trainer, x, y):
    with tag.record():
        loss = _loss(net, x, y)
    tag.backward(loss)
    trainer.step(x.shape[0])
    return loss


def _state(net, trainer):
    return ([p.data().clone() for p in net.collect_params().values()]
            + [s.clone() for s in trainer._init_states()])


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i


# ---------------------------------------------------------------------------
# the compiled step against the reference and against the eager tape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["unfused", "epilogue"])
def test_compile_step_matches_jax_compile_step(route, knobs):
    knobs(**ROUTES[route])
    for k, v in ROUTES[route].items():
        jconfig.refresh(k)
    try:
        x, y = _batch()
        jnet, tnet = _narrow_pair(x.numpy())
        jnet.hybridize()
        tnet.hybridize()
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
        jce = jgluon.loss.SoftmaxCrossEntropyLoss()
        jstep = jtr.compile_step(jnet, lambda n, a, b: jce(n(a), b))
        tstep = ttr.compile_step(tnet, _loss)
        jx, jy = jmx.nd.array(x.numpy()), jmx.nd.array(y.numpy())
        tresnet.reset_fused_epilogue_counts()
        for i in range(3):
            jl = jstep(jx, jy, batch_size=2)
            tl = tstep(x, y, batch_size=2)
            assert jstep.last_fallback_reason is None
            assert tstep.last_fallback_reason is None
            onp.testing.assert_allclose(tl.numpy(), jl.asnumpy(),
                                        err_msg=f"loss, step {i}",
                                        **STEP_TOL)
        assert tresnet.fused_epilogue_counts() == {
            "fused": 3 * SITES if route == "epilogue" else 0, "refused": 0}
        jparams, tparams = jnet.collect_params(), tnet.collect_params()
        for name, tp in tparams.items():
            onp.testing.assert_allclose(tp.data().numpy(),
                                        jparams[name].data().asnumpy(),
                                        err_msg=name, **STEP_TOL)
        jstates = jtr._updaters[0].states
        for i, tp in enumerate(ttr._params):
            name = next(k for k, v in tparams.items() if v is tp)
            jm = jstates[jtr._param2idx[id(jparams[name])]]
            onp.testing.assert_allclose(ttr._states[i].numpy(),
                                        jm.asnumpy(),
                                        err_msg=f"momentum {name}",
                                        **STEP_TOL)
    finally:
        for k in ROUTES[route]:
            jconfig.refresh(k)


@pytest.mark.parametrize("route", list(ROUTES))
def test_compile_step_equals_eager_tape_bitwise(route, knobs):
    knobs(**ROUTES[route])
    x, y = _batch()
    net = _net()
    twin = _twin(net)
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    ttr = tgluon.Trainer(twin.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss)
    for i in range(3):
        sites0 = (tresnet.fused_epilogue_counts(),
                  tresnet.fused_conv_bn_counts())
        got = step(x, y)
        sites1 = (tresnet.fused_epilogue_counts(),
                  tresnet.fused_conv_bn_counts())
        want = _eager_step(twin, ttr, x, y)
        sites2 = (tresnet.fused_epilogue_counts(),
                  tresnet.fused_conv_bn_counts())
        assert step.last_fallback_reason is None
        assert torch.equal(got, want.detach()), i
        # the same fused and refused sites a step
        for a, b, c in zip(sites0, sites1, sites2):
            assert {k: b[k] - a[k] for k in a} == \
                {k: c[k] - b[k] for k in a}
    if route != "unfused":
        assert any(v for v in (tresnet.fused_epilogue_counts()["fused"],
                               tresnet.fused_conv_bn_counts()["1x1"]))
    _assert_bitwise(_state(net, tr), _state(twin, ttr))


def test_counters_new_batch_size_and_cache_hits():
    x, y = _batch(4)
    net = _net()
    step = tgluon.Trainer(net.collect_params(), "sgd",
                          dict(OPT)).compile_step(net, _loss)
    t0, d0 = tcs.trace_count(), tcs.dispatch_count()
    for _ in range(3):
        step(x, y)
    assert tcs.trace_count() - t0 == 1
    assert tcs.dispatch_count() - d0 == 3
    h0 = tcs.cache_stats()
    step(x[:2], y[:2])                         # a new batch size
    assert tcs.trace_count() - t0 == 2
    assert tcs.cache_stats()["misses"] == h0["misses"] + 1
    step(x, y)                                 # the first shape: a hit
    assert tcs.trace_count() - t0 == 2
    assert tcs.cache_stats()["hits"] == h0["hits"] + 1
    assert tcs.dispatch_count() - d0 == 5
    assert tps.stats("train_step")["traces"] == tcs.trace_count()


def test_eviction_past_the_cap(knobs):
    knobs(MXNET_COMPILED_STEP_CACHE="2")
    x, y = _batch(4)
    net = _net()
    step = tgluon.Trainer(net.collect_params(), "sgd",
                          dict(OPT)).compile_step(net, _loss)
    e0, t0 = tcs.cache_stats()["evictions"], tcs.trace_count()
    for n in (4, 3, 2):
        step(x[:n], y[:n])
    assert tcs.cache_stats()["evictions"] - e0 == 1
    assert len(step._programs) == 2
    assert tps.namespace("train_step").cap() == 2
    step(x[:4], y[:4])                          # evicted: captured again
    assert tcs.trace_count() - t0 == 4
    assert tcs.cache_stats()["evictions"] - e0 == 2


def test_set_learning_rate_takes_effect_without_a_new_capture():
    x, y = _batch()
    net = _net()
    twin = _twin(net)
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    ttr = tgluon.Trainer(twin.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss)
    for _ in range(2):
        step(x, y)
        _eager_step(twin, ttr, x, y)
    t0 = tcs.trace_count()
    tr.set_learning_rate(0.01)
    ttr.set_learning_rate(0.01)
    assert tr.learning_rate == 0.01
    got = step(x, y)
    want = _eager_step(twin, ttr, x, y)
    assert tcs.trace_count() == t0
    assert torch.equal(got, want.detach())
    _assert_bitwise(_state(net, tr), _state(twin, ttr))


def test_cast_recaptures_and_set_data_is_read_in_place():
    x, y = _batch()
    net = _net()
    twin = _twin(net)
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    ttr = tgluon.Trainer(twin.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss)
    step(x, y)
    _eager_step(twin, ttr, x, y)
    # set_data writes the parameter's tensor in place: the same program
    # reads the new value, no new capture
    t0 = tcs.trace_count()
    new = torch.full_like(net.collect_params()["output.bias"].data(), 0.5)
    for n in (net, twin):
        n.collect_params()["output.bias"].set_data(new)
    assert torch.equal(step(x, y), _eager_step(twin, ttr, x, y).detach())
    assert tcs.trace_count() == t0
    # cast replaces every parameter's tensor: a new key, a new capture
    for n in (net, twin):
        n.cast("float64")
    x64 = x.double()
    got = step(x64, y)
    assert tcs.trace_count() == t0 + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, _eager_step(twin, ttr, x64, y).detach())
    _assert_bitwise(_state(net, tr), _state(twin, ttr))


@pytest.mark.parametrize("route", ["epilogue", "conv_bn"])
def test_hybridize_false_recaptures_the_step_unfused(route, knobs):
    """A compiled step's body is the port's trace, so its fused sites do
    not depend on whether the net is hybridized, as the reference's
    compiled step fuses wherever it traces: ``hybridize(False)`` neither
    captures the step anew nor unfuses it. The eager tape of the net that
    is not hybridized runs unfused; that of a hybridized twin fuses, and
    the step stays bitwise equal to it."""
    knobs(**ROUTES[route])
    x, y = _batch()
    net = _net()
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss)
    step(x, y)
    twin = _twin(net)
    ttr = tgluon.Trainer(twin.collect_params(), "sgd", dict(OPT))
    for s, t in zip(ttr._init_states(), tr._init_states()):
        s.copy_(t)

    def sites():
        return {**tresnet.fused_epilogue_counts(),
                **{f"cbn.{k}": v
                   for k, v in tresnet.fused_conv_bn_counts().items()}}

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    net.hybridize(False)
    t0, s0 = tcs.trace_count(), sites()
    got = step(x, y)
    s1 = sites()
    want = _eager_step(twin, ttr, x, y)            # hybridized: fused
    s2 = sites()
    assert tcs.trace_count() == t0                 # the same program
    assert any(delta(s0, s1).values())             # fused
    assert delta(s0, s1) == delta(s1, s2)
    assert torch.equal(got, want.detach())
    _assert_bitwise(_state(net, tr), _state(twin, ttr))
    with tag.record():                             # not hybridized: eager,
        _loss(net, x, y)                           # never fused
    assert sites() == s2


@pytest.mark.parametrize("what", ["compile_step", "hybridized forward"])
def test_cast_drops_the_programs_over_the_old_tensors(what):
    """After cast, the programs captured over the old parameter tensors can
    never hit again: the next call drops them, and the old tensors are
    freed."""
    x, y = _batch()
    net = _net()
    old = [weakref.ref(p.data()) for p in net.collect_params().values()]
    if what == "compile_step":
        tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
        step = tr.compile_step(net, _loss)
        call = (lambda a: step(a, y[:a.shape[0]]))
        programs = (lambda: step._programs)
    else:
        call, programs = net, (lambda: net._programs)
    call(x)
    call(x[:1])
    assert len(programs()) == 2
    ns = programs().namespace
    e0 = ns.evictions
    net.cast("float64")
    call(x.double())
    assert len(programs()) == 1 and ns.evictions - e0 == 2
    gc.collect()
    assert all(r() is None for r in old)


def test_compiled_step_leaves_grad_alone():
    x, y = _batch()
    net = _net()
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    _eager_step(net, tr, x, y)
    before = {k: p._data.grad.clone() for k, p in
              net.collect_params().items() if p.grad_req != "null"}
    step = tr.compile_step(net, _loss)
    for _ in range(2):
        step(x, y)
    for k, p in net.collect_params().items():
        if p.grad_req != "null":
            assert torch.equal(p._data.grad, before[k]), k
            assert p._data.requires_grad and p._data.is_leaf


# ---------------------------------------------------------------------------
# fallbacks and refusals
# ---------------------------------------------------------------------------


def test_compiled_step_knob_off_runs_the_eager_tape(knobs):
    knobs(MXNET_COMPILED_STEP="0")
    x, y = _batch()
    net = _net()
    twin = _twin(net)
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    ttr = tgluon.Trainer(twin.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss)
    d0 = tcs.dispatch_count()
    for _ in range(2):
        got = step(x, y)
        want = _eager_step(twin, ttr, x, y)
        assert torch.equal(got.detach(), want.detach())
    assert step.last_fallback_reason == "MXNET_COMPILED_STEP=0"
    assert not step.last_step_compiled
    assert tcs.dispatch_count() == d0
    _assert_bitwise(_state(net, tr), _state(twin, ttr))


def test_grad_req_add_runs_the_eager_tape():
    x, y = _batch()
    net = _net()
    net.collect_params()["output.weight"].grad_req = "add"
    step = tgluon.Trainer(net.collect_params(), "sgd",
                          dict(OPT)).compile_step(net, _loss)
    d0 = tcs.dispatch_count()
    step(x, y)
    assert "grad_req='add'" in step.last_fallback_reason
    assert step.fallback_reason is None          # re-checked every call
    assert tcs.dispatch_count() == d0
    # "add" sums each backward's gradient into .grad
    w = net.collect_params()["output.weight"]
    g1 = w.grad().clone()
    step(x, y)
    assert not torch.equal(w.grad(), g1)
    net.collect_params()["output.weight"].grad_req = "write"
    step(x, y)
    assert step.last_fallback_reason is None


def test_deferred_init_runs_the_first_call_eagerly():
    x, y = _batch()
    net = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                           classes=CLASSES, layout="NHWC", input_layout="NHWC")
    net.initialize(tmx.initializer.Xavier(
        generator=torch.Generator().manual_seed(0)), ctx=tmx.cpu())
    net.hybridize()
    step = tgluon.Trainer(net.collect_params(), "sgd",
                          dict(OPT)).compile_step(net, _loss)
    step(x, y)
    assert step.last_fallback_reason.startswith("deferred parameter init")
    step(x, y)
    assert step.last_fallback_reason is None


@pytest.mark.parametrize("kw", [dict(bucket=True), dict(accum_steps=2)])
def test_unported_options_raise(kw, knobs):
    """``bucket=True`` and ``accum_steps`` are ported: the compiled step
    runs with either. What still raises is an accumulation window on the
    eager tape (``MXNetError``, the reference's refusal) and
    ``accum_steps=0``; bucketing takes the eager tape like any step."""
    x, y = _batch(3)
    net = _net()
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    step = tr.compile_step(net, _loss, **kw)
    step(x, y)
    assert step.last_step_compiled
    knobs(MXNET_COMPILED_STEP="0")
    if "accum_steps" in kw:
        with pytest.raises(tmx.MXNetError, match="accum_steps"):
            step(x, y)
        with pytest.raises(ValueError, match="accum_steps"):
            tr.compile_step(net, _loss, accum_steps=0)
    else:
        step(x, y)
        assert step.last_fallback_reason == "MXNET_COMPILED_STEP=0"


# ---------------------------------------------------------------------------
# the hybridized forward
# ---------------------------------------------------------------------------


def test_hybridized_predict_forward_matches_jax_and_eager():
    x, _ = _batch(3, seed=1)
    jnet, tnet = _narrow_pair(x.numpy())
    # non-trivial running statistics, as a trained net has
    rng = onp.random.RandomState(2)
    for k, p in jnet.collect_params().items():
        if "running" in k:
            v = rng.rand(*p.shape).astype(onp.float32) + 0.5
            p.set_data(jmx.nd.array(v if "var" in k else v - 1.0))
    gluon_params_from_numpy(tnet, _numpy_params(jnet))
    eager = tnet(x)                              # not hybridized yet
    jnet.hybridize()
    tnet.hybridize()
    t0 = tps.namespace("hybrid_forward").traces
    got = tnet(x)
    assert tps.namespace("hybrid_forward").traces == t0 + 1
    assert torch.equal(got, eager)
    onp.testing.assert_allclose(got.numpy(),
                                jnet(jmx.nd.array(x.numpy())).asnumpy(),
                                **OUT_TOL)


def test_hybridized_forward_keys_and_clones():
    x, _ = _batch(2, seed=3)
    x2, _ = _batch(2, seed=4)
    net = _net()
    ns = tps.namespace("hybrid_forward")
    t0, d0 = ns.traces, ns.dispatches
    first = net(x)
    first_copy = first.clone()
    second = net(x2)                             # the same program
    assert (ns.traces - t0, ns.dispatches - d0) == (1, 2)
    assert torch.equal(first, first_copy)        # a clone, not overwritten
    assert not torch.equal(first, second)
    net(x[:1])                                   # a new shape
    assert ns.traces - t0 == 2
    # training mode outside record: its own program, which updates the
    # running statistics in place as the eager forward does
    twin = _twin(net)
    twin.hybridize(False)
    with tag.pause(train_mode=True):
        for _ in range(2):
            assert torch.equal(net(x), twin(x))
    assert ns.traces - t0 == 3
    _assert_bitwise([p.data() for p in net.collect_params().values()],
                    [p.data() for p in twin.collect_params().values()])
    # under record the block runs as one graphed tape node: a program of
    # its own, whose output carries the node's autograd history
    with tag.record():
        out = net(x)
    assert out.requires_grad and ns.traces - t0 == 4
    assert type(out.grad_fn).__name__ == "_GraphedNodeBackward"
    # hybridize() again drops the programs
    net.hybridize()
    net(x)
    assert ns.traces - t0 == 5


# ---------------------------------------------------------------------------
# the program store
# ---------------------------------------------------------------------------


def test_scope_cache_is_an_lru_under_the_cap(knobs):
    knobs(MXNET_FORWARD_CACHE="2")
    ns = tps.namespace("hybrid_forward")
    cache = tps.scope("hybrid_forward")
    e0, m0, h0 = ns.evictions, ns.misses, ns.hits
    for k in "abc":
        assert cache.lookup(k) is None
        cache.insert(k, k.upper())
    assert list(cache) == ["b", "c"]
    assert cache.lookup("b") == "B"              # refreshes b
    cache.insert("d", "D")
    assert list(cache) == ["b", "d"]
    assert (ns.evictions - e0, ns.misses - m0, ns.hits - h0) == (2, 3, 1)
    assert ns.stats()["cap"] == 2


def test_captured_function_runs_with_grad_off():
    """A captured function runs its body with grad mode off whatever the
    caller's (what it reads of torch's modes is fixed, as in a jitted
    function): one program for both modes, and outputs with no autograd
    history."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    fn = tps.capture(lambda x: x * w if torch.is_grad_enabled() else x + w)
    x = torch.tensor([3.0, 4.0])
    got = fn(x)
    with torch.no_grad():
        again = fn(x)
    assert torch.equal(got, x + w.detach()) and torch.equal(again, got)
    assert not got.requires_grad
    assert len(fn.programs) == 1


def test_a_stale_program_is_dropped_on_a_miss():
    """run() drops the programs whose kept tensors the owner no longer
    calls with, counted as evictions; programs over the same tensors (other
    shapes) stay."""
    cache = tps.scope("hybrid_forward")
    ns = cache.namespace
    a, b, c = (torch.zeros(2) for _ in range(3))
    body = (lambda x: x + 1)
    tps.run(cache, ("k", 1), lambda: body, (torch.zeros(1),), keep=[a, b])
    tps.run(cache, ("k", 2), lambda: body, (torch.zeros(2),), keep=[a, b])
    e0 = ns.evictions
    tps.run(cache, ("k", 3), lambda: body, (torch.zeros(2),), keep=[a, c])
    assert list(cache) == [("k", 3)]
    assert ns.evictions - e0 == 2


# kernel names as a profiler trace shows them (demangled) and as the
# build's ptxas report names them (mangled), by the wrapper that launches
# them: a replayed graph's launches are counted by name in a trace
TRACE_NAMES = [
    ("void fwd_wgmma<__nv_bfloat16, 2, 64>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float*, int, int, float)", "flash_attention_fwd"),
    ("_Z9fwd_wgmmaI6__halfLi1ELi128EEv14CUtensorMap_st", "flash_attention_fwd"),
    ("void fwd_fp32<64>(float const*, float const*)", "flash_attention_fwd"),
    ("void dq_wgmma<__nv_bfloat16, 64>(CUtensorMap_st)",
     "flash_attention_bwd_dq"),
    ("void dq_fp32<128>(float const*)", "flash_attention_bwd_dq"),
    ("_Z9dkv_wgmmaI13__nv_bfloat16Li64EEv14CUtensorMap_st",
     "flash_attention_bwd_dkv"),
    ("void dkv_fp32<64>(float const*)", "flash_attention_bwd_dkv"),
    ("void gemm_wgmma<256, 1, 0>(CUtensorMap_st)", "matmul_epilogue"),
    ("void gemm_wgmma<128, 2, 1>(CUtensorMap_st)", "matmul_stats"),
    ("_Z10gemm_wgmmaILi64ELi2ELi2EEv14CUtensorMap_st", "matmul_bn_stats"),
    ("void gemm_wgmma<128, 2, 3>(CUtensorMap_st)", "convkxk_bn_stats"),
    ("void epilogue_fp32<true, false>(Dense32, float const*)",
     "matmul_epilogue"),
    ("void stats_fp32<Dense32, false, false>(Dense32, float const*)",
     "matmul_stats"),
    ("void stats_fp32<Dense32, true, true>(Dense32, float const*)",
     "matmul_bn_stats"),
    ("_Z10stats_fp32I7Dense32Lb1ELb0EEvT_PKfPfS3_S3_ii", "matmul_bn_stats"),
    ("void stats_fp32<Conv32, true, false>(Conv32, float const*)",
     "convkxk_bn_stats"),
    ("void int8_wgmma<true, false>(CUtensorMap_st)", "int8_matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>(int)", None),
    ("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4>>(x)", None),
]


@pytest.mark.parametrize("name,wrapper", TRACE_NAMES)
def test_kernel_of_names_the_wrapper_of_a_traced_kernel(name, wrapper):
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    assert ck.kernel_of(name) == wrapper
    if wrapper is not None:
        assert wrapper in ck.launch_counts()


def test_every_csrc_kernel_has_a_traced_name():
    """Each ``__global__`` kernel of the port's CUDA sources is among the
    names above, so none launches uncounted in a trace."""
    import pathlib
    import re

    csrc = pathlib.Path(tps.__file__).parent / "ops" / "csrc"
    kernels = set()
    for f in sorted(csrc.glob("*.cu*")):
        kernels |= set(re.findall(r"__global__[^;{]*?\b(?!__launch_bounds__)"
                                  r"([A-Za-z_]\w*)\s*\(", f.read_text()))
    assert len(kernels) >= 10, kernels
    named = {re.match(r"(?:void )?(?:_Z\d+)?([a-z0-9_]+?)(?:<|I|\()", n)[1]
             for n, w in TRACE_NAMES if w is not None}
    assert kernels <= named, kernels - named


def test_a_failed_first_call_keeps_no_program():
    cache = tps.scope("hybrid_forward")

    def body(a):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        tps.run(cache, "k", lambda: body, (torch.zeros(2),))
    assert "k" not in cache


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_net(device):
    """``_net()``'s values in the same net on the card, hybridized."""
    net = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                           classes=CLASSES, layout="NHWC", input_layout="NHWC")
    net.initialize(ctx=tmx.gpu(0))
    with torch.no_grad():
        net(_batch()[0].to(device))
    net.load_dict({k: p.data().to(device)
                   for k, p in _net().collect_params().items()})
    net.hybridize()
    return net


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_captured_step_replays_like_the_eager_tape_on_card(cuda_device,
                                                           route, knobs):
    """Three steps replayed as a CUDA graph against the eager tape from
    the same weights: bitwise where two eager runs are bitwise equal,
    else within 3x their spread; 1 capture, 1 dispatch a step."""
    knobs(**{k: "1" for k in ROUTES[route]})
    x, y = (t.to(cuda_device) for t in _batch(8, hw=32))
    runs = []
    for compiled in (False, False, True):
        net = _card_net(cuda_device)
        tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
        step = tr.compile_step(net, _loss)
        t0, d0 = tcs.trace_count(), tcs.dispatch_count()
        losses = []
        for _ in range(3):
            losses.append(step(x, y) if compiled
                          else _eager_step(net, tr, x, y).detach())
        if compiled:
            assert (tcs.trace_count() - t0, tcs.dispatch_count() - d0) == \
                (1, 3)
            assert step.last_fallback_reason is None
        torch.cuda.synchronize()
        runs.append([*losses, *_state(net, tr)])
    a, b, c = runs
    for u, v, w in zip(a, b, c):
        if torch.equal(u, v):
            assert torch.equal(w, u)
        else:
            assert (w - u).abs().max() <= 3 * (v - u).abs().max()


@pytest.mark.cuda
def test_hybridized_forward_clones_on_card(cuda_device):
    net = _card_net(cuda_device)
    x, _ = _batch(4, seed=5, hw=32)
    x2, _ = _batch(4, seed=6, hw=32)
    x, x2 = x.to(cuda_device), x2.to(cuda_device)
    net.hybridize(False)
    want, want2 = net(x), net(x2)
    net.hybridize()
    first = net(x)                                # warm-up and capture
    again = net(x)                                # a replay
    second = net(x2)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(again, want)
    assert torch.equal(second, want2)
    assert again.data_ptr() != second.data_ptr()
