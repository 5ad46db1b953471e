"""The port's ``parallel.ShardedTrainer`` at dp=1 (mxnet_tpu_torch.parallel)
and its update ops (``ops.optimizer``) held against the JAX package's
(``mxnet_tpu.parallel.ShardedTrainer``, ``mxnet_tpu.ops.optimizer``) on the
CPU, on the same numpy weights and batches:

- every optimizer (sgd with and without momentum, adam, adamw, lamb) in
  fp32 and with a bf16 compute dtype over fp32 masters; ``grad_accum=2``
  with batch norm; ``remat``; int32 labels through the softmax
  cross-entropy (mirrors ``tests/test_parallel.py:344, :404, :444``,
  ``tests/test_models.py:112`` and ``tests/test_remat.py:92``);
- one captured program a signature, one dispatch a step;
- the fused ResNet sites a step, under ``compile_step`` and
  ``ShardedTrainer``, for a block that is hybridized and one that is not,
  against the reference's count of its fused op calls.

Tolerances: fp32 within 2e-4 (the two packages' sums in other orders),
bf16 compute within 1e-2 (both round activations to bf16, in other
places), as the port's other parity tests hold them.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import optimizer as topt
from mxnet_tpu_torch.optimizer.sgd import SGD

from test_torch_gluon_resnet import CLASSES, _narrow_pair, _numpy_params
from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jmx = LazyModule("mxnet_tpu")
jnp = LazyModule("jax.numpy")
jconfig = LazyModule("mxnet_tpu.config")
jgluon = LazyModule("mxnet_tpu.gluon")
jpar = LazyModule("mxnet_tpu.parallel")
jopt = LazyModule("mxnet_tpu.ops.optimizer")
jresnet = LazyModule("mxnet_tpu.gluon.model_zoo.vision.resnet")
get_op = LazyModule("mxnet_tpu.ops.registry", "get_op")

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
CPU = torch.device("cpu")

OPTIMIZERS = {
    "sgd_mom": ("sgd", {"lr": 0.05, "momentum": 0.9, "wd": 1e-4}),
    "sgd": ("sgd", {"lr": 0.05}),
    "adam": ("adam", {"lr": 0.01, "wd": 1e-4}),
    "adamw": ("adamw", {"lr": 0.01, "wd": 0.01}),
    "lamb": ("lamb", {"lr": 0.01, "wd": 1e-4}),
}


def _mse(out, label):
    d = out - label
    return (d * d).mean()


def _mlp(pkg):
    """Dense -> BatchNorm -> relu -> Dense, as test_parallel.py:444, with
    no bias before the batch norm (as the ResNet convs): that bias's
    gradient is zero up to rounding, which Adam's and LAMB's normalised
    steps would blow up to full-size steps of either sign."""
    nn = pkg.gluon.nn if pkg is not tmx else tgluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, use_bias=False),
            nn.BatchNorm(in_channels=16),
            nn.Activation("relu"), nn.Dense(4, in_units=16))
    return net


def _mlp_pair(seed=0):
    jnet = _mlp(jmx)
    jnet.initialize(jmx.init.Xavier())
    rng = onp.random.RandomState(seed)
    for name, p in sorted(jnet.collect_params().items()):
        v = rng.randn(*p.shape).astype(onp.float32) * 0.3
        if "running_var" in name:
            v = onp.abs(v) + 0.5
        p.set_data(jmx.nd.array(v))
    tnet = _mlp(tmx)
    tnet.initialize(ctx=tmx.cpu())
    gluon_params_from_numpy(tnet, _numpy_params(jnet))
    return jnet, tnet


def _data(seed=9, rows=16):
    rng = onp.random.RandomState(seed)
    return (rng.randn(rows, 8).astype(onp.float32),
            rng.randn(rows, 4).astype(onp.float32))


def _mesh():
    return tpar.make_mesh({"dp": 1}, devices=[CPU])


def _run_both(opt, kw, steps=4, **trainer_kw):
    """``steps`` steps of each package's ShardedTrainer from the same
    weights: (jax losses, port losses, jax trainer, port trainer)."""
    jnet, tnet = _mlp_pair()
    x, y = _data()
    jkw = dict(trainer_kw)
    if jkw.get("compute_dtype") is torch.bfloat16:
        jkw["compute_dtype"] = jnp.bfloat16
    jtr = jpar.ShardedTrainer(jnet, _mse, jpar.make_mesh({"dp": 1}),
                              optimizer=opt, optimizer_params=dict(kw),
                              **jkw)
    ttr = tpar.ShardedTrainer(tnet, _mse, _mesh(), optimizer=opt,
                              optimizer_params=dict(kw), **trainer_kw)
    jl = [jtr.step(x, y) for _ in range(steps)]
    tl = [ttr.step(x, y) for _ in range(steps)]
    return onp.array(jl), onp.array(tl), jtr, ttr


def _assert_state(jtr, ttr, tol):
    for n, w in ttr.params.items():
        assert w.dtype == torch.float32, n       # the masters stay fp32
        onp.testing.assert_allclose(w.numpy(), onp.asarray(jtr.params[n]),
                                    err_msg=n, **tol)
    for n, st in ttr.opt_state.items():
        assert len(st) == len(jtr.opt_state[n]), n
        for i, (a, b) in enumerate(zip(st, jtr.opt_state[n])):
            assert a.dtype == torch.float32
            onp.testing.assert_allclose(a.numpy(), onp.asarray(b),
                                        err_msg=f"{n} state {i}", **tol)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sharded_trainer_matches_jax(name, compute):
    opt, kw = OPTIMIZERS[name]
    cd = torch.bfloat16 if compute == "bf16" else None
    tol = BF16_TOL if cd is not None else FP32_TOL
    jl, tl, jtr, ttr = _run_both(opt, kw, compute_dtype=cd)
    onp.testing.assert_allclose(tl, jl, **tol)
    assert tl[-1] < tl[0]
    _assert_state(jtr, ttr, tol)
    assert ttr.step_count == jtr.step_count == 4


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_grad_accum_with_batchnorm_matches_jax(compute):
    """grad_accum=2 with batch norm: micro-batches chain the running
    statistics, the gradients are summed and halved (the reference's
    test_parallel.py:444 setup, here held to the reference's values)."""
    cd = torch.bfloat16 if compute == "bf16" else None
    tol = BF16_TOL if cd is not None else FP32_TOL
    jl, tl, jtr, ttr = _run_both("sgd", {"lr": 0.05, "momentum": 0.9},
                                 grad_accum=2, compute_dtype=cd)
    onp.testing.assert_allclose(tl, jl, **tol)
    assert tl[-1] < tl[0]
    _assert_state(jtr, ttr, tol)


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_matches_jax_and_equals_plain_bitwise(accum):
    """remat recomputes the forward in the backward: the same math, so
    the port's steps are bitwise those without remat, and the running
    statistics are updated once a micro-batch, not again by the
    recomputation."""
    kw = {"lr": 0.05, "momentum": 0.9}
    jl, tl, jtr, ttr = _run_both("sgd", kw, grad_accum=accum, remat=True)
    onp.testing.assert_allclose(tl, jl, **FP32_TOL)
    _assert_state(jtr, ttr, FP32_TOL)
    _, tl0, _, ttr0 = _run_both("sgd", kw, grad_accum=accum, remat=False)
    assert onp.array_equal(tl, tl0)
    for n, w in ttr.params.items():
        assert torch.equal(w, ttr0.params[n]), n


def test_remat_default_follows_the_mirror_knob(monkeypatch):
    jnet, tnet = _mlp_pair()
    assert not tpar.ShardedTrainer(tnet, _mse, _mesh()).remat
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    tconfig.refresh("MXNET_BACKWARD_DO_MIRROR")
    try:
        assert tpar.ShardedTrainer(tnet, _mse, _mesh()).remat
    finally:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
        tconfig.refresh("MXNET_BACKWARD_DO_MIRROR")


def test_int32_labels_through_softmax_cross_entropy_match_jax():
    """test_remat.py:92's setup: int32 labels and ``ce(o, l).mean()``."""
    rng = onp.random.RandomState(2)
    x = rng.rand(8, 8).astype(onp.float32)
    y = rng.randint(0, 2, (8,)).astype(onp.int32)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, in_units=8), jgluon.nn.Activation("relu"),
             jgluon.nn.Dense(2, in_units=16))
    jnet.initialize(jmx.init.Xavier())
    tnet = tgluon.nn.HybridSequential()
    tnet.add(tgluon.nn.Dense(16, in_units=8), tgluon.nn.Activation("relu"),
             tgluon.nn.Dense(2, in_units=16))
    tnet.initialize(ctx=tmx.cpu())
    gluon_params_from_numpy(tnet, _numpy_params(jnet))
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tce = tgluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ShardedTrainer(jnet, lambda o, l: jce(o, l).mean(),
                              jpar.make_mesh({"dp": 1}), optimizer="sgd",
                              optimizer_params={"lr": 0.1})
    ttr = tpar.ShardedTrainer(tnet, lambda o, l: tce(o, l).mean(), _mesh(),
                              optimizer="sgd", optimizer_params={"lr": 0.1})
    d, lab = ttr.stage(x, y)
    assert lab.dtype == torch.int32
    jl = [jtr.step(x, y) for _ in range(3)]
    tl = [ttr.step(d, lab) for _ in range(3)]
    onp.testing.assert_allclose(tl, jl, **FP32_TOL)
    assert tl[-1] < tl[0]


def test_sync_to_block_and_async_loss():
    jl, tl, jtr, ttr = _run_both("sgd", {"lr": 0.05}, steps=2)
    loss = ttr.step(*_data(), sync=False)
    assert isinstance(loss, torch.Tensor) and loss.dtype == torch.float32
    ttr.sync_to_block()
    for n, p in ttr.block.collect_params().items():
        assert torch.equal(p.data(), ttr.params[n]), n


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def test_one_program_a_signature_one_dispatch_a_step():
    ns = tps.namespace("sharded_step")
    _, tnet = _mlp_pair()
    tr = tpar.ShardedTrainer(tnet, _mse, _mesh(), optimizer="adam",
                             optimizer_params={"lr": 0.01})
    x, y = _data()
    t0, d0 = ns.traces, ns.dispatches
    for _ in range(3):
        tr.step(x, y)
    assert (ns.traces - t0, ns.dispatches - d0) == (1, 3)
    tr.step(x[:8], y[:8])                        # a new signature
    tr.step(x, y)                                # the first: a hit
    assert (ns.traces - t0, ns.dispatches - d0) == (2, 5)
    # the step count lives on the device and advances in the program
    assert float(tr._t) == tr.step_count == 5


def test_step_after_a_new_signature_continues_the_trajectory():
    """Two signatures share the masters, the state and the step count:
    alternating them equals the reference's alternation."""
    jnet, tnet = _mlp_pair()
    jtr = jpar.ShardedTrainer(jnet, _mse, jpar.make_mesh({"dp": 1}),
                              optimizer="adam", optimizer_params={"lr": 0.01})
    ttr = tpar.ShardedTrainer(tnet, _mse, _mesh(), optimizer="adam",
                              optimizer_params={"lr": 0.01})
    x, y = _data()
    for rows in (16, 8, 16, 8):
        jl = jtr.step(x[:rows], y[:rows])
        tl = ttr.step(x[:rows], y[:rows])
        onp.testing.assert_allclose(tl, jl, **FP32_TOL)
    _assert_state(jtr, ttr, FP32_TOL)


def test_mesh_axes_above_one_raise_and_cuda_is_the_default():
    # a mesh needs as many ranks as its size; this process is a world of
    # one (tests/test_torch_spmd.py runs the larger meshes in gloo worlds)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tpar.make_mesh({"dp": 2})
    with pytest.raises(ValueError, match="needs 4 devices"):
        tpar.make_mesh({"dp": 1, "tp": 4}, devices=[CPU])
    mesh = tpar.make_mesh({"tp": 1, "dp": 1, "fsdp": 1}, devices=[CPU])
    assert mesh.axis_names == ("dp", "fsdp", "tp")
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpar.make_mesh({"dp": 1})


def test_refusals():
    _, tnet = _mlp_pair()
    with pytest.raises(ValueError, match="optimizer_params"):
        tpar.ShardedTrainer(tnet, _mse, _mesh(),
                            optimizer_params={"lr": 0.1, "gamma": 2})
    with pytest.raises(ValueError, match="unsupported sharded optimizer"):
        tpar.ShardedTrainer(tnet, _mse, _mesh(), optimizer="rmsprop")
    with pytest.raises(TypeError, match="ShardingPlan"):
        tpar.ShardedTrainer(tnet, _mse, _mesh(), plan=object())
    fresh = _mlp(tmx)
    fresh.initialize(ctx=tmx.cpu())
    fresh.collect_params()["1.gamma"]._data = None
    with pytest.raises(ValueError, match="initialize"):
        tpar.ShardedTrainer(fresh, _mse, _mesh())
    tr = tpar.ShardedTrainer(tnet, _mse, _mesh(), grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum"):
        tr.step(*_data(rows=16))


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------


def _op_inputs(seed=3, shape=(7, 5)):
    rng = onp.random.RandomState(seed)
    w, g, m = (rng.randn(*shape).astype(onp.float32) for _ in range(3))
    v = onp.abs(rng.randn(*shape)).astype(onp.float32)
    return w, g, m, v


def _close(got, want, bitwise=False):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if bitwise:
            assert onp.array_equal(a.numpy(), onp.asarray(b))
        else:
            onp.testing.assert_allclose(a.numpy(), onp.asarray(b),
                                        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "adam_update", "adamw_update",
                                "lamb_update_phase1", "lamb_update_phase2"])
def test_update_ops_match_jax(op):
    """Each op against the reference's on the same fp32 inputs: the same
    expressions, so the elementwise ones agree bitwise; those with a
    square root or a power within 1e-6."""
    w, g, m, v = _op_inputs()
    T = [torch.from_numpy(a) for a in (w, g, m, v)]
    J = [jnp.asarray(a) for a in (w, g, m, v)]
    kw = dict(wd=1e-2, rescale_grad=0.5, clip_gradient=0.8)
    if op == "sgd_update":
        _close(topt.sgd_update(T[0], T[1], lr=0.1, **kw),
               jopt.sgd_update(J[0], J[1], lr=0.1, **kw), bitwise=True)
    elif op == "sgd_mom_update":
        _close(topt.sgd_mom_update(*T[:3], lr=0.1, momentum=0.9, **kw),
               jopt.sgd_mom_update(*J[:3], lr=0.1, momentum=0.9, **kw),
               bitwise=True)
    elif op == "adam_update":
        _close(topt.adam_update(*T, lr=0.01, **kw),
               jopt.adam_update(*J, lr=0.01, **kw))
    elif op == "adamw_update":
        _close(topt.adamw_update(T, lr=0.01, eta=0.7, **kw),
               jopt.adamw_update(J, lr=0.01, eta=0.7, **kw))
    elif op == "lamb_update_phase1":
        t = torch.tensor(3.0)
        _close(topt.lamb_update_phase1(*T, t=t, **kw),
               jopt.lamb_update_phase1(*J, t=jnp.float32(3.0), **kw))
    else:
        for r1, r2 in ((2.0, 0.5), (0.0, 3.0), (1.5, 0.0)):
            tr = [torch.tensor(r1), torch.tensor(r2)]
            jr = [jnp.float32(r1), jnp.float32(r2)]
            _close(topt.lamb_update_phase2(T[:2] + tr, lr=0.1,
                                           lower_bound=0.1, upper_bound=3.0),
                   jopt.lamb_update_phase2(J[:2] + jr, lr=0.1,
                                           lower_bound=0.1, upper_bound=3.0),
                   bitwise=True)


def test_gluon_sgd_is_sgd_mom_update_bitwise():
    """optimizer/sgd.py's _foreach SGD, reading its per-step values from
    device scalars, rounds as sgd_mom_update on the same inputs."""
    w, g, m, _ = _op_inputs(seed=5)
    opt = SGD(learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.25)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    opt.step([tw], [torch.from_numpy(g)], [tm])
    want_w, want_m = topt.sgd_mom_update(
        torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(m),
        lr=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.25)
    assert torch.equal(tw, want_w) and torch.equal(tm, want_m)


# ---------------------------------------------------------------------------
# the fused ResNet sites a step (the port's trace)
# ---------------------------------------------------------------------------

ROUTES = {"epilogue": "MXNET_FUSED_EPILOGUE", "conv_bn": "MXNET_FUSED_CONV_BN"}


@pytest.fixture
def route(request, monkeypatch):
    knob = ROUTES[request.param]
    monkeypatch.setenv(knob, "2")
    jconfig.refresh(knob)
    tconfig.refresh(knob)
    yield request.param
    monkeypatch.delenv(knob)
    jconfig.refresh(knob)
    tconfig.refresh(knob)


@contextlib.contextmanager
def reference_sites():
    """The reference's fused-site calls: ``_try_fused_epilogue`` results
    that are not None and the fused conv + BN ops (its traced step runs
    each once)."""
    counts = {"epilogue": 0, "conv_bn": 0}
    module = jresnet._target()
    orig = module._try_fused_epilogue

    def counting(*a, **kw):
        out = orig(*a, **kw)
        counts["epilogue"] += out is not None
        return out

    module._try_fused_epilogue = counting
    origs = []
    for kind in ("1x1", "kxk"):
        schema = get_op(f"_fused_conv{kind}_bn")
        origs.append((schema, schema.fn))

        def op(*a, _f=schema.fn, **kw):
            counts["conv_bn"] += 1
            return _f(*a, **kw)

        schema.fn = op
    try:
        yield counts
    finally:
        module._try_fused_epilogue = orig
        for schema, fn in origs:
            schema.fn = fn


def _port_sites(which):
    if which == "epilogue":
        return tresnet.fused_epilogue_counts()["fused"]
    c = tresnet.fused_conv_bn_counts()
    return c["1x1"] + c["kxk"]


def _block_pair(hybridized):
    """A BottleneckV1 with a downsample (its 3 sites on the epilogue
    route; conv1 + conv3 + downsample 1x1 and the 3x3 on conv + BN's),
    hybridized or not in both packages."""
    x = onp.random.RandomState(4).randn(2, 8, 8, 32).astype(onp.float32)
    kw = dict(channels=64, stride=1, downsample=True, in_channels=32,
              layout="NHWC")
    jb, tb = jresnet.BottleneckV1(**kw), tresnet.BottleneckV1(**kw)
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x))
    tb.initialize(ctx=tmx.cpu())
    tb(torch.from_numpy(x))
    gluon_params_from_numpy(tb, _numpy_params(jb))
    if hybridized:
        jb.hybridize()
        tb.hybridize()
    return jb, tb, x


@pytest.mark.parametrize("hybridized", [False, True],
                         ids=["not_hybridized", "hybridized"])
@pytest.mark.parametrize("trainer", ["compile_step", "sharded_trainer"])
@pytest.mark.parametrize("route", list(ROUTES), indirect=True)
def test_fused_sites_a_step_equal_the_reference(route, trainer, hybridized):
    """Each step's fused sites, port against the reference, under
    ``compile_step`` and ``ShardedTrainer`` (the reference fuses wherever
    it traces; the port's step body is its trace). The bottleneck has 3
    fused sites on the epilogue route and 4 on conv + BN's."""
    jb, tb, x = _block_pair(hybridized)
    y = onp.random.RandomState(5).randn(2, 8, 8, 64).astype(onp.float32)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    if trainer == "compile_step":
        jtr = jgluon.Trainer(jb.collect_params(), "sgd", dict(opt))
        ttr = tgluon.Trainer(tb.collect_params(), "sgd", dict(opt))
        jstep = jtr.compile_step(jb, lambda n, a, b: _mse(n(a), b))
        tstep = ttr.compile_step(tb, lambda n, a, b: _mse(n(a), b))
        jcall = (lambda: jstep(jmx.nd.array(x), jmx.nd.array(y)))
        tcall = (lambda: tstep(torch.from_numpy(x), torch.from_numpy(y)))
    else:
        jtr = jpar.ShardedTrainer(jb, _mse, jpar.make_mesh({"dp": 1}),
                                  optimizer="sgd", optimizer_params=opt)
        ttr = tpar.ShardedTrainer(tb, _mse, _mesh(), optimizer="sgd",
                                  optimizer_params=opt)
        jcall = (lambda: jtr.step(x, y))
        tcall = (lambda: ttr.step(x, y))
    want = {"epilogue": 3, "conv_bn": 4}[route]
    with reference_sites() as ref:
        jcall()
    assert ref[route] == want
    for i in range(2):
        tresnet.reset_fused_epilogue_counts()
        tresnet.reset_fused_conv_bn_counts()
        tcall()
        # the CPU program runs its body every call: each step counts once
        assert _port_sites(route) == want, i
        if route == "conv_bn":
            assert tresnet.fused_conv_bn_counts()["refused"] == 0


@pytest.mark.parametrize("route", ["epilogue"], indirect=True)
def test_eager_calls_of_a_block_not_hybridized_never_fuse(route):
    """Outside a trace nothing fuses, in either package: the eager tape
    of a block that is not hybridized runs the plain layers."""
    jb, tb, x = _block_pair(hybridized=False)
    with reference_sites() as ref, jmx.autograd.record():
        jb(jmx.nd.array(x))
    assert ref["epilogue"] == 0
    tresnet.reset_fused_epilogue_counts()
    with tmx.autograd.record():
        tb(torch.from_numpy(x))
    assert tresnet.fused_epilogue_counts() == {"fused": 0, "refused": 0}


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_narrow_resnet_sharded_trainer_matches_jax(compute):
    """The ResNet lane's setup at toy size: a narrow bottleneck ResNet v1,
    NHWC, SGD momentum with weight decay, fp32 masters, int32 labels, at
    the lane's gated lr (``chip_smoke.RESNET_LR``, 1e-3: at lr 0.01 the
    reference's Xavier fans let bf16 rounding differences grow by a
    factor of about 2 a step through this net)."""
    rng = onp.random.RandomState(0)
    x = rng.randn(4, 16, 16, 3).astype(onp.float32)
    y = rng.randint(0, CLASSES, 4).astype(onp.int32)
    jnet, tnet = _narrow_pair(x)
    cd = torch.bfloat16 if compute == "bf16" else None
    tol = BF16_TOL if cd is not None else dict(rtol=1e-4, atol=1e-4)
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tce = tgluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"lr": 1e-3, "momentum": 0.9, "wd": 1e-4}
    jtr = jpar.ShardedTrainer(
        jnet, lambda o, l: jce(o, l).mean(), jpar.make_mesh({"dp": 1}),
        optimizer="sgd", optimizer_params=dict(opt),
        compute_dtype=None if cd is None else jnp.bfloat16)
    ttr = tpar.ShardedTrainer(
        tnet, lambda o, l: tce(o, l).mean(), _mesh(), optimizer="sgd",
        optimizer_params=dict(opt), compute_dtype=cd)
    jl = [jtr.step(x, y) for _ in range(3)]
    tl = [ttr.step(x, y) for _ in range(3)]
    onp.testing.assert_allclose(tl, jl, **tol)
    for n, w in ttr.params.items():
        assert w.dtype == torch.float32
        onp.testing.assert_allclose(w.numpy(), onp.asarray(jtr.params[n]),
                                    err_msg=n, **tol)


def test_compiled_step_off_runs_the_same_body_eagerly(monkeypatch):
    """``MXNET_COMPILED_STEP=0``: the step's body runs eagerly, with no
    program, bitwise as the program runs it."""
    runs = []
    for knob in ("1", "0"):
        monkeypatch.setenv("MXNET_COMPILED_STEP", knob)
        tconfig.refresh("MXNET_COMPILED_STEP")
        ns = tps.namespace("sharded_step")
        d0 = ns.dispatches
        _, tnet = _mlp_pair()
        tr = tpar.ShardedTrainer(tnet, _mse, _mesh(), optimizer="lamb",
                                 optimizer_params={"lr": 0.01},
                                 grad_accum=2)
        losses = [tr.step(*_data()) for _ in range(3)]
        assert ns.dispatches - d0 == (3 if knob == "1" else 0)
        runs.append((losses, list(tr.params.values())))
    monkeypatch.delenv("MXNET_COMPILED_STEP")
    tconfig.refresh("MXNET_COMPILED_STEP")
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
