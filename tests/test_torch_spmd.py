"""The port's sharded train steps (``Trainer(kvstore='tpu').compile_step``
and ``parallel.ShardedTrainer`` with plans) in gloo worlds on the CPU, held
against the JAX package's steps on its 8 virtual devices, on the same
numpy weights and batches, at the reference's own bound (``rtol 1e-4,
atol 5e-6``, ``tests/test_fsdp_step.py:275``) unless a case says otherwise:

- ``compile_step`` under ``kvstore='tpu'`` on ``dp=4``, ``dp=2,fsdp=2``
  (SGD with momentum and wd, Adam with wd) and ``dp=2,fsdp=2,tp=2`` with a
  ``constraint`` in the forward; parameters and optimizer state, and on
  every rank 1 dispatch a step, 1 trace, 0 reshards after the first
  placement, ``param_bytes_per_device == total // 2`` at ``fsdp=2``, and
  a loud replication of an indivisible batch (mirrors
  ``tests/test_fsdp_step.py:152-372``); a ``.mean()`` loss beside the
  ``.sum()`` one; an ``accum_steps=2`` window against the big batch;
- ``ShardedTrainer`` at dp=8, fsdp x tp with Adam, bf16 compute +
  ``grad_accum=2`` with batch norm on dp=2, and remat under dp=8
  (``tests/test_parallel.py:344, :380, :404, :444, :610``);
- a narrow Conv2D + BatchNorm net through both fused routes (the conv +
  batch-statistics kernels' plain versions, B4 and B8; the ResNet
  bottleneck's epilogue route, B5 and B6) and the plain batch norm at
  dp=2: the running statistics are the global batch's and the parameters
  match the reference's dp=2 run;
- on a mesh of one, in this process: the kvstore step and the planned
  ``ShardedTrainer`` bitwise equal to the plain ones.

One world a world size for the file (2, 4 and 8 processes), each running
all its scenarios in one go (``test_torch_sharding.run_world``). The
reference's AMP-scaler cases wait for AMP (ROADMAP A4).
"""
import contextlib
import os
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon.nn import basic_layers as tbasic
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.parallel import sharding as tsh
from mxnet_tpu_torch.parallel import spmd as tspmd

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jmx = LazyModule("mxnet_tpu")
jgluon = LazyModule("mxnet_tpu.gluon")
jpar = LazyModule("mxnet_tpu.parallel")
jsh = LazyModule("mxnet_tpu.parallel.sharding")
jconfig = LazyModule("mxnet_tpu.config")
jresnet = LazyModule("mxnet_tpu.gluon.model_zoo.vision.resnet")
jnp = LazyModule("jax.numpy")

TOL = dict(rtol=1e-4, atol=5e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SGD = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
ADAM = ("adam", {"learning_rate": 0.02, "wd": 0.01})


@contextlib.contextmanager
def knobs(**env):
    """Env knobs for both packages (refreshed), restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    _refresh(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _refresh(env)


def _refresh(names):
    for k in names:
        tconfig.refresh(k)
        if "mxnet_tpu" in __import__("sys").modules:
            jconfig.refresh(k)


# ---------------------------------------------------------------------------
# nets and data, the same numpy draws in both packages
# ---------------------------------------------------------------------------
def _mlp(pkg_gluon, tp=False):
    nn = pkg_gluon.nn
    shmod = tsh if pkg_gluon is tgluon else jsh

    class Net(pkg_gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = nn.Dense(16, in_units=8, activation="relu")
            self.d2 = nn.Dense(4, in_units=16)

        def forward(self, x):
            h = self.d1(x)
            if tp:
                # Megatron column-parallel activation layout: batch over
                # dp, features over tp (legalizes away without tp)
                h = shmod.constraint(h, ("dp", "tp"))
            return self.d2(h)

    return Net()


def _set_weights(net, seed, torch_side):
    rng = onp.random.RandomState(seed)
    for name, p in sorted(net.collect_params().items()):
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            w = 1.0 + 0.1 * rng.rand(*shape)
        elif name.endswith(("beta", "running_mean")):
            w = 0.1 * rng.randn(*shape)
        else:
            w = rng.randn(*shape) * 0.1
        w = w.astype(onp.float32)
        if torch_side:
            p.set_data(torch.from_numpy(w))
        else:
            p.set_data(jmx.nd.array(w))


def t_mlp(seed=0, tp=False):
    net = _mlp(tgluon, tp)
    net.initialize(ctx=tmx.cpu())
    _set_weights(net, seed, True)
    net.hybridize()
    return net


def j_mlp(seed=0, tp=False):
    net = _mlp(jgluon, tp)
    net.initialize(jmx.init.Xavier())
    _set_weights(net, seed, False)
    net.hybridize()
    return net


def loss_sum(net, x, y):
    return ((net(x) - y) ** 2).sum()


def loss_mean(net, x, y):
    return ((net(x) - y) ** 2).mean()


def _batches(steps, rows, seed=7, shape=(8,), out=4):
    rng = onp.random.RandomState(seed)
    return [(rng.randn(rows, *shape).astype(onp.float32),
             rng.randn(rows, out).astype(onp.float32)) for _ in range(steps)]


def _step_run(torch_side, spec, opt, steps=4, rows=16, accum=1,
              loss=loss_sum, tp=False, kvstore="tpu", seed=0):
    """Train under MXNET_SPMD_MESH=spec; with accum > 1 each window is
    accum micro-batch calls over the same global rows. Returns the net,
    trainer and step."""
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1), \
            (tmx.cpu() if torch_side else contextlib.nullcontext()):
        if torch_side:
            net, g = t_mlp(seed, tp), tgluon
        else:
            net, g = j_mlp(seed, tp), jgluon
        tr = g.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                       kvstore=kvstore)
        step = tr.compile_step(net, loss, accum_steps=accum)
        micro = rows // accum
        for x, y in _batches(steps, rows):
            for m in range(accum):
                sl = slice(m * micro, (m + 1) * micro)
                if torch_side:
                    step(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
                         batch_size=micro)
                else:
                    step(jmx.nd.array(x[sl]), jmx.nd.array(y[sl]),
                         batch_size=micro)
                assert step.last_step_compiled, step.last_fallback_reason
    return net, tr, step


def _t_state(net, tr, step):
    """Parameters and optimizer states whole, keyed for the npz."""
    out = {f"p:{k}": v.numpy() for k, v in step.full_params().items()}
    for i, p in enumerate(tr._params):
        for j, leaf in enumerate(step.full_state(p)):
            out[f"s:{i}:{j}"] = leaf.numpy()
    return out


def _j_state(net, tr):
    out = {f"p:{k}": p.data().asnumpy()
           for k, p in net.collect_params().items()}
    for i, s in tr._updaters[0].states.items():
        leaves = s if isinstance(s, (list, tuple)) else [s]
        for j, leaf in enumerate(x for x in leaves if x is not None):
            out[f"s:{i}:{j}"] = leaf.asnumpy()
    return out


def _assert_same(got, want, tol=TOL, what=""):
    assert set(want) <= set(got), (what, sorted(set(want) - set(got)))
    for k, w in want.items():
        onp.testing.assert_allclose(got[k], w, err_msg=f"{what} {k}", **tol)


# ---------------------------------------------------------------------------
# rank-side scenarios (run in the worlds)
# ---------------------------------------------------------------------------
def _quietly(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def w4_steps():
    out = {}
    for spec in ("dp=4", "dp=2,fsdp=2"):
        for opt in (SGD, ADAM):
            tspmd.reset_counters()
            d0, t0 = tcs.dispatch_count(), tcs.trace_count()
            net, tr, step = _step_run(True, spec, opt)
            key = f"{spec}|{opt[0]}"
            for k, v in _t_state(net, tr, step).items():
                out[f"{key}|{k}"] = v
            out[f"{key}|dispatches"] = tcs.dispatch_count() - d0
            out[f"{key}|traces"] = tcs.trace_count() - t0
            out[f"{key}|reshards"] = tspmd.reshard_count()
            out[f"{key}|bytes"] = tspmd.param_bytes_per_device()
            out[f"{key}|opt_bytes"] = tspmd.opt_bytes_per_device()
            out[f"{key}|total"] = sum(
                v.numel() * 4 for v in step.full_params().values())
            snap = ttel.snapshot()
            out[f"{key}|gauge"] = snap["spmd.param_bytes_per_device"]
            # one more step: no reshard, no trace
            r0, t1 = tspmd.reshard_count(), tcs.trace_count()
            with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
                x, y = _batches(1, 16, seed=9)[0]
                step(torch.from_numpy(x), torch.from_numpy(y),
                     batch_size=16)
            out[f"{key}|reshards_after"] = tspmd.reshard_count() - r0
            out[f"{key}|traces_after"] = tcs.trace_count() - t1
    # a .mean() loss
    net, tr, step = _step_run(True, "dp=2,fsdp=2", SGD, loss=loss_mean)
    for k, v in _t_state(net, tr, step).items():
        out[f"mean|{k}"] = v
    # an accum_steps=2 window
    net, tr, step = _step_run(True, "dp=2,fsdp=2", SGD, steps=3, accum=2)
    for k, v in _t_state(net, tr, step).items():
        out[f"accum|{k}"] = v
    # 6 rows on dp=4: replicated loudly, still one program
    tspmd.reset_counters()
    net, tr, step = _quietly(_step_run, True, "dp=4", SGD, steps=3, rows=6)
    for k, v in _t_state(net, tr, step).items():
        out[f"rows6|{k}"] = v
    out["rows6|replicated"] = tspmd.replicated_batch_count()
    return out


def w8_steps():
    out = {}
    d0, t0 = tcs.dispatch_count(), tcs.trace_count()
    net, tr, step = _step_run(True, "dp=2,fsdp=2,tp=2", SGD, steps=3,
                              rows=8, tp=True, seed=5)
    out["tp|dispatches"] = tcs.dispatch_count() - d0
    out["tp|traces"] = tcs.trace_count() - t0
    out["tp|tp"] = step.mesh.shape["tp"]
    for k, v in _t_state(net, tr, step).items():
        out[f"tp|{k}"] = v
    for name, fn in (("dp8", _st_dp8), ("fsdp_tp", _st_fsdp_tp),
                     ("remat", _st_remat)):
        for k, v in fn(True).items():
            out[f"{name}|{k}"] = v
    return out


def _deferred_run(kvstore, seed, steps=3, rows=16):
    """An MLP whose input width is inferred at the first call, drawn from
    ``seed``, trained under ``kvstore`` on MXNET_SPMD_MESH=2."""
    with knobs(MXNET_SPMD_MESH="2", MXNET_FSDP_MIN_SIZE=1), tmx.cpu():
        nn = tgluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize(tmx.init.Xavier(
            generator=torch.Generator().manual_seed(seed)), ctx=tmx.cpu())
        net.hybridize()
        tr = tgluon.Trainer(net.collect_params(), SGD[0], dict(SGD[1]),
                            kvstore=kvstore)
        step = tr.compile_step(net, loss_sum)
        for x, y in _batches(steps, rows):
            step(torch.from_numpy(x), torch.from_numpy(y), batch_size=rows)
        return step, {k: v.numpy() for k, v in step.full_params().items()}


def _grad_req_add_refused() -> int:
    """1 when the step on the dp=2 mesh refuses grad_req='add' at its
    first call (never an eager step of this rank's own)."""
    with knobs(MXNET_SPMD_MESH="2"), tmx.cpu():
        net = t_mlp()
        net.d1.weight.grad_req = "add"
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="tpu")
        step = tr.compile_step(net, loss_sum)
        x, y = _batches(1, 16)[0]
        try:
            step(torch.from_numpy(x), torch.from_numpy(y), batch_size=16)
        except tmx.base.MXNetError as e:
            return int("grad_req='add'" in str(e))
        return 0


def w2_steps():
    out = {}
    # deferred init: each rank draws its own weights; the step on the mesh
    # must start every rank from rank 0's, so it is held against the plain
    # step from rank 0's draws (on every rank)
    d0 = tcs.dispatch_count()
    step, got = _deferred_run("tpu", 100 + torch.distributed.get_rank())
    out["deferred|compiled"] = int(step.last_step_compiled)
    out["deferred|dispatches"] = tcs.dispatch_count() - d0
    for k, v in got.items():
        out[f"deferred|p:{k}"] = v
    for k, v in _deferred_run("device", 100)[1].items():
        out[f"deferred_plain|p:{k}"] = v
    out["grad_req_add|refused"] = _grad_req_add_refused()
    for k, v in _st_bf16_accum_bn(True).items():
        out[f"bn_accum|{k}"] = v
    for route in ROUTES:
        for k, v in _convbn_run(True, route).items():
            out[f"{route}|{k}"] = v
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds of the file, run once: each rank's results, in
    rank order."""
    res = {}
    for n, fn in ((4, "w4_steps"), (8, "w8_steps"), (2, "w2_steps")):
        res[n] = [r[fn] for r in run_world(
            n, [f"{__name__}:{fn}"], tmp_path_factory.mktemp(f"world{n}"))]
    return res


def _part(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "|")}


# ---------------------------------------------------------------------------
# ShardedTrainer scenarios (both sides)
# ---------------------------------------------------------------------------
def _st_net(torch_side, kind):
    g = tgluon if torch_side else jgluon
    nn = g.nn
    net = nn.HybridSequential()
    if kind == "mlp":
        net.add(nn.Dense(16, in_units=8, activation="relu"),
                nn.Dense(4, in_units=16))
    elif kind == "bn":
        net.add(nn.Dense(16, in_units=8, use_bias=False),
                nn.BatchNorm(in_channels=16), nn.Activation("relu"),
                nn.Dense(4, in_units=16))
    if torch_side:
        net.initialize(ctx=tmx.cpu())
    else:
        net.initialize(jmx.init.Xavier())
    _set_weights(net, 3, torch_side)
    return net


class _TPNet:
    """ffn_1 / ffn_2 names, which tensor_parallel_plan shards."""

    @staticmethod
    def make(torch_side):
        g = tgluon if torch_side else jgluon
        nn = g.nn

        class Net(g.HybridBlock):
            def __init__(self):
                super().__init__()
                self.ffn_1 = nn.Dense(16, in_units=8, activation="relu")
                self.ffn_2 = nn.Dense(8, in_units=16)

            def forward(self, x):
                return self.ffn_2(self.ffn_1(x))

        net = Net()
        if torch_side:
            net.initialize(ctx=tmx.cpu())
        else:
            net.initialize(jmx.init.Xavier())
        _set_weights(net, 4, torch_side)
        return net


def _mse(out, label):
    d = out - label
    return (d * d).mean()


def _st_run(torch_side, net, mesh_axes, steps, rows, out_dim=4, **kw):
    if torch_side:
        mesh = tpar.make_mesh(mesh_axes, devices=[torch.device("cpu")])
        tr = tpar.ShardedTrainer(net, _mse, mesh, **kw)
    else:
        tr = jpar.ShardedTrainer(net, _mse, jpar.make_mesh(mesh_axes), **kw)
    # one batch, as the reference's tests train
    x, y = _batches(1, rows, seed=11, out=out_dim)[0]
    losses = [tr.step(x, y) for _ in range(steps)]
    if torch_side:
        res = {f"p:{k}": v.numpy() for k, v in tr.full_params().items()}
        for n, st in tr.full_opt_state().items():
            for j, s in enumerate(st):
                res[f"s:{n}:{j}"] = s.numpy()
    else:
        res = {f"p:{k}": onp.asarray(v) for k, v in tr.params.items()}
        for n, st in tr.opt_state.items():
            for j, s in enumerate(st):
                res[f"s:{n}:{j}"] = onp.asarray(s)
    res["losses"] = onp.asarray(losses, dtype=onp.float32)
    return res


def _st_dp8(torch_side):
    return _st_run(torch_side, _st_net(torch_side, "mlp"), {"dp": 8}, 3, 16,
                   optimizer="sgd",
                   optimizer_params={"lr": 0.1, "momentum": 0.9})


def _st_fsdp_tp(torch_side):
    mod = tsh if torch_side else jsh
    plan = mod.tensor_parallel_plan().extend(mod.fsdp_plan(min_size=1))
    return _st_run(torch_side, _TPNet.make(torch_side),
                   {"dp": 2, "fsdp": 2, "tp": 2}, 4, 8, out_dim=8,
                   plan=plan, optimizer="adam",
                   optimizer_params={"lr": 1e-2})


def _st_remat(torch_side):
    return _st_run(torch_side, _st_net(torch_side, "bn"), {"dp": 8}, 3, 16,
                   optimizer="sgd", optimizer_params={"lr": 0.05},
                   remat=True)


def _st_bf16_accum_bn(torch_side):
    cd = torch.bfloat16 if torch_side else jnp.bfloat16
    return _st_run(torch_side, _st_net(torch_side, "bn"), {"dp": 2}, 4, 16,
                   optimizer="sgd", optimizer_params={"lr": 0.05},
                   grad_accum=2, compute_dtype=cd)


# ---------------------------------------------------------------------------
# conv + batch norm through the fused routes at dp=2
# ---------------------------------------------------------------------------
ROUTES = ("plain", "conv_bn", "epilogue")
IMG = (6, 6, 8)


def _convbn_net(torch_side, route):
    g = tgluon if torch_side else jgluon
    nn = g.nn
    if route == "epilogue":
        mod = tresnet if torch_side else jresnet
        net = mod.ResNetV1(mod.BottleneckV1, [1], [8, 32], classes=4,
                           layout="NHWC", input_layout="NHWC")
    else:
        net = nn.HybridSequential()
        net.add(nn.Conv2D(16, 1, in_channels=8, layout="NHWC",
                          use_bias=False),
                nn.BatchNorm(axis=3, in_channels=16),
                nn.Activation("relu"),
                nn.Conv2D(16, 3, padding=1, in_channels=16, layout="NHWC",
                          use_bias=False),
                nn.BatchNorm(axis=3, in_channels=16),
                nn.Activation("relu"), nn.GlobalAvgPool2D(layout="NHWC"),
                nn.Flatten(), nn.Dense(4, in_units=16))
    x0 = onp.zeros((2,) + IMG, onp.float32)
    if torch_side:
        net.initialize(ctx=tmx.cpu())
        net(torch.from_numpy(x0))
    else:
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.array(x0))
    _set_weights(net, 6, torch_side)
    net.hybridize()
    return net


def _convbn_run(torch_side, route, spec="2", steps=3, rows=8):
    fused = {"MXNET_FUSED_CONV_BN": 2 if route == "conv_bn" else 0,
             "MXNET_FUSED_EPILOGUE": 2 if route == "epilogue" else 0}
    if not torch_side:
        fused = {k: 0 for k in fused}     # the same function, unfused
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1, **fused):
        net = _convbn_net(torch_side, route)
        g = tgluon if torch_side else jgluon
        tr = g.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9},
                       kvstore="tpu")
        step = tr.compile_step(net, loss_sum)
        if torch_side:
            tresnet.reset_fused_epilogue_counts()
            tbasic.reset_fused_conv_bn_counts()
        for x, y in _batches(steps, rows, seed=13, shape=IMG):
            if torch_side:
                step(torch.from_numpy(x), torch.from_numpy(y),
                     batch_size=rows)
            else:
                step(jmx.nd.array(x), jmx.nd.array(y), batch_size=rows)
            assert step.last_step_compiled, step.last_fallback_reason
        if torch_side:
            res = {f"p:{k}": v.numpy()
                   for k, v in step.full_params().items()}
            res["fused_epilogue"] = tresnet.fused_epilogue_counts()["fused"]
            c = tbasic.fused_conv_bn_counts()
            res["fused_conv_bn"] = c["1x1"] + c["kxk"]
        else:
            res = {f"p:{k}": p.data().asnumpy()
                   for k, p in net.collect_params().items()}
    return res


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["dp=4", "dp=2,fsdp=2"])
@pytest.mark.parametrize("opt", [SGD, ADAM], ids=["sgd", "adam"])
def test_kvstore_step_matches_reference(worlds, spec, opt):
    got = _part(worlds[4][0], f"{spec}|{opt[0]}")
    net, tr, _step = _step_run(False, spec, opt)
    _assert_same(got, _j_state(net, tr), what=spec)


@pytest.mark.parametrize("spec", ["dp=4", "dp=2,fsdp=2"])
def test_one_program_a_step_and_no_reshard_in_steady_state(worlds, spec):
    for rank, res in enumerate(worlds[4]):
        for opt in ("sgd", "adam"):
            got = _part(res, f"{spec}|{opt}")
            assert int(got["dispatches"]) == 4, (rank, opt)
            assert int(got["traces"]) == 1, (rank, opt)
            assert int(got["traces_after"]) == 0, (rank, opt)
            assert int(got["reshards_after"]) == 0, (rank, opt)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_every_rank_ends_in_the_same_state(worlds, n):
    """One program over the global batch: every rank's parameters,
    optimizer states, running statistics, losses and counters are rank
    0's, bitwise (the deferred-init runs start from each rank's own draws,
    which the first step replaces by rank 0's)."""
    want = worlds[n][0]
    for rank, got in enumerate(worlds[n][1:], start=1):
        assert set(got) == set(want), rank
        for k, w in want.items():
            assert onp.array_equal(got[k], w), (n, rank, k)


def test_fsdp_halves_the_bytes_per_device(worlds):
    for opt in ("sgd", "adam"):
        f = _part(worlds[4][0], f"dp=2,fsdp=2|{opt}")
        assert int(f["bytes"]) == int(f["total"]) // 2
        assert int(f["gauge"]) == int(f["bytes"])
        assert int(f["reshards"]) > 0           # the first placement
        d = _part(worlds[4][0], f"dp=4|{opt}")
        assert int(d["bytes"]) == int(d["total"])
        assert int(d["reshards"]) == 0          # replicated: nothing moved
    # momentum: one state leaf; Adam: two, each halved with its weight
    assert int(_part(worlds[4][0], "dp=2,fsdp=2|sgd")["opt_bytes"]) == \
        int(_part(worlds[4][0], "dp=2,fsdp=2|sgd")["total"]) // 2
    assert int(_part(worlds[4][0], "dp=2,fsdp=2|adam")["opt_bytes"]) == \
        int(_part(worlds[4][0], "dp=2,fsdp=2|adam")["total"])


def test_mean_loss_is_over_the_global_batch(worlds):
    net, tr, _step = _step_run(False, "dp=2,fsdp=2", SGD, loss=loss_mean)
    _assert_same(_part(worlds[4][0], "mean"), _j_state(net, tr), what="mean")


def test_accum_window_matches_the_reference(worlds):
    net, tr, _step = _step_run(False, "dp=2,fsdp=2", SGD, steps=3, accum=2)
    _assert_same(_part(worlds[4][0], "accum"), _j_state(net, tr),
                 what="accum")


def test_indivisible_batch_replicates_loudly(worlds):
    got = _part(worlds[4][0], "rows6")
    assert int(got["replicated"]) >= 3
    net, tr, _step = _quietly(_step_run, False, "dp=4", SGD, steps=3,
                              rows=6)
    _assert_same(got, _j_state(net, tr), what="rows6")


def test_tp_constraint_composes_with_fsdp(worlds):
    for rank, res in enumerate(worlds[8]):
        per = _part(res, "tp")
        assert int(per["dispatches"]) == 3, rank
        assert int(per["traces"]) == 1, rank
    got = _part(worlds[8][0], "tp")
    assert int(got["tp"]) == 2
    net, tr, _step = _step_run(False, "dp=2,fsdp=2,tp=2", SGD, steps=3,
                               rows=8, tp=True, seed=5)
    _assert_same(got, _j_state(net, tr), what="tp")


@pytest.mark.parametrize("name,fn", [("dp8", _st_dp8),
                                     ("fsdp_tp", _st_fsdp_tp),
                                     ("remat", _st_remat)])
def test_sharded_trainer_matches_reference(worlds, name, fn):
    got = _part(worlds[8][0], name)
    _assert_same(got, fn(False), what=name)


def test_sharded_trainer_bf16_accum_batchnorm_dp2(worlds):
    """bf16 compute: 1e-2 as the port's other bf16 parity tests, but 2e-2
    for the running statistics. The port rounds them to bf16 at every
    micro-batch's update, where XLA keeps the fp32 of the fused update
    (excess precision): at a variance near 0.47 one bf16 step is 0.002,
    and 8 updates drift up to 0.016 (the same at dp=1)."""
    got = _part(worlds[2][0], "bn_accum")
    want = _st_bf16_accum_bn(False)
    stats = {k: v for k, v in want.items() if "running_" in k}
    _assert_same(got, {k: v for k, v in want.items() if k not in stats},
                 tol=BF16_TOL, what="bn_accum")
    _assert_same(got, stats, tol=dict(rtol=2e-2, atol=2e-2),
                 what="bn_accum stats")
    assert got["losses"][-1] < got["losses"][0]


def test_deferred_init_starts_every_rank_from_rank0(worlds):
    """A net inferred at the first call on a dp=2 mesh: no eager first
    step of each rank's own; every step is the program, and the result is
    the plain step's from rank 0's draws."""
    for rank, res in enumerate(worlds[2]):
        assert int(res["deferred|compiled"]) == 1, rank
        assert int(res["deferred|dispatches"]) == 3, rank
        _assert_same(_part(res, "deferred"), _part(res, "deferred_plain"),
                     what=f"deferred rank {rank}")


def test_grad_req_add_raises_on_a_mesh_at_the_first_call(worlds):
    for rank, res in enumerate(worlds[2]):
        assert int(res["grad_req_add|refused"]) == 1, rank


def test_grad_req_add_raises_on_a_mesh_of_one():
    with knobs(MXNET_SPMD_MESH="1"), tmx.cpu():
        net = t_mlp()
        net.d2.bias.grad_req = "add"
        tr = tgluon.Trainer(net.collect_params(), "sgd", kvstore="tpu")
        step = tr.compile_step(net, loss_sum)
        x, y = _batches(1, 16)[0]
        with pytest.raises(tmx.base.MXNetError, match="grad_req='add'"):
            step(torch.from_numpy(x), torch.from_numpy(y), batch_size=16)


@pytest.mark.parametrize("route", ROUTES)
def test_conv_batchnorm_global_statistics_dp2(worlds, route):
    got = _part(worlds[2][0], route)
    if route == "conv_bn":
        assert int(got["fused_conv_bn"]) > 0
    if route == "epilogue":
        assert int(got["fused_epilogue"]) > 0
    want = _convbn_run(False, route)
    # the running statistics (the global batch's) and every parameter
    assert any("running_mean" in k for k in want)
    _assert_same(got, want, what=route)


# ---------------------------------------------------------------------------
# a mesh of one, in this process: bit for bit the plain steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["1", "dp=1,fsdp=1,tp=1"])
def test_mesh_of_one_kvstore_step_is_the_plain_step_bitwise(spec):
    a_net, a_tr, a_step = _step_run(True, spec, ADAM, steps=3)
    assert a_step.mesh is not None and a_step.mesh.size == 1
    b_net, b_tr, b_step = _step_run(True, spec, ADAM, steps=3,
                                    kvstore="device")
    assert b_step.mesh is None
    a, b = _t_state(a_net, a_tr, a_step), _t_state(b_net, b_tr, b_step)
    assert set(a) == set(b)
    for k in a:
        assert onp.array_equal(a[k], b[k]), k


def test_mesh_of_one_planned_sharded_trainer_is_bitwise():
    def run(plan):
        kw = {} if plan is None else {"plan": plan}
        return _st_run(True, _st_net(True, "bn"), {"dp": 1}, 3, 16,
                       optimizer="adam", optimizer_params={"lr": 1e-2},
                       **kw)

    plain = run(None)
    for plan in (tsh.fsdp_plan(min_size=1), tsh.tensor_parallel_plan()):
        got = run(plan)
        for k in plain:
            assert onp.array_equal(got[k], plain[k]), k


def test_trainer_kvstore_types():
    net = t_mlp()
    for kv in ("device", "local", None, "tpu", "nccl"):
        tgluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
    with pytest.raises(NotImplementedError, match="A9"):
        tgluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    with pytest.raises(ValueError, match="unknown kvstore"):
        tgluon.Trainer(net.collect_params(), "sgd", kvstore="nope")
    with knobs(MXNET_SPMD_MESH="auto"), tmx.cpu():
        tr = tgluon.Trainer(net.collect_params(), "sgd", kvstore="tpu")
        # auto on a world of one: the plain single-device step
        assert tr.compile_step(net, loss_sum).mesh is None


def test_kernels_refuse_a_dtensor():
    """A kernel wrapper given a DTensor raises (never a quiet gather); the
    guard knows it by its type's name, so a stand-in serves here."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    class DTensor(torch.Tensor):
        placements = ("Shard(dim=1)",)

    x = torch.zeros(8, 8).as_subclass(DTensor)
    with pytest.raises(TypeError, match="DTensor"):
        ck.matmul_stats(x, torch.zeros(8, 8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_of_one_over_nccl_on_card(cuda_device, tmp_path):
    """On the card: an NCCL world of one (a file store in the test's
    directory), a collective under capture equal to its definition, and
    the kvstore='nccl' step on MXNET_SPMD_MESH=1 bitwise the plain step,
    both captured."""
    import torch.distributed as dist
    from mxnet_tpu_torch import program_store as tps

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        t = torch.full((4,), 2.0, device=cuda_device)
        dist.all_reduce(t)                 # the communicator, eagerly
        mesh = tpar.make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
        assert mesh.device_mesh is not None
        x = torch.randn(8, 16, device=cuda_device)
        prog = tps.capture(lambda a: tpar.all_reduce(a, ("dp", "tp"),
                                                     mesh=mesh))
        prog(x.clone())
        y = torch.randn(8, 16, device=cuda_device)
        assert torch.equal(prog(y.clone()), y)

        def run(kvstore):
            with knobs(MXNET_SPMD_MESH="1"):
                net = _mlp(tgluon)
                net.initialize(ctx=tmx.gpu(0))
                _set_weights(net, 0, True)
                net.hybridize()
                tr = tgluon.Trainer(net.collect_params(), ADAM[0],
                                    dict(ADAM[1]), kvstore=kvstore)
                step = tr.compile_step(net, loss_sum)
                for bx, by in _batches(3, 16):
                    step(torch.from_numpy(bx).to(cuda_device),
                         torch.from_numpy(by).to(cuda_device),
                         batch_size=16)
                    assert step.last_step_compiled
                return step, {k: v.cpu() for k, v in
                              step.full_params().items()}

        mesh_step, a = run("nccl")
        plain_step, b = run("device")
        assert mesh_step.mesh is not None and plain_step.mesh is None
        for k in a:
            assert torch.equal(a[k], b[k]), k
    finally:
        if own:
            dist.destroy_process_group()
