"""The AMP gate of the port's compiled step (``cached_step.TrainStep`` with
a ``LossScaler``) held to itself and to the JAX package's on the CPU.

- The reference's ``tests/test_pipeline_engine.py:185-260`` and
  ``tests/test_cached_step.py:201-225`` scenarios: ``MXNET_AMP_LAG=1``
  bitwise ``MXNET_AMP_LAG=0`` (parameters, momenta, scale, clean-step
  count) for overflows at no step, step 2 and steps 0 and 3, with a scale
  window that grows the scale mid-run, each run also held to the
  reference's (scales equal, parameters within fp32 ``1e-5``); the
  rollback across the lag window at ``engine.waitall``; one deferred host
  read a step and none without a scaler; an overflow skipped on the
  device with one dispatch; the eager tape AMP-equivalent to the compiled
  step; accumulation windows holding one pair of candidates.
- A narrow NHWC bottleneck ResNet (``test_torch_gluon_resnet._narrow_pair``)
  through ``compile_step`` with both fused routes forced on the CPU
  (``MXNET_FUSED_CONV_BN=2`` / ``MXNET_FUSED_EPILOGUE=2``), SGD momentum at
  lr 0.01, against the reference's same steps: fp16 AMP (scale 2^16, which
  overflows this net's first four steps, then an overflow forced at step
  5) and bf16 AMP, the reference's weights drawn from its seed 0. Bounds,
  on the relative L2 distance of all trainable parameters after the steps:
  fp16 ``2e-2``, bf16 ``4e-2`` (twice the largest of the reference's seeds
  0-7: 1.03e-2 and 2.13e-2), with the scale trajectories equal and the
  fused sites counted equal. (At lr 0.1 the
  two packages' 16-bit backward of the fused batch norm, which rounds the
  statistics' cotangents in different places, separates the trajectories
  by 5e-2 (fp16) and 0.13 (bf16) after the same steps: the fused 16-bit
  weight gradients of one step differ by 6% (fp16) and 26% (bf16) between
  the packages, each about as far from its own fp32 gradient; unfused,
  0.1%.)
- The mesh form: the reference's ``test_fsdp_step.py:432-444``
  (``test_accum_amp_window_scale_consistent``) in a gloo world of 4
  (``dp=2,fsdp=2``) against the same steps without a mesh.
- The quarantined rank, in the same world: with rank 1 quarantined,
  ``make_mesh`` and ``auto_mesh`` give a mesh of ranks 0, 2 and 3 whose
  collectives run without rank 1, which raises; every rank quarantined is
  ignored with a warning.
"""
import contextlib
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ndarray import ndarray as tnd

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jmx = LazyModule("mxnet_tpu")
jamp = LazyModule("mxnet_tpu.amp")
jengine = LazyModule("mxnet_tpu.engine")
jconfig = LazyModule("mxnet_tpu.config")
jgluon = LazyModule("mxnet_tpu.gluon")
get_op = LazyModule("mxnet_tpu.ops.registry", "get_op")

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# measured over the reference's seeds 0-7 (its Xavier draws), conv + BN
# route: fp16 5e-4 to 1.03e-2, bf16 1.21e-2 to 2.13e-2; epilogue route:
# fp16 2.5e-4 to 3.0e-3, bf16 9.8e-3 to 1.87e-2; the bound is twice the
# largest
RESNET_BOUND = {"float16": 2e-2, "bfloat16": 4e-2}
RESNET_SEED = 0


@contextlib.contextmanager
def knobs(**env):
    """Environment knobs for both packages, refreshed, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    for k in env:
        tconfig.refresh(k) if k in tconfig.VARIABLES else None
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
            if k in tconfig.VARIABLES:
                tconfig.refresh(k)


# ---------------------------------------------------------------------------
# the MLP scenarios
# ---------------------------------------------------------------------------
def _weights(net, seed, torch_side):
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        w = (rng.randn(*p.shape) * 0.1).astype(onp.float32)
        p.set_data(torch.from_numpy(w) if torch_side else jmx.nd.array(w))


def _mlp(torch_side, seed=0):
    g = tgluon if torch_side else jgluon
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(16, in_units=8, activation="relu"),
            g.nn.Dense(4, in_units=16))
    if torch_side:
        net.initialize(ctx=tmx.cpu())
    else:
        net.initialize(jmx.init.Xavier())
    _weights(net, seed, torch_side)
    net.hybridize()
    return net


def loss_mean(net, x, y):
    return ((net(x) - y) ** 2).mean()


def loss_sum(net, x, y):
    return ((net(x) - y) ** 2).sum()


def _batches(n, seed=3, overflow_at=(), rows=6):
    rng = onp.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.randn(rows, 8).astype(onp.float32)
        y = rng.randn(rows, 4).astype(onp.float32)
        if i in overflow_at:
            y = onp.full_like(y, 3e38)   # the scaled gradient overflows
        out.append((x, y))
    return out


def _train(torch_side, lag, overflow_at=(), steps=6, window=3, accum=1,
           loss=loss_mean, scale=8.0, eager=False):
    """``steps`` windows under a LossScaler(scale, window); returns (net,
    trainer, step, the scale after each call)."""
    env = {"MXNET_AMP_LAG": lag, "MXNET_COMPILED_STEP": int(not eager)}
    with knobs(**env), (tmx.cpu() if torch_side
                        else contextlib.nullcontext()):
        net = _mlp(torch_side)
        g, a = (tgluon, tamp) if torch_side else (jgluon, jamp)
        tr = g.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
        tr._amp_loss_scaler = a.LossScaler(init_scale=scale,
                                           scale_window=window)
        step = tr.compile_step(net, loss, accum_steps=accum)
        scales = []
        for x, y in _batches(steps * accum, overflow_at=overflow_at):
            if torch_side:
                step(torch.from_numpy(x), torch.from_numpy(y), batch_size=6)
            else:
                step(jmx.nd.array(x), jmx.nd.array(y), batch_size=6)
            scales.append(tr._amp_loss_scaler.loss_scale)
        (tengine if torch_side else jengine).waitall()
    return net, tr, step, scales


def _t_state(net, tr):
    out = {k: p.data().clone() for k, p in net.collect_params().items()}
    for i, s in enumerate(tr._init_states()):
        out[f"state{i}"] = s.clone()
    return out


def _j_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("overflow_at", [(), (2,), (0, 3)])
def test_deferred_gate_bitwise_and_against_reference(overflow_at):
    net0, tr0, step0, sc0 = _train(True, 0, overflow_at)
    net1, tr1, step1, sc1 = _train(True, 1, overflow_at)
    assert step0.last_step_compiled and step1.last_step_compiled
    s0, s1 = _t_state(net0, tr0), _t_state(net1, tr1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    a0, a1 = tr0._amp_loss_scaler, tr1._amp_loss_scaler
    assert (a0.loss_scale, a0._unskipped) == (a1.loss_scale, a1._unskipped)
    jnet, jtr, _js, jsc = _train(False, 0, overflow_at)
    assert sc0 == jsc
    assert a0.loss_scale == jtr._amp_loss_scaler.loss_scale
    jp = _j_params(jnet)
    for k, p in net0.collect_params().items():
        onp.testing.assert_allclose(p.data().numpy(), jp[k], err_msg=k,
                                    **STEP_TOL)


def test_scale_grows_mid_run_under_both_lags():
    """scale_window 3 with no overflow: the scale doubles twice in six
    steps, the lagged run a step later on the host, equal after waitall."""
    _n, tr0, _s, sc0 = _train(True, 0)
    _n, tr1, _s, sc1 = _train(True, 1)
    assert sc0 == [8.0, 8.0, 16.0, 16.0, 16.0, 32.0]
    assert sc1 == [8.0, 8.0, 8.0, 16.0, 16.0, 16.0]
    assert tr0._amp_loss_scaler.loss_scale == \
        tr1._amp_loss_scaler.loss_scale == 32.0


def test_rollback_across_the_lag_window():
    with knobs(MXNET_AMP_LAG=1), tmx.cpu():
        net = _mlp(True)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
        tr._amp_loss_scaler = tamp.LossScaler(init_scale=8.0)
        step = tr.compile_step(net, loss_mean)
        for x, y in _batches(3):
            step(torch.from_numpy(x), torch.from_numpy(y), batch_size=6)
        tengine.waitall()
        before = {k: p.data().clone() for k, p in
                  net.collect_params().items()}
        (x, y), = _batches(1, overflow_at=(0,))
        events0 = len(tmx.telemetry.events("amp_overflow"))
        step(torch.from_numpy(x), torch.from_numpy(y), batch_size=6)
        # the flag is unread: the host's scale has not moved
        assert tr._amp_loss_scaler.loss_scale == 8.0
        # ...but the device skipped the update already
        for k, p in net.collect_params().items():
            assert torch.equal(p.data(), before[k]), k
        tengine.waitall()
        assert tr._amp_loss_scaler.loss_scale == 4.0
        assert len(tmx.telemetry.events("amp_overflow")) == events0 + 1


def test_deferred_reads_and_host_sync_budget():
    with knobs(MXNET_AMP_LAG=1), tmx.cpu():
        batches = _batches(6)
        for scaler in (None, 8.0):
            net = _mlp(True)
            tr = tgluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
            if scaler:
                tr._amp_loss_scaler = tamp.LossScaler(init_scale=scaler)
            step = tr.compile_step(net, loss_mean)
            x0, y0 = batches[0]
            step(torch.from_numpy(x0), torch.from_numpy(y0), batch_size=6)
            h0, r0 = tnd.host_sync_count(), tcs.deferred_read_count()
            d0 = tcs.dispatch_count()
            for x, y in batches[1:]:
                step(torch.from_numpy(x), torch.from_numpy(y), batch_size=6)
            syncs = tnd.host_sync_count() - h0
            reads = tcs.deferred_read_count() - r0
            assert tcs.dispatch_count() - d0 == len(batches) - 1
            want = 0 if scaler is None else len(batches) - 1
            assert syncs == reads == want
            tengine.waitall()


def test_overflow_skipped_on_device_with_one_dispatch():
    with tmx.cpu():
        net = _mlp(True, 3)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        tr._amp_loss_scaler = tamp.LossScaler(init_scale=8.0)
        step = tr.compile_step(
            net, lambda n, x, y: ((n(x) * 1e30) * 1e30).mean())
        x, y = (torch.from_numpy(a) for a in _batches(1)[0])
        step(x, y, batch_size=6)              # captures (overflows already)
        before = {k: p.data().clone() for k, p in
                  net.collect_params().items()}
        scale = tr._amp_loss_scaler.loss_scale
        d0 = tcs.dispatch_count()
        step(x, y, batch_size=6)
        assert step.last_step_compiled
        assert tcs.dispatch_count() - d0 == 1
        for k, p in net.collect_params().items():
            assert torch.equal(p.data(), before[k]), k
        assert tr._amp_loss_scaler.loss_scale == scale / 2
        tengine.waitall()


def test_eager_tape_is_amp_equivalent():
    net_c, tr_c, _s, sc_c = _train(True, 0, (2,))
    net_e, tr_e, step_e, sc_e = _train(True, 0, (2,), eager=True)
    assert step_e.last_fallback_reason == "MXNET_COMPILED_STEP=0"
    assert sc_c == sc_e
    for k, p in net_c.collect_params().items():
        onp.testing.assert_allclose(
            p.data().numpy(), net_e.collect_params()[k].data().numpy(),
            err_msg=k, **STEP_TOL)


@pytest.mark.parametrize("overflow_at", [(), (1,), (2, 3)])
def test_accumulation_window_holds_one_pair(overflow_at):
    """accum_steps=2: lag 1 bitwise lag 0 and the reference's scales."""
    n0, tr0, _s, sc0 = _train(True, 0, overflow_at, steps=4, accum=2,
                              loss=loss_sum, window=2)
    n1, tr1, _s, sc1 = _train(True, 1, overflow_at, steps=4, accum=2,
                              loss=loss_sum, window=2)
    s0, s1 = _t_state(n0, tr0), _t_state(n1, tr1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert tr0._amp_loss_scaler.loss_scale == tr1._amp_loss_scaler.loss_scale
    jn, jtr, _s, jsc = _train(False, 0, overflow_at, steps=4, accum=2,
                              loss=loss_sum, window=2)
    assert sc0 == jsc
    jp = _j_params(jn)
    for k, p in n0.collect_params().items():
        onp.testing.assert_allclose(p.data().numpy(), jp[k], err_msg=k,
                                    **STEP_TOL)


# ---------------------------------------------------------------------------
# the narrow ResNet
# ---------------------------------------------------------------------------
@pytest.fixture
def amp_off():
    tamp.uninit()
    jamp.uninit()
    yield
    tamp.uninit()
    jamp.uninit()


_ROUTE_OPS = {"conv_bn": {"1x1": "_fused_conv1x1_bn",
                          "kxk": "_fused_convkxk_bn"},
              "epilogue": {"fused": "_fused_conv1x1_bn_act"}}


def _ref_sites(route):
    """Wrap the reference's fused ops of ``route`` to count their calls."""
    counts = dict.fromkeys(_ROUTE_OPS[route], 0)
    origs = []
    for kind, op in _ROUTE_OPS[route].items():
        schema = get_op(op)
        origs.append((schema, schema.fn))

        def counting(*a, _k=kind, _f=schema.fn, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        schema.fn = counting
    return counts, origs


@pytest.mark.parametrize("target,steps,overflow_at,route", [
    ("float16", 7, 5, "conv_bn"), ("bfloat16", 3, None, "conv_bn"),
    ("float16", 7, 5, "epilogue"), ("bfloat16", 3, None, "epilogue")])
def test_narrow_resnet_amp_steps_match_reference(amp_off, target, steps,
                                                 overflow_at, route):
    from test_torch_gluon_resnet import _narrow_pair
    knob = {"conv_bn": "MXNET_FUSED_CONV_BN",
            "epilogue": "MXNET_FUSED_EPILOGUE"}[route]
    env = {knob: 2, "MXNET_AMP_LAG": 1}
    rng = onp.random.RandomState(0)
    x = rng.randn(4, 16, 16, 3).astype(onp.float32)
    y = onp.array([3, 7, 1, 2], onp.float32)
    saved = {k: os.environ.get(k) for k in env}
    with knobs(**env):
        for k in env:
            jconfig.refresh(k)
        try:
            jmx.random.seed(RESNET_SEED)    # the reference's Xavier draws
            jnet, tnet = _narrow_pair(x)
            jnet.hybridize()
            tnet.hybridize()
            jamp.init(target)
            tamp.init(target)
            opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
            jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
            ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
            jamp.init_trainer(jtr)
            tamp.init_trainer(ttr)
            jl = jgluon.loss.SoftmaxCrossEntropyLoss()
            tl = tgluon.loss.SoftmaxCrossEntropyLoss()
            jstep = jtr.compile_step(jnet, lambda n, a, b: jl(n(a), b))
            tstep = ttr.compile_step(tnet, lambda n, a, b: tl(n(a), b))
            ref, origs = _ref_sites(route)
            tresnet.reset_fused_conv_bn_counts()
            tresnet.reset_fused_epilogue_counts()
            jscales, tscales = [], []
            try:
                for i in range(steps):
                    xi = x * (1e6 if i == overflow_at else 1)
                    jstep(jmx.nd.array(xi), jmx.nd.array(y), batch_size=4)
                    tstep(torch.from_numpy(xi), torch.from_numpy(y),
                          batch_size=4)
                    if jtr._amp_loss_scaler is not None:
                        jscales.append(jtr._amp_loss_scaler.loss_scale)
                        tscales.append(ttr._amp_loss_scaler.loss_scale)
            finally:
                for schema, fn in origs:
                    schema.fn = fn
            jengine.waitall()
            tengine.waitall()
            sites = tresnet.fused_conv_bn_counts() if route == "conv_bn" \
                else tresnet.fused_epilogue_counts()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
                jconfig.refresh(k)
    assert tstep.last_step_compiled
    # the reference counts the sites of its one trace; on the CPU the
    # port's program runs its body at every call
    assert {k: sites[k] for k in ref} == {k: steps * n
                                          for k, n in ref.items()}, ref
    assert tscales == jscales
    if target == "float16":
        final = ttr._amp_loss_scaler.loss_scale
        assert jtr._amp_loss_scaler.loss_scale == final
        # each step's verdict as the host read it one step later (lag 1)
        after = tscales[1:] + [final]
        overflow = [b < a for a, b in zip(tscales, after)]
        assert overflow[overflow_at] and not all(overflow), overflow
    jp = jnet.collect_params()
    num = den = 0.0
    moved = 0.0
    for k, p in tnet.collect_params().items():
        if "running" in k:
            continue
        a = p.data().double().numpy()
        b = jp[k].data().asnumpy().astype(onp.float64)
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
        moved = max(moved, float(onp.abs(a).max()))
    dist = (num / den) ** 0.5
    print(f"narrow ResNet {target} {route}: relative L2 {dist:.4e}, "
          f"scales {tscales}, sites {sites}")
    assert onp.isfinite(moved)
    assert dist <= RESNET_BOUND[target], (target, dist)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def _mesh_accum_amp(spec, kvstore):
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1,
               MXNET_AMP_LAG=1), tmx.cpu():
        net = _mlp(True)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore=kvstore)
        tr._amp_loss_scaler = tamp.LossScaler(init_scale=8.0, scale_window=3)
        step = tr.compile_step(net, loss_sum, accum_steps=2)
        rng = onp.random.RandomState(7)
        for i in range(3):
            x = rng.randn(16, 8).astype(onp.float32)
            y = rng.randn(16, 4).astype(onp.float32)
            if i == 1:
                y[3] = 3e38                  # one rank's rows overflow
            for m in range(2):
                sl = slice(m * 8, (m + 1) * 8)
                step(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
                     batch_size=8)
                assert step.last_step_compiled, step.last_fallback_reason
        tengine.waitall()
        out = {f"p:{k}": v.numpy() for k, v in step.full_params().items()}
    out["scale"] = onp.asarray(tr._amp_loss_scaler.loss_scale)
    out["unskipped"] = onp.asarray(tr._amp_loss_scaler._unskipped)
    return out


def w4_accum_amp():
    return _mesh_accum_amp("dp=2,fsdp=2", "tpu")


def test_accum_amp_window_scale_consistent_on_a_mesh(world4):
    """The reference's test_accum_amp_window_scale_consistent: an AMP
    accumulation window on dp=2,fsdp=2 (the all-finite flag AND-reduced
    over the mesh, so one rank's overflow skips every rank's update) against
    the same windows without a mesh."""
    ranks = [r["w4_accum_amp"] for r in world4]
    one = _mesh_accum_amp("1", "device")
    for r in ranks:
        assert float(r["scale"]) == float(one["scale"])
        assert int(r["unskipped"]) == int(one["unskipped"])
        for k, v in one.items():
            if k.startswith("p:"):
                onp.testing.assert_allclose(r[k], v, rtol=1e-4, atol=5e-6,
                                            err_msg=k)
    assert float(one["scale"]) == 4.0      # the overflow window halved it


# ---------------------------------------------------------------------------
# the quarantined rank (reference spmd.py:200-234, test_sentinel.py:362-380)
# ---------------------------------------------------------------------------
def w4_quarantine():
    """Rank 1 quarantined: make_mesh and auto_mesh build the mesh over
    ranks 0, 2 and 3, whose collectives run without rank 1; rank 1 raises
    naming the quarantine. Then every rank quarantined: ignored, loudly."""
    import warnings

    import torch.distributed as dist

    from mxnet_tpu_torch import MXNetError, sentinel, telemetry
    from mxnet_tpu_torch.parallel import collectives, mesh as pmesh, spmd

    rank = dist.get_rank()
    out = {}
    q = sentinel.install_quarantine(sentinel.Quarantine(None))
    try:
        q.add_rank(1, "suspect")
        ev0 = len(telemetry.events("corruption", "spmd.quarantine_excluded"))
        for how, make in (("make", lambda: pmesh.make_mesh({"dp": 3})),
                          ("auto", lambda: pmesh.auto_mesh())):
            try:
                m = make()
            except MXNetError as e:
                out[f"{how}_raised"] = int("quarantined" in str(e))
                continue
            out[f"{how}_ranks"] = onp.asarray(m.ranks)
            out[f"{how}_dp"] = m.shape["dp"]
            t = torch.full((2,), float(rank + 1))
            out[f"{how}_sum"] = collectives.all_reduce(t, "dp",
                                                       mesh=m).numpy()
            w = torch.full((3,), float(rank)) if rank == 0 else \
                torch.zeros(3)
            spmd.broadcast_([w], m)
            out[f"{how}_bcast"] = w.numpy()
        out["events"] = len(telemetry.events(
            "corruption", "spmd.quarantine_excluded")) - ev0
        for r in range(4):
            q.add_rank(r, "all")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = pmesh.make_mesh({"dp": 4})
        out["all_ranks"] = onp.asarray(m.ranks)
        out["all_warned"] = int(any("every rank is quarantined" in
                                    str(c.message) for c in caught))
    finally:
        sentinel.install_quarantine(None)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The file's gloo world of 4, run once for both of its scenarios."""
    return run_world(4, [f"{__name__}:w4_accum_amp",
                         f"{__name__}:w4_quarantine"],
                     tmp_path_factory.mktemp("world4"))


def test_quarantined_rank_left_out_of_the_mesh(world4):
    for rank, res in enumerate(world4):
        r = res["w4_quarantine"]
        if rank == 1:
            assert int(r["make_raised"]) == 1 and int(r["auto_raised"]) == 1
            continue
        for how in ("make", "auto"):
            assert list(r[f"{how}_ranks"]) == [0, 2, 3]
            assert int(r[f"{how}_dp"]) == 3
            # 1 + 3 + 4: rank 1's 2 is missing
            onp.testing.assert_array_equal(r[f"{how}_sum"], [8.0, 8.0])
            onp.testing.assert_array_equal(r[f"{how}_bcast"], [0.0] * 3)
        assert int(r["events"]) >= 2
    for r in (res["w4_quarantine"] for res in world4):
        assert list(r["all_ranks"]) == [0, 1, 2, 3]
        assert int(r["all_warned"]) == 1
