"""The port's CI gates (``tools/torch_check_*.py``, ``tools/
torch_telemetry_merge.py``) on the CPU, the train step's fault sites and
span, and the fault sites the fault-site gate found untested:

- the train step's sites: a ``FaultPlan`` on ``cached_step.step`` and on
  ``trainer.step`` fails one step, fast, and training goes on (as
  ``tests/test_faults.py:608-621`` for the reference); every compiled call
  advances ``telemetry.next_step()`` and records a ``train_step.step``
  span (``Trainer.step_spans``), on the host, around the program;
- the fault-site gate over the real tree, a planted untested site, and the
  sites of ``mxnet_tpu/`` against the port's: every site of a module the
  port has ported exists in ``mxnet_tpu_torch/``; the sites whose modules
  wait are named below with their ROADMAP item;
- a ``FaultPlan`` against each site the gate found untested: the
  checkpoint write and restore, the elastic step and restore, the
  quarantine's persist and the batch placement (the recoveries of
  ``tests/test_faults.py``, ``test_preemption.py``, ``test_sentinel.py``
  and ``test_spmd_step.py``);
- the telemetry gate's static checks and its runtime checks, a planted
  raw counter, and the port's counters named beside the reference's
  (name, kind and family, where the reference has the counter);
- the dispatch-budget lanes at the reference's tiny widths, the mesh
  lanes in the gate's own gloo world of 4 (``run_mesh_world``), and a
  planted eager op in the compiled step;
- the fusion gate on the narrow ResNet, its routing against the
  reference's routing computed here, and the int8 lane;
- the merge CLI over two shards written here.

The whole ``main()`` of the dispatch-budget and telemetry gates and the
mesh lanes at the reference's 8-device shapes are ``slow``, as the
reference's full gates are.
"""
import json
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

from test_torch_package import LazyModule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import tools.torch_check_dispatch_budget as cdb  # noqa: E402
import tools.torch_check_fault_sites as cfs  # noqa: E402
import tools.torch_check_fusion_budget as cfb  # noqa: E402
import tools.torch_check_telemetry as ctel  # noqa: E402
import tools.torch_telemetry_merge as tmerge  # noqa: E402

jmx = LazyModule("mxnet_tpu")
jag = LazyModule("mxnet_tpu.autograd")
jconfig = LazyModule("mxnet_tpu.config")
jregistry = LazyModule("mxnet_tpu.ops.registry")
jtelemetry = LazyModule("mxnet_tpu.telemetry")
jvision = LazyModule("mxnet_tpu.gluon.model_zoo.vision")

CPU = "cpu"
# the reference's fault sites whose modules the port has not ported yet,
# with the ROADMAP item that ports them
WAITING_SITES = {
    "dataloader.worker": "A9a",
    "kvstore.barrier": "A9b",
    "kvstore.collective": "A9b",
    "kvstore.pull": "A9b",
    "kvstore.push": "A9b",
    "download": "A4c",
    "program_store.load": "by design: no persistent program cache",
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def no_sleep(monkeypatch):
    monkeypatch.setattr(faults, "_sleep", lambda s: None)


# ---------------------------------------------------------------------------
# the train step's fault sites and span
# ---------------------------------------------------------------------------
def _mlp_step(seed=0):
    net, trainer, loss_fn, x, y = cdb.build(CPU, seed=seed)
    return net, trainer, trainer.compile_step(net, loss_fn), x, y


def test_cached_step_site_fails_one_step_fast_then_trains():
    net, _tr, step, x, y = _mlp_step()
    step(x, y)
    w0 = net.collect_params()["d1.weight"].data().clone()
    d0 = tcs.dispatch_count()
    with faults.active(faults.FaultPlan().fail("cached_step.step",
                                               exc=faults.FatalFault)):
        with pytest.raises(faults.FatalFault):
            step(x, y)
        # failed fast: no dispatch, no update, nothing retried
        assert tcs.dispatch_count() == d0
        assert torch.equal(net.collect_params()["d1.weight"].data(), w0)
        step(x, y)                                 # plan spent: trains
    assert tcs.dispatch_count() == d0 + 1
    assert not torch.equal(net.collect_params()["d1.weight"].data(), w0)


def test_trainer_step_site_fails_one_step_fast_then_trains():
    net, trainer, loss_fn, x, y = cdb.build(CPU)
    with tag.record():
        loss = loss_fn(net, x, y)
    tag.backward(loss)
    w = net.collect_params()["d1.weight"]
    before = w.data().clone()
    with faults.active(faults.FaultPlan().fail("trainer.step",
                                               exc=faults.FatalFault)):
        with pytest.raises(faults.FatalFault):
            trainer.step(6)
        assert torch.equal(w.data(), before)
        trainer.step(6)                            # plan spent: trains
    assert not torch.allclose(before, w.data())


def test_eager_tape_of_the_compiled_step_passes_both_sites(monkeypatch):
    """``MXNET_COMPILED_STEP=0``: the step's call runs its own site and
    its eager tape ``Trainer.step``'s."""
    net, _tr, step, x, y = _mlp_step()
    with cdb.knobs(MXNET_COMPILED_STEP=0):
        plan = faults.FaultPlan().fail("trainer.step", exc=faults.FatalFault)
        with faults.active(plan):
            with pytest.raises(faults.FatalFault):
                step(x, y)
        assert step.last_fallback_reason == "MXNET_COMPILED_STEP=0"
        with faults.active(faults.FaultPlan().fail(
                "cached_step.step", after=1, exc=faults.FatalFault)):
            step(x, y)
            with pytest.raises(faults.FatalFault):
                step(x, y)


def test_step_spans_and_step_index_of_compiled_steps():
    net, trainer, step, x, y = _mlp_step()
    telemetry.set_step(None)
    telemetry.clear_spans()
    for _ in range(3):
        step(x, y)
    spans = trainer.step_spans()
    assert [s["name"] for s in spans] == ["train_step.step"] * 3
    assert [s["args"]["step"] for s in spans] == [0, 1, 2]
    assert [s["args"]["path"] for s in spans] == ["compiled"] * 3
    assert telemetry.current_step() == 2
    assert trainer.step_spans(limit=1) == spans[-1:]
    assert all(s["cat"] == "train_step" and s["dur_us"] >= 1
               for s in spans)
    with cdb.knobs(MXNET_COMPILED_STEP=0):
        step(x, y)
    assert trainer.step_spans()[-1]["args"] == {"path": "eager", "step": 3}


def test_compiled_lane_holds_with_the_sites_and_span():
    """1 dispatch, 0 captures and 0 host syncs a step: the sites, the step
    index and the span are host work outside the program."""
    row = cdb.measure_compiled(CPU)
    assert cdb.compiled_failures(row) == []
    assert (row["compiled_launches_per_step"], row["retraces_after_warm"],
            row["host_syncs_per_step"]) == (1.0, 0, 0.0)


# ---------------------------------------------------------------------------
# the fault-site gate
# ---------------------------------------------------------------------------
def test_fault_site_gate_passes_on_the_tree(capsys):
    assert cfs.main(["--device", CPU]) == 0
    assert "every one named in a test" in capsys.readouterr().out


def test_fault_site_gate_detects_an_untested_site(tmp_path, capsys):
    pkg, tests = tmp_path / "mxnet_tpu_torch", tmp_path / "tests"
    pkg.mkdir(), tests.mkdir()
    (pkg / "mod.py").write_text(
        'faults.inject("covered.site")\n'
        'faults.retry_call(fn, site="uncovered.site")\n'
        'other.inject("also.covered")\n')
    (tests / "test_torch_mod.py").write_text(
        'PLAN = "covered.site"\nSITE = \'also.covered\'\n')
    # a test file outside the port's glob covers nothing
    (tests / "test_mod.py").write_text('PLAN = "uncovered.site"\n')
    sites = cfs.collect_sites(str(pkg))
    assert set(sites) == {"covered.site", "uncovered.site", "also.covered"}
    assert sites["uncovered.site"] == {os.path.join("mxnet_tpu_torch",
                                                    "mod.py")}
    assert cfs.main(["--device", CPU, str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "'uncovered.site'" in err and "'covered.site'" not in err


def test_fault_sites_match_the_reference():
    ref = cfs.collect_sites(os.path.join(ROOT, "mxnet_tpu"))
    port = cfs.collect_sites(os.path.join(ROOT, "mxnet_tpu_torch"))
    assert set(WAITING_SITES) <= set(ref)
    missing = set(ref) - set(port) - set(WAITING_SITES)
    assert not missing, f"reference sites the port lacks: {sorted(missing)}"
    # a waiting site that the port now declares leaves the list
    assert not set(WAITING_SITES) & set(port)
    assert set(port) == set(faults.SITES)


# ---------------------------------------------------------------------------
# the sites the gate found untested
# ---------------------------------------------------------------------------
def _mgr(tmp_path, **kw):
    from mxnet_tpu_torch.parallel.elastic import CheckpointManager

    kw.setdefault("async_save", False)
    return CheckpointManager(str(tmp_path / "ckpt"), **kw)


def _host_step(state, b):
    return {"w": state["w"] + b, "i": state["i"] + 1}


def _zero():
    return {"w": onp.float32(0), "i": onp.int64(0)}


def test_checkpoint_write_site_retries(tmp_path, no_sleep):
    faults.reset()
    mgr = _mgr(tmp_path)
    with faults.active(faults.FaultPlan().fail("checkpoint.write")):
        mgr.save(1, {"w": onp.arange(3.0)})
    out, step = mgr.restore()
    assert step == 1
    onp.testing.assert_array_equal(out["w"], onp.arange(3.0))
    assert faults.counters("checkpoint.write")["retries"] == 1
    assert not [f for f in os.listdir(mgr.directory) if ".tmp" in f]
    mgr.close()


def test_checkpoint_restore_site_degrades_to_the_previous_step(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, {"w": onp.zeros(2)})
    mgr.save(2, {"w": onp.ones(2)})
    with faults.active(faults.FaultPlan().fail("checkpoint.restore")):
        out, step = mgr.restore()
    assert step == 1
    onp.testing.assert_array_equal(out["w"], onp.zeros(2))
    evs = faults.events("checkpoint.restore")
    assert evs and evs[-1]["action"] == "degrade"
    mgr.close()


def test_elastic_step_site_restores_and_replays(tmp_path):
    from mxnet_tpu_torch.parallel.elastic import run_elastic

    batches = [onp.float32(b) for b in range(1, 13)]
    mgr = _mgr(tmp_path)
    r0 = telemetry.get("elastic.restores").value
    with faults.active(faults.FaultPlan().fail("elastic.step", after=7)):
        out, steps, restarts = run_elastic(
            _host_step, _zero(), batches, mgr, save_every=4, max_restarts=2)
    assert (steps, restarts) == (12, 1)
    assert float(out["w"]) == float(sum(batches))
    assert telemetry.get("elastic.restores").value - r0 == 1
    mgr.close()


def test_elastic_restore_site_retries_the_restore(tmp_path, no_sleep):
    from mxnet_tpu_torch.parallel.elastic import run_elastic

    faults.reset()
    batches = [onp.float32(b) for b in range(1, 11)]
    mgr = _mgr(tmp_path)
    plan = faults.FaultPlan().fail("elastic.step", after=6) \
        .fail("elastic.restore")
    with faults.active(plan):
        out, steps, restarts = run_elastic(
            _host_step, _zero(), batches, mgr, save_every=3, max_restarts=2)
    assert (steps, restarts) == (10, 1)
    assert float(out["w"]) == float(sum(batches))
    assert faults.counters("elastic.restore")["retries"] == 1
    mgr.close()


def test_quarantine_persist_site_retries(tmp_path, no_sleep):
    from mxnet_tpu_torch import sentinel

    faults.reset()
    q = sentinel.Quarantine(str(tmp_path / "quarantine.json"))
    with faults.active(faults.FaultPlan().fail("sentinel.quarantine")):
        q.add_device(5, "flaky fs")
    assert faults.counters("sentinel.quarantine")["retries"] == 1
    assert sentinel.Quarantine(q.path).device_ids() == [5]
    sentinel.install_quarantine(None)


def test_batch_placement_site_retries(no_sleep):
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import spmd

    faults.reset()
    mesh = tmesh.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
    x = torch.arange(12.0).reshape(6, 2)
    with faults.active(faults.FaultPlan().fail("spmd.put", times=1)):
        out = spmd.put_batch(x, mesh)
    assert torch.equal(out, x)
    assert any(e["action"] == "retry" for e in faults.events("spmd.put"))


# ---------------------------------------------------------------------------
# the telemetry gate
# ---------------------------------------------------------------------------
def test_telemetry_gate_static_checks_on_the_tree():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    ctel.import_counter_modules()
    accessors = ctel.collect_accessors(pkg)
    assert {"trace", "dispatch", "invoke", "host_sync", "deferred_read",
            "spec_dispatch", "sync"} <= set(accessors)
    assert ctel.collect_raw_state(pkg) == []
    # a decode engine and its pool make the per-instance families
    from mxnet_tpu_torch import serving_decode as sd

    eng = sd.GenerativeEngine(sd.TinyCausalLM(vocab=17, d_model=8,
                                              n_layers=1, n_heads=2,
                                              max_seq=16),
                              pool=sd.PagePool(pages=8, page=4), max_rows=1,
                              device=CPU)
    eng.close()
    assert ctel.static_failures(ROOT) == []


@pytest.mark.parametrize("check", ["check_deterministic_snapshot",
                                   "check_chrome_trace",
                                   "check_routed_trace_ids",
                                   "check_prefix_zero_when_off"])
def test_telemetry_gate_runtime_check(check):
    assert getattr(ctel, check)(CPU) == []


def test_telemetry_gate_detects_a_raw_counter(tmp_path):
    pkg = tmp_path / "mxnet_tpu_torch"
    pkg.mkdir()
    (pkg / "rogue.py").write_text(
        "_ROGUE_COUNT = 0\n\n"
        "def rogue_count():\n    return _ROGUE_COUNT\n\n"
        "class Box:\n    def __init__(self):\n        self.hit_count = 0\n")
    raw = ctel.collect_raw_state(str(pkg))
    rel = os.path.join("mxnet_tpu_torch", "rogue.py")
    assert raw == [f"{rel}: _ROGUE_COUNT = ...",
                   f"{rel}: self.hit_count = ..."]
    acc = ctel.collect_accessors(str(pkg))
    assert acc == {"rogue": {rel}}
    assert ctel.check_registered(acc, {"some.other.counter": {}}) == \
        [f"rogue_count (declared in {rel})"]
    # a registered counter under it (or its namespace form) satisfies it
    assert ctel.check_registered(acc, {"a.rogues": {}}) == []
    assert ctel.check_registered({"spec_dispatch": {rel}},
                                 {"program_store.serving_spec.dispatches":
                                  {}}) == []
    # a registered counter no test names
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_x.py").write_text('NAMES = ["a.named"]\n')
    assert ctel.check_tested({"a.named": {}, "a.unnamed": {},
                              "fam.x0.k": {"family": "fam.x"},
                              "test.fixture": {}}, str(tests)) == \
        ["a.unnamed", "fam.x0.k (family 'fam.x')"]


# (name, kind, family) of the port's counters that no other port test names
COUNTERS = [
    ("cached_step.deferred_read", "cumulative", None),
    ("checkpoint.digest_mismatches", "cumulative", None),
    ("elastic.restores", "cumulative", None),
    ("engine.drainables", "gauge", None),
    ("ndarray.host_sync", "cumulative", None),
    ("preemption.draining", "gauge", None),
    ("preemption.notices", "cumulative", None),
    ("quantization.pallas_skipped", "cumulative", None),
    ("sentinel.late_reads", "cumulative", None),
    ("sentinel.quarantined", "gauge", None),
    ("sentinel.replica_divergence", "cumulative", None),
    ("sentinel.rollbacks", "cumulative", None),
    ("sharding.legalize_refusal", "cumulative", None),
    ("telemetry.traces_minted", "cumulative", None),
    ("transformer_lm.flash_fallback", "cumulative", None),
    ("program_store.train_step.dispatches", "cumulative",
     "program_store.namespace"),
    ("program_store.serving.traces", "cumulative",
     "program_store.namespace"),
    ("faults.gate.probe.injected", "cumulative", "faults.site"),
    ("decode.engine{}.requests", "cumulative", "decode.engine"),
    ("kv_pool{}.alloc", "cumulative", "kv_pool"),
    ("serving.engine{}.single_fallbacks", "cumulative", "serving.engine"),
]


def _port_counter(name):
    """Make the per-site and per-instance counters ``name`` stands for;
    its name in the registry."""
    if name.startswith("faults."):
        faults.counters("gate.probe")
        return name
    if name.startswith("serving.engine"):
        from mxnet_tpu_torch import serving

        eng = serving.ServingEngine(cdb.build(CPU)[0])
        eng.close()
        return eng._stats.prefix + ".single_fallbacks"
    if "{}" in name:
        from mxnet_tpu_torch import serving_decode as sd

        pool = sd.PagePool(pages=8, page=4)
        eng = sd.GenerativeEngine(sd.TinyCausalLM(vocab=17, d_model=8,
                                                  n_layers=1, n_heads=2,
                                                  max_seq=16),
                                  pool=pool, max_rows=1, device=CPU)
        eng.close()
        prefix = eng._stats.prefix if name.startswith("decode") \
            else pool._counts.prefix
        return prefix + "." + name.rsplit(".", 1)[1]
    return name


@pytest.mark.parametrize("name,kind,family", COUNTERS)
def test_port_counters_registered_as_the_reference(name, kind, family):
    """Each counter under its name, kind and family; where the reference
    declares the same counter (its per-instance families need engines of
    its own, and are held on the port's side only), the same kind and
    family there."""
    ctel.import_counter_modules()
    key = _port_counter(name)
    got = telemetry.registered()[key]
    assert (got["kind"], got.get("family")) == (kind, family)
    if "{}" in name:
        return
    import mxnet_tpu  # noqa: F401
    from mxnet_tpu import (cached_step, engine, faults as jfaults,  # noqa
                           metric, preemption, sentinel, serving_decode)
    from mxnet_tpu.contrib import quantization  # noqa: F401
    from mxnet_tpu.models import transformer_lm  # noqa: F401
    from mxnet_tpu.parallel import elastic, sharding  # noqa: F401

    jfaults.counters("gate.probe")
    ref = jtelemetry.registered()
    if key in ref:
        assert (ref[key]["kind"], ref[key].get("family")) == (kind, family)


def test_namespace_counters_move_with_their_accessors():
    from mxnet_tpu_torch import program_store as ps

    net, _tr, step, x, y = _mlp_step()
    base = telemetry.snapshot()
    t0, d0 = tcs.trace_count(), tcs.dispatch_count()
    for _ in range(3):
        step(x, y)
    d = telemetry.delta(base)
    assert d["program_store.train_step.traces"] == tcs.trace_count() - t0 \
        == 1
    assert d["program_store.train_step.dispatches"] == \
        tcs.dispatch_count() - d0 == 3
    assert ps.stats("train_step")["dispatches"] == tcs.dispatch_count()


# ---------------------------------------------------------------------------
# the dispatch-budget lanes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lane", ["compiled", "amp", "sentinel", "serving",
                                  "decode"])
def test_dispatch_lane_inside_its_budget(lane):
    measure, failures = cdb.LANES[lane]
    row = measure(CPU)
    assert failures(row) == [], row


def test_dispatch_lane_numbers():
    amp = cdb.measure_amp(CPU)
    assert (amp["host_syncs_per_step"], amp["deferred_reads_per_step"]) \
        == (1.0, 1.0)
    snt = cdb.measure_sentinel(CPU)
    assert snt["digest_reads"] == 3 and snt["fold_matches_host"]
    eager = cdb.measure_eager(CPU)
    assert eager["eager_invokes_per_step"] > 0
    assert eager["compiled_launches_per_step"] == 0


def test_dispatch_lane_fails_an_extra_eager_op(monkeypatch):
    """An operator dispatched eagerly beside the program at every step is
    what the compiled lane exists to catch."""
    from mxnet_tpu_torch import nd

    call = tcs.TrainStep.__call__

    def leaky(self, *args, **kw):
        nd.relu(nd.zeros((2,)))
        return call(self, *args, **kw)

    monkeypatch.setattr(tcs.TrainStep, "__call__", leaky)
    row = cdb.measure_compiled(CPU)
    assert row["eager_invokes_per_step"] == 2.0
    assert any("eager_invokes_per_step" in f
               for f in cdb.compiled_failures(row))


def test_mesh_lanes_in_a_world_of_4():
    """The gate's own gloo world of 4 (``run_mesh_world``, the runner
    ``--device cpu`` uses): every rank's rows inside each lane's budget,
    its placement checked."""
    ranks = cdb.run_mesh_world(4)
    assert len(ranks) == 4
    for r, rows in enumerate(ranks):
        for lane in cdb.MESH_LANES:
            row = rows[lane]
            assert cdb.placement_checked(row), (r, lane)
            assert cdb.LANES[lane][1](row) == [], (r, lane, row)
            assert row["compiled_launches_per_step"] == 1.0
            assert row["mesh_devices"] == 4
        assert rows["fsdp"]["param_bytes_frac"] == 0.5
        assert rows["fsdp"]["accum_dispatches_per_window"] \
            == rows["pp"]["accum_dispatches_per_window"] == 3.0
        assert rows["pp"]["stage_block"][0] == 1
        assert rows["moe"]["expert_block"][0] == 1


def test_mesh_lanes_as_a_mesh_of_one_skip_placement():
    for lane in cdb.MESH_LANES:
        row = cdb.LANES[lane][0](CPU, cdb.MESH_SPECS[1][lane])
        assert not cdb.placement_checked(row)
        assert cdb.LANES[lane][1](row) == [], row


def test_dispatch_gate_main_refuses_unknown_lanes():
    with pytest.raises(SystemExit):
        cdb.main(["--device", CPU, "--lanes", "compiled,nope"])


@pytest.mark.slow
def test_dispatch_gate_main_every_lane():
    assert cdb.main(["--device", CPU]) == 0


@pytest.mark.slow
def test_dispatch_gate_mesh_lanes_at_the_reference_shapes():
    """The mesh lanes in a world of 8: ``dp=8``, ``dp=4,fsdp=2``,
    ``pp=2,dp=2,fsdp=2`` and ``ep=4,dp=2``."""
    assert cdb.main(["--device", CPU, "--world", "8",
                     "--lanes", ",".join(cdb.MESH_LANES)]) == 0


@pytest.mark.slow
def test_telemetry_gate_main():
    assert ctel.main(["--device", CPU]) == 0


# ---------------------------------------------------------------------------
# the fusion gate
# ---------------------------------------------------------------------------
def _reference_routing(x):
    """The reference's sites on the narrow net, one recorded forward on
    each route: the fused epilogue op's calls and the fused conv + BN
    ops' calls, by kind."""
    from contextlib import ExitStack

    counts = {}
    for route in cfb.ROUTES:
        names = {"epilogue": ["_fused_conv1x1_bn_act"],
                 "conv_bn": ["_fused_conv1x1_bn", "_fused_convkxk_bn"],
                 "unfused": ["_fused_conv1x1_bn_act", "_fused_conv1x1_bn",
                             "_fused_convkxk_bn"]}[route]
        knobs = cfb.route_knobs(route, CPU)
        seen = dict.fromkeys(names, 0)
        with ExitStack() as stack:
            for k, v in knobs.items():
                os.environ[k] = str(v)
                jconfig.refresh(k)
                stack.callback(jconfig.refresh, k)
                stack.callback(os.environ.pop, k, None)
            for name in names:
                schema = jregistry.get_op(name)
                orig = schema.fn

                def counting(*a, _n=name, _f=orig, **kw):
                    seen[_n] += 1
                    return _f(*a, **kw)

                schema.fn = counting
                stack.callback(setattr, schema, "fn", orig)
            net = jvision.resnet.ResNetV1(
                jvision.resnet.BottleneckV1, [2, 1], [8, 32, 64],
                classes=10, layout="NHWC", input_layout="NHWC")
            net.initialize(jmx.init.Xavier())
            net(jmx.nd.array(x[:2]))
            net.hybridize()
            with jag.record():
                net(jmx.nd.array(x))
        counts[route] = seen
    return counts


def test_fusion_lane_routes_as_the_reference():
    row = cfb.measure_fused(CPU)
    assert cfb.fused_failures(row) == [], row
    x = onp.random.RandomState(0).randn(2, 16, 16, 3).astype(onp.float32)
    ref = _reference_routing(x)
    sites = row["sites"]
    assert sites["epilogue"]["epilogue"]["fused"] == \
        ref["epilogue"]["_fused_conv1x1_bn_act"] == 8
    assert sites["conv_bn"]["conv_bn"]["1x1"] == \
        ref["conv_bn"]["_fused_conv1x1_bn"] == 8
    assert sites["conv_bn"]["conv_bn"]["kxk"] == \
        ref["conv_bn"]["_fused_convkxk_bn"] == 3
    assert not any(ref["unfused"].values())
    assert cfb.expected_launches(row["expected_sites"]) == {
        "unfused": {}, "epilogue": {"matmul_stats": 8, "matmul_epilogue": 8},
        "conv_bn": {"matmul_bn_stats": 8, "convkxk_bn_stats": 3}}


def test_fusion_lane_sites_of_resnet50():
    net = tmx.gluon.model_zoo.get_model(
        "resnet50_v1", classes=1000, layout="NHWC", input_layout="NHWC",
        ctx=tmx.cpu())
    want = cfb.expected_sites(net)
    assert want["epilogue"]["epilogue"] == {"fused": 36, "refused": 0}
    assert want["conv_bn"]["conv_bn"] == {"1x1": 36, "kxk": 16, "refused": 1}
    assert cfb.expected_launches(want) == {
        "unfused": {}, "epilogue": {"matmul_stats": 36,
                                    "matmul_epilogue": 36},
        "conv_bn": {"matmul_bn_stats": 36, "convkxk_bn_stats": 16}}


def test_fusion_lane_fails_a_site_that_runs_plain(monkeypatch):
    """A bottleneck whose conv1 site runs the plain layers breaks the
    routing the net's structure asks for."""
    real = tresnet._try_fused_epilogue
    calls = {"n": 0}

    def skip_first(conv, bn, x, relu=False, residual=None):
        calls["n"] += 1
        if calls["n"] == 1:
            return None
        return real(conv, bn, x, relu=relu, residual=residual)

    monkeypatch.setattr(tresnet, "_try_fused_epilogue", skip_first)
    row = cfb.measure_fused(CPU)
    assert any(f.startswith("epilogue route: sites")
               for f in cfb.fused_failures(row))


def test_fusion_int8_lane():
    row = cfb.measure_int8(CPU)
    assert cfb.int8_failures(row) == [], row
    assert row["skips_counted"] == 1


def test_fusion_gate_main():
    assert cfb.main(["--device", CPU]) == 0


# ---------------------------------------------------------------------------
# the merge CLI
# ---------------------------------------------------------------------------
def test_merge_cli_over_two_shards(tmp_path, capsys):
    d = tmp_path / "shards"
    c = telemetry.counter("test.gate_merge", "the merge CLI's probe")
    c.reset()
    c.inc(2)
    telemetry.event("gate", "merge_cli", shard=0)
    telemetry.flush(path=str(d / "telemetry-r0-p100.jsonl"))
    c.inc(3)
    telemetry.event("gate", "merge_cli", shard=1)
    telemetry.flush(path=str(d / "telemetry-r1-p101.jsonl"))
    out, chrome = tmp_path / "merged.json", tmp_path / "trace.json"
    assert tmerge.main([str(d), "--out", str(out),
                        "--chrome", str(chrome)]) == 0
    assert "2 shard(s)" in capsys.readouterr().out
    merged = json.loads(out.read_text())
    assert len(merged["shards"]) == 2
    assert merged["counters"]["test.gate_merge"] == 2 + 5
    assert sorted(e["shard"] for e in merged["events"]
                  if e.get("name") == "merge_cli")[0].startswith("telemetry-")
    trace = json.loads(chrome.read_text())
    assert trace["traceEvents"]
    assert tmerge.main([str(d), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["counters"][
        "test.gate_merge"] == 7
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tmerge.main([str(empty)]) == 1
