"""The runtime around the port's train step on the CPU: the engine
(``bulk``, ``naive_sync``, the device prefetcher and ``waitall``), the
metrics against the reference's on the same seeded numpy inputs (device
and host accumulation), the profiler (scopes, dump, ``StepTimeline``,
``memory_summary``, the per-op record of ``invoke``), ``runtime``
features, and the telemetry flight recorder, fleet merge, report and CLI.

Mirrors ``tests/test_engine_base.py``, ``test_pipeline_engine.py`` (its
non-AMP cases), ``test_metric_scenarios.py``, ``test_metric_utils.py``,
``test_amp_profiler.py`` (its profiler cases) and ``test_telemetry*.py``.
The ``cuda``-marked test stages batches from pinned memory on the card.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine, faults, metric, profiler, runtime
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.ndarray import NDArray

from test_torch_package import LazyModule

jmx = LazyModule("mxnet_tpu")
jmetric = LazyModule("mxnet_tpu.metric")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_RTOL = 1e-6


@pytest.fixture
def cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_bulk_scope_semantics_and_size(monkeypatch, cpu):
    assert engine.set_bulk_size(7) == 15
    assert engine.set_bulk_size(15) == 7
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    a = tmx.nd.ones((4,))
    s0 = engine.sync_count()
    with engine.bulk(3):
        for _ in range(7):
            a = a + 1
    # 7 ops inside bulk(3): barriers at ops 3 and 6, plus the exit's
    assert engine.sync_count() - s0 == 3
    assert float(a.asnumpy()[0]) == 8.0
    b = a * 2                                   # outside: every op syncs
    assert engine.sync_count() - s0 == 4
    assert float(b.asnumpy()[0]) == 16.0
    assert engine.prefetch_depth() == 0


def test_prefetcher_preserves_order_no_drop_no_dup(cpu):
    src = [onp.full((2,), i, onp.float32) for i in range(40)]
    got = [int(b.asnumpy()[0]) for b in engine.prefetch(src, depth=3)]
    assert got == list(range(40))
    # tensors stay tensors, NDArrays pass through
    t = list(engine.prefetch([torch.ones(2)], depth=2, device="cpu"))
    assert isinstance(t[0], torch.Tensor)
    n = tmx.nd.ones((2,))
    assert list(engine.prefetch([n], depth=2))[0] is n


def test_prefetcher_runs_ahead_of_slow_consumer(cpu):
    pf = engine.DevicePrefetcher(
        [onp.zeros(3, onp.float32) for _ in range(12)], depth=3)
    for _ in pf:
        time.sleep(0.01)
    st = pf.stats()
    assert st["consumed"] == 12 and st["staged"] == 12
    assert st["steady_ahead"] >= 2 and st["max_ahead"] <= 3


def test_prefetch_transient_transfer_fault_retries_in_order(cpu,
                                                            monkeypatch):
    monkeypatch.setattr(faults, "_sleep", lambda s: None)
    plan = faults.FaultPlan().fail("engine.prefetch", times=2)
    with faults.active(plan):
        got = [int(b.asnumpy()[0]) for b in engine.prefetch(
            [onp.full(1, i, onp.float32) for i in range(6)], depth=2)]
    assert got == list(range(6))


def test_prefetch_source_error_delivered_in_order(cpu):
    def source():
        for i in range(3):
            yield onp.full(1, i, onp.float32)
        raise ValueError("source broke")

    seen = []
    with pytest.raises(ValueError, match="source broke"):
        for b in engine.prefetch(source(), depth=2):
            seen.append(int(b.asnumpy()[0]))
    assert seen == [0, 1, 2]


def test_prefetch_stops_staging_when_draining(cpu):
    from mxnet_tpu_torch import preemption

    gate = threading.Event()

    def source():
        for i in range(100):
            if i == 3:
                gate.wait(5)
            yield onp.full(1, i, onp.float32)

    pf = engine.prefetch(source(), depth=2)
    first = [int(next(pf).asnumpy()[0]) for _ in range(2)]
    try:
        preemption._DRAINING.set()
        gate.set()
        rest = [int(b.asnumpy()[0]) for b in pf]
    finally:
        preemption.reset()
    assert first == [0, 1] and len(rest) < 98


def test_naive_engine_forces_synchronous_prefetch(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    pf = engine.prefetch([onp.zeros(1, onp.float32)] * 3, depth=4)
    assert not isinstance(pf, engine.DevicePrefetcher)
    assert len(list(pf)) == 3


def test_prefetch_bucket_pads_batch_axis(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "4,8")
    out = list(engine.prefetch([onp.ones((3, 2), onp.float32),
                                onp.ones((5, 2), onp.float32)],
                               depth=2, bucket=True))
    assert [tuple(o.shape) for o in out] == [(4, 2), (8, 2)]
    assert float(out[0].asnumpy()[3].sum()) == 0.0


def test_prefetch_sharding_places_rows_on_mesh_of_one(cpu):
    from mxnet_tpu_torch.parallel import make_mesh, spmd

    mesh = make_mesh({"dp": 1}, devices=[torch.device("cpu")])
    out = list(engine.prefetch([onp.arange(8, dtype=onp.float32)], depth=2,
                               sharding=spmd.batch_sharding(mesh),
                               device="cpu"))
    assert isinstance(out[0], NDArray)
    assert out[0].asnumpy().tolist() == list(range(8))


def test_waitall_drains_registered_objects(cpu):
    class Pending:
        drained = 0

        def drain(self):
            Pending.drained += 1

    p = engine.register_drainable(Pending())
    n = engine.drainable_count()
    engine.waitall()
    assert Pending.drained == 1 and n >= 1
    del p


@pytest.mark.cuda
def test_prefetch_stages_pinned_batches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = [torch.full((256, 256), float(i)).pin_memory() for i in range(8)]
    s0 = engine.sync_count()
    pf = engine.prefetch(src, depth=2)
    outs = [t * 2 for t in pf]
    assert engine.sync_count() == s0
    torch.cuda.synchronize()
    assert [float(o[0, 0]) for o in outs] == [2.0 * i for i in range(8)]


# ---------------------------------------------------------------------------
# metrics against the reference
# ---------------------------------------------------------------------------

def _cls_inputs(rng, n=16, k=5):
    return (rng.randint(0, k, (n,)).astype(onp.float32),
            rng.dirichlet(onp.ones(k), n).astype(onp.float32))


def _bin_inputs(rng, n=32):
    return (rng.randint(0, 2, (n,)).astype(onp.float32),
            rng.dirichlet(onp.ones(2), n).astype(onp.float32))


def _reg_inputs(rng, n=12):
    return (rng.randn(n, 3).astype(onp.float32),
            rng.randn(n, 3).astype(onp.float32))


METRICS = [
    # (name, constructor kwargs, inputs, exact)
    ("acc", {}, _cls_inputs, True),
    ("top_k_accuracy", {"top_k": 3}, _cls_inputs, True),
    ("binary_accuracy", {}, lambda r: (r.randint(0, 2, 20).astype(
        onp.float32), r.rand(20).astype(onp.float32)), True),
    ("f1", {}, _bin_inputs, True),
    ("fbeta", {"beta": 2}, _bin_inputs, False),
    ("mcc", {}, _bin_inputs, False),
    ("perplexity", {}, _cls_inputs, False),
    ("perplexity", {"ignore_label": 2}, _cls_inputs, False),
    ("mae", {}, _reg_inputs, False),
    ("mse", {}, _reg_inputs, False),
    ("rmse", {}, _reg_inputs, False),
    ("ce", {}, _cls_inputs, False),
    ("nll_loss", {}, _cls_inputs, False),
    ("pearsonr", {}, _reg_inputs, False),
    ("pcc", {}, _cls_inputs, False),
    ("loss", {}, lambda r: (None, r.rand(9).astype(onp.float32)), False),
    ("cos_sim", {}, _reg_inputs, False),
    ("pdist", {}, _reg_inputs, False),
]


def _feed(m, label, pred, wrap):
    if label is None:
        m.update(None, [wrap(pred)])
    else:
        m.update([wrap(label)], [wrap(pred)])


@pytest.mark.parametrize("name,kw,make,exact", METRICS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(METRICS)])
def test_metric_matches_reference(name, kw, make, exact, monkeypatch, cpu):
    rng = onp.random.RandomState(7)
    batches = [make(rng) for _ in range(4)]
    ref = jmetric.create(name, **kw)
    dev, host = metric.create(name, **kw), metric.create(name, **kw)
    for label, pred in batches:
        _feed(ref, label, pred, jmx.nd.array)
        _feed(dev, label, pred, torch.from_numpy)
    monkeypatch.setenv("MXNET_METRIC_DEVICE", "0")
    for label, pred in batches:
        _feed(host, label, pred, torch.from_numpy)
    (rn, rv), (dn, dv), (hn, hv) = ref.get(), dev.get(), host.get()
    assert rn == dn == hn
    if exact:
        assert dv == rv == hv
    else:
        assert dv == pytest.approx(rv, rel=METRIC_RTOL)
        assert hv == pytest.approx(rv, rel=METRIC_RTOL)
    assert dev.num_inst == host.num_inst


def test_device_accumulator_defers_host_reads(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_METRIC_DEVICE", "1")
    dev = metric.Accuracy()
    rng = onp.random.RandomState(5)
    h0 = metric.host_sync_count()
    for _ in range(4):
        label, pred = _cls_inputs(rng)
        dev.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
    assert metric.host_sync_count() == h0 and dev._dev_pending == 4
    dev.get()
    assert dev._dev_pending == 0 and metric.host_sync_count() == h0


def test_metric_sync_steps_bounds_the_queue(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_METRIC_DEVICE", "1")
    monkeypatch.setenv("MXNET_METRIC_SYNC_STEPS", "3")
    m = metric.Loss()
    pred = tmx.nd.array(onp.ones(4, onp.float32))
    for _ in range(7):
        m.update(0, pred)
    assert m._dev_pending == 1
    assert m.get()[1] == pytest.approx(1.0)


def test_waitall_drains_metric_accumulators(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_METRIC_DEVICE", "1")
    m = metric.Accuracy()
    m.update([tmx.nd.array([1, 1])],
             [tmx.nd.array([[0.0, 1.0], [1.0, 0.0]])])
    assert m._dev_pending == 1
    engine.waitall()
    assert m._dev_pending == 0
    assert m.sum_metric == 1.0 and m.num_inst == 2


def test_metric_reset_drops_pending_device_batches(monkeypatch, cpu):
    monkeypatch.setenv("MXNET_METRIC_DEVICE", "1")
    m = metric.Loss()
    m.update(0, tmx.nd.array(onp.full(4, 9.0, onp.float32)))
    m.reset()
    m.update(0, tmx.nd.array(onp.full(4, 2.0, onp.float32)))
    assert m.get()[1] == pytest.approx(2.0)


def test_host_only_metric_counts_syncs_loudly(cpu):
    m = metric.F1()
    h0 = metric.host_sync_count()
    m.update([tmx.nd.array([1, 0, 1, 1])],
             [tmx.nd.array([[0.1, 0.9], [0.8, 0.2], [0.2, 0.8],
                            [0.3, 0.7]])])
    assert metric.host_sync_count() > h0


def test_metric_scenarios(cpu):
    acc = metric.Accuracy()
    acc.update([torch.tensor([1.0, 0.0])],
               [torch.tensor([[0.2, 0.8], [0.9, 0.1]])])
    assert acc.get()[1] == 1.0
    ce = metric.create("ce")
    ce.update([torch.tensor([0.0, 1.0])],
              [torch.tensor([[0.5, 0.5], [0.25, 0.75]])])
    assert ce.get()[1] == pytest.approx(
        -(onp.log(0.5) + onp.log(0.75)) / 2, rel=1e-6)
    loss = metric.Loss()
    loss.update(None, torch.tensor([1.0, 3.0]))
    loss.update(None, torch.tensor([5.0]))
    assert loss.get()[1] == pytest.approx(3.0)
    comp = metric.create(["acc", "mse",
                          lambda l, p: float((l == p.argmax(-1)).mean())])
    assert isinstance(comp, metric.CompositeEvalMetric)
    comp.update([torch.tensor([1.0, 0.0])],
                [torch.tensor([[0.2, 0.8], [0.9, 0.1]])])
    names, values = comp.get()
    assert names[0] == "accuracy" and names[2].startswith("custom(")
    npm = metric.np(lambda l, p: 0.5, name="half")
    npm.update([onp.zeros(2)], [onp.zeros(2)])
    assert npm.get() == ("custom(half)", 0.5)
    with pytest.raises(ValueError):
        metric.create("no_such_metric")


# ---------------------------------------------------------------------------
# the profiler, runtime features
# ---------------------------------------------------------------------------

def test_profiler_scopes_and_dump(tmp_path, cpu):
    fn = str(tmp_path / "trace.json")
    profiler.set_config(filename=fn)
    profiler.set_state("run")
    try:
        with profiler.Task("stepA"):
            tmx.nd.ones((8, 8)) + 1
        with profiler.Frame("frameB"):
            pass
        cnt = profiler.Counter("imgs")
        cnt.set_value(5)
        cnt += 3
        profiler.Marker("mark").mark()
        profiler.pause()
        with profiler.Task("ignored"):
            pass
        profiler.resume()
        table = profiler.dumps()
        assert "stepA" in table
    finally:
        profiler.set_state("stop")
    with open(profiler.dump()) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"stepA", "frameB", "imgs", "mark"} <= names
    assert "ignored" not in names
    # the per-op record of ndarray.invoke
    assert "_plus_scalar" in names or any(
        e.get("cat") == "operator" for e in trace["traceEvents"])
    assert telemetry.get("profiler.imgs").value == 8


def test_profiler_device_trace_session(tmp_path, cpu):
    profiler.set_config(device_trace_dir=str(tmp_path / "dev"))
    try:
        profiler.set_state("run")
        tmx.nd.ones((4, 4)) * 3
        profiler.set_state("stop")
    finally:
        profiler.set_config(device_trace_dir=None)
    assert os.listdir(str(tmp_path / "dev"))
    assert profiler.device_events() == []      # no CUDA kernels here


def test_step_timeline_phases_and_idle_gap():
    tl = profiler.StepTimeline("t")
    for _ in range(3):
        with tl.phase("h2d"):
            time.sleep(0.002)
        with tl.phase("dispatch"):
            time.sleep(0.004)
        with tl.phase("read"):
            time.sleep(0.001)
        tl.step()
    s = tl.summary()
    assert s["steps"] == 3
    per = s["phase_us_per_step"]
    assert per["h2d"] >= 1500 and per["dispatch"] >= 3000
    assert s["device_idle_gap_us"] == pytest.approx(
        sum(v for k, v in per.items() if k != "dispatch"), rel=0.01)
    assert s["wall_us_per_step"] >= s["device_idle_gap_us"]
    assert any(sp["cat"] == "step_phase" and sp["name"] == "t:dispatch"
               for sp in telemetry.spans())


def test_memory_summary_attributes_params(cpu):
    net = tmx.gluon.nn.Dense(8)
    net.initialize(ctx=tmx.cpu())
    net(torch.ones(2, 4))
    s = profiler.memory_summary(net)
    assert "weight" in s and "bias" in s and "TOTAL" in s


def test_runtime_features():
    feats = runtime.feature_list()
    names = {f.name for f in feats}
    assert {"CPU", "BF16", "CUDA", "NCCL", "NVCC", "TRITON",
            "SM_90A"} <= names
    fs = runtime.Features()
    assert fs.is_enabled("cpu") and not fs.is_enabled("XLA")
    assert fs.is_enabled("CUDA") == torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        fs.is_enabled("NOT_A_FEATURE")


# ---------------------------------------------------------------------------
# the telemetry flight recorder, merge, report, CLI
# ---------------------------------------------------------------------------

def test_flight_recorder_flushed_by_waitall(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_DIR", str(tmp_path))
    telemetry.event("unit", "flight", value=1)
    engine.waitall()
    path = telemetry.flight_recorder_path()
    assert os.path.basename(path) == f"telemetry-r0-p{os.getpid()}.jsonl"
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["kind"] == "meta" and lines[-1]["kind"] == "snapshot"
    assert any(r.get("kind") == "unit" for r in lines)
    monkeypatch.delenv("MXNET_TELEMETRY_DIR")
    assert telemetry.flush() is None            # off by default


def _shard(d, rank, pid, counters, kinds, events=()):
    with open(os.path.join(d, f"telemetry-r{rank}-p{pid}.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "meta", "pid": pid, "rank": rank,
                            "counter_kinds": kinds}) + "\n")
        for e in events:
            f.write(json.dumps(e) + "\n")
        f.write(json.dumps({"kind": "snapshot", "counters": counters})
                + "\n")


def test_merge_sums_cumulative_keeps_gauges_and_skips_torn(tmp_path):
    d = str(tmp_path)
    kinds = {"a.c": "cumulative", "a.g": "gauge", "a.t": "time"}
    _shard(d, 0, 11, {"a.c": 2, "a.g": 5, "a.t": 0.5}, kinds,
           [{"kind": "drain", "name": "x", "t_us": 2, "seq": 1}])
    _shard(d, 1, 12, {"a.c": 3, "a.g": 7, "a.t": 0.25}, kinds,
           [{"kind": "drain", "name": "y", "t_us": 1, "seq": 1}])
    with open(os.path.join(d, "telemetry-r2-p13.jsonl"), "w") as f:
        f.write('{"kind": "meta", "pid": 13}\n{"torn":')
    open(os.path.join(d, "telemetry-r3-p14.jsonl.tmp.14"), "w").close()
    m = telemetry.merge(d)
    assert m["counters"]["a.c"] == 5 and m["counters"]["a.t"] == 0.75
    assert m["gauges"]["a.g"] == {"telemetry-r0-p11.jsonl": 5,
                                  "telemetry-r1-p12.jsonl": 7}
    assert [e["name"] for e in m["events"]] == ["y", "x"]
    assert m["skipped_lines"] == 1 and len(m["shards"]) == 3
    trace = telemetry.merge_chrome_trace(d, m)
    assert sum(e["ph"] == "M" for e in trace["traceEvents"]) == 3
    assert "a.c" in telemetry._merged_report(m)


def test_rotation_deletes_oldest_shards(tmp_path, monkeypatch):
    d = str(tmp_path)
    for i in range(4):
        p = os.path.join(d, f"telemetry-r0-p{100 + i}.jsonl")
        with open(p, "w") as f:
            f.write("x" * 400_000)
        os.utime(p, (i, i))
    monkeypatch.setenv("MXNET_TELEMETRY_MAX_MB", "1")
    monkeypatch.setenv("MXNET_TELEMETRY_DIR", d)
    r0 = telemetry.get("telemetry.shards_rotated").value
    own = telemetry.flush()
    left = sorted(os.listdir(d))
    assert os.path.basename(own) in left
    assert "telemetry-r0-p100.jsonl" not in left
    assert telemetry.get("telemetry.shards_rotated").value > r0


def test_report_and_cli(tmp_path):
    telemetry.counter("unit.report_probe", "probe").inc(3)
    assert "unit.report_probe" in telemetry.report(prefix="unit.")
    d = str(tmp_path)
    _shard(d, 0, 21, {"elastic.recovery_s": 1.5},
           {"elastic.recovery_s": "time"})
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.telemetry", "merge", d,
         "--chrome", os.path.join(d, "chrome.json")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "elastic.recovery_s" in out.stdout
    assert json.load(open(os.path.join(d, "chrome.json")))["traceEvents"]
    assert telemetry.main(["report", "--dir", d]) == 0
    assert telemetry.main(["trace", "no-such-trace", "--dir", d]) == 1
