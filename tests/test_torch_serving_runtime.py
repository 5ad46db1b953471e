"""The runtime pieces serving stands on, in the port against the JAX
package: ``faults`` (plans, injection, the retry policy, the shared
deadline budget, the error types), ``telemetry`` (counters and their
kinds, snapshot and delta, counter groups, computed gauges, the event bus,
trace context and spans), ``preemption`` (notice, drain hooks, exit codes)
and ``engine.waitall`` (the drainable registry). Each scenario runs on both
modules, and the observable results (which invocations raise, with what
type; counters; event actions; exit codes) must be equal.

Also the program store's thread-safe captures: on the CPU, two threads
building programs at once both get correct results; on the card
(``cuda``-marked), two threads capture while a third replays, and nothing
raises.
"""
import threading
import time

import pytest
import torch

from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import preemption as tpreemption
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch import telemetry as ttelemetry

from test_torch_package import LazyModule

rfaults = LazyModule("mxnet_tpu.faults")
rpreemption = LazyModule("mxnet_tpu.preemption")
rtelemetry = LazyModule("mxnet_tpu.telemetry")
rengine = LazyModule("mxnet_tpu.engine")

JOIN_S = 60.0


def _pair():
    """(port faults, reference faults), both reset."""
    for f in (tfaults, rfaults):
        f.uninstall()
        f.reset()
    return tfaults, rfaults._target()


@pytest.fixture(autouse=True)
def _pristine():
    yield
    for f in (tfaults, rfaults):
        f.uninstall()
        f.reset()
    for p in (tpreemption, rpreemption):
        p.reset()
        p.uninstall()


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------
def _plan_trace(f, spec, site_calls):
    plan = f.FaultPlan.from_env(spec)
    out = []
    with f.active(plan):
        for site in site_calls:
            try:
                f.inject(site)
                out.append((site, None))
            except BaseException as e:
                out.append((site, type(e).__name__))
    return out, plan.sites(), f.counters()


@pytest.mark.parametrize("spec", [
    "a:2", "a@1:2:fatal,b:1:oserror", "a@3:1:timeout,a:1", "b:2:transient"])
def test_fault_plan_windows_match_reference(spec):
    t, r = _pair()
    calls = ["a", "b", "a", "a", "b", "a", "a"]
    assert _plan_trace(t, spec, calls) == _plan_trace(r, spec, calls)


def test_fault_plan_rejects_bad_spec_like_reference():
    t, r = _pair()
    for f in (t, r):
        with pytest.raises(ValueError):
            f.FaultPlan.from_env("a:1:nosuchkind")
        with pytest.raises(ValueError):
            f.FaultPlan().fail("a", times=0)


def _retry_trace(f, fails, exc, retries, monkeypatch):
    sleeps = []
    monkeypatch.setattr(f, "_sleep", sleeps.append)
    n = [0]

    def fn():
        n[0] += 1
        if n[0] <= fails:
            raise exc("boom")
        return "ok"

    try:
        res = f.retry_call(fn, site="s", retries=retries, backoff=0.1,
                           max_backoff=0.25)
    except BaseException as e:
        res = type(e).__name__
    return (res, n[0], sleeps, f.counters("s"),
            [e["action"] for e in f.events("s")])


@pytest.mark.parametrize("fails,exc_name,retries", [
    (2, "TransientFault", 3), (5, "TransientFault", 2), (1, "FatalFault", 3),
    (1, "ValueError", 3), (2, "OSError", 3)])
def test_retry_call_matches_reference(fails, exc_name, retries,
                                      monkeypatch):
    t, r = _pair()

    def exc(f):
        return getattr(f, exc_name, None) or {
            "ValueError": ValueError, "OSError": OSError}[exc_name]

    assert _retry_trace(t, fails, exc(t), retries, monkeypatch) == \
        _retry_trace(r, fails, exc(r), retries, monkeypatch)


def test_error_types_and_retryable_classes_match_reference():
    t, r = _pair()
    for name in ("FaultInjected", "TransientFault", "FatalFault",
                 "DeadlineExceeded", "ShedError"):
        assert [b.__name__ for b in getattr(t, name).__mro__] == \
            [b.__name__ for b in getattr(r, name).__mro__], name
    for make in (lambda f: f.TransientFault("x"), lambda f: f.FatalFault(),
                 lambda f: f.ShedError("x", kind="queue"),
                 lambda f: f.DeadlineExceeded(), lambda f: OSError(),
                 lambda f: TimeoutError(), lambda f: ValueError()):
        assert t.is_retryable(make(t)) == r.is_retryable(make(r))
    assert t.ShedError("x", kind="pool").kind == "pool"
    assert t.ShedError("x").kind is None


def _deadline_trace(f):
    out = [f.deadline_remaining_us() is None]
    with f.deadline_scope(10_000_000, site="outer"):
        out.append(f.deadline_site())
        with f.deadline_scope(5_000_000_000, site="inner"):
            out.append(f.deadline_site())
            out.append(0 < f.deadline_remaining_us() <= 10_000_000)
        with f.deadline_scope(1, site="tight"):
            time.sleep(0.002)
            try:
                f.retry_call(lambda: 1, site="nested")
                out.append("ran")
            except f.DeadlineExceeded as e:
                out.append(("raised", "'outer'" in str(e)))
    out.append(f.deadline_remaining_us() is None)
    return out


def test_deadline_scope_matches_reference():
    t, r = _pair()
    assert _deadline_trace(t) == _deadline_trace(r)


def test_record_event_and_reset():
    t, r = _pair()
    for f in (t, r):
        f.record_event("x.site", "fallback", ValueError("v"), requests=2)
    te, re_ = t.events("x.site"), r.events("x.site")
    assert [sorted(e) for e in te] == [sorted(e) for e in re_]
    assert te[0]["error"] == re_[0]["error"]
    t.reset()
    assert t.events() == [] and t.counters() == {}


def test_env_fault_plan_installs_at_import():
    """``MXNET_FAULT_PLAN`` installs a plan when the module is imported (a
    fresh process, as the subprocess tests it exists for)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, MXNET_FAULT_PLAN="serving.admit@1:2:fatal")
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from mxnet_tpu_torch import faults as f;"
            "print(f._PLAN.sites());"
            "f.inject('serving.admit');"
            "f.inject('serving.admit')")
    out = subprocess.run([sys.executable, "-c", code, str(root)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert "['serving.admit']" in out.stdout
    assert out.returncode != 0 and "FatalFault" in out.stderr


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def _telemetry_trace(tel, tag):
    c = tel.counter(f"test.{tag}.c", "a counter")
    g = tel.gauge(f"test.{tag}.g", "a gauge")
    tm = tel.counter(f"test.{tag}.t", "a time", kind="time")
    assert tel.counter(f"test.{tag}.c") is c          # idempotent
    with pytest.raises(ValueError):
        tel.counter(f"test.{tag}.bad", kind="nope")
    tel.gauge_fn(f"test.{tag}.fn", lambda: 7)
    base = tel.snapshot()
    c.inc(3)
    g.set(5)
    tm.set(0.25)
    grp = tel.CounterGroup(tel.instance_name(f"test.{tag}.grp"),
                           ("a", "b"), family=f"test.{tag}.grp")
    grp.inc("a", 2)
    grp["b"] = 4
    d = tel.delta(base)
    keys = sorted(k for k in d if k.startswith(f"test.{tag}."))
    snap = tel.snapshot()
    assert list(snap) == sorted(snap)                 # ordered by name
    return ([k.replace(tag, "X") for k in keys],
            {k.replace(tag, "X"): d[k] for k in keys}, dict(grp),
            tel.registered()[f"test.{tag}.t"]["kind"])


def test_counters_snapshot_delta_and_groups_match_reference():
    assert _telemetry_trace(ttelemetry, "port") == \
        _telemetry_trace(rtelemetry._target(), "ref")


def _trace_scope_trace(tel, monkeypatch, tag):
    tel.clear_events()
    out = []
    monkeypatch.setenv("MXNET_TELEMETRY_TRACE", "1")
    with tel.trace_scope() as outer:
        tid = outer.trace_id
        out.append(tel.current_trace() == tid)
        with tel.trace_scope() as inner:            # inherits
            out.append(inner.trace_id == tid)
        with tel.span(f"{tag}.work", cat="user", args={"n": 1}):
            tel.event("shed", f"{tag}.site", kind="x", step=3, reason="r")
    out.append(tel.current_trace() is None)
    with tel.trace_scope(trace_id=None):            # explicit passthrough
        out.append(tel.current_trace() is None)
    ev = tel.events(name=f"{tag}.site")[-1]
    out.append(sorted(k for k in ev if k not in ("seq",)))
    out.append((ev["x_kind"], ev["step"], ev["trace_id"] == tid,
                "parent" in ev))
    sp = [s for s in tel.spans(cat="user") if s["name"] == f"{tag}.work"][-1]
    out.append((sp["trace_id"] == tid, sp["args"], "id" in sp))
    rec = tel.trace(tid)
    out.append([r["type"] for r in rec["records"]])
    monkeypatch.setenv("MXNET_TELEMETRY_TRACE", "0")
    with tel.trace_scope() as off:
        out.append(off.trace_id)
    return out


def test_trace_context_events_and_spans_match_reference(monkeypatch):
    got = _trace_scope_trace(ttelemetry, monkeypatch, "tport")
    want = _trace_scope_trace(rtelemetry._target(), monkeypatch, "tref")
    assert got == want


def test_span_opens_a_profiler_range(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_XLA", "1")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttelemetry.span("probe", cat="serving"):
            torch.ones(2) + 1
    assert any(e.name == "serving:probe" for e in prof.events())


def test_load_gauges_are_weak_and_named_by_family():
    class Eng:
        _closed = False

        def load(self):
            return {"queue_depth": 2.0, "in_flight": 0.5,
                    "pool_pressure": 0.25}

    e = Eng()
    prefix = ttelemetry.instance_name("test.engine")
    ttelemetry.register_load_gauges(e, prefix)
    snap = ttelemetry.snapshot()
    assert snap[f"{prefix}.queue_depth"] == 2.0
    assert ttelemetry.registered()[f"{prefix}.in_flight"]["family"] == \
        "test.engine"
    e._closed = True
    assert ttelemetry.snapshot()[f"{prefix}.pool_pressure"] == 0.0


def test_legacy_counter_signature_still_works():
    c = ttelemetry.counter("test.legacy.help", "positional help text")
    c.inc()
    assert c.value >= 1 and c.doc == "positional help text"


# ---------------------------------------------------------------------------
# preemption + engine.waitall
# ---------------------------------------------------------------------------
class _Drainable:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def drain(self):
        self.log.append(("drain", self.name))


def _preemption_trace(p, f, eng_mod, fail_drain=False):
    log = []
    keep = _Drainable(log, "d")
    eng_mod.register_drainable(keep)
    codes = []
    p.install(exit_fn=codes.append, grace_s=0)
    p.on_drain(lambda: log.append(("hook", 1)))
    plan = f.FaultPlan()
    if fail_drain:
        plan.fail("preemption.drain")
    with f.active(plan):
        out = [p.draining()]
        p.notice()
        out.append(p.draining())
        p.notice()                       # a second notice exits at once
    out += [codes, [x for x in log if x in (("drain", "d"), ("hook", 1))],
            p.exit_code()]
    del keep
    return out


@pytest.mark.parametrize("fail_drain", [False, True])
def test_preemption_notice_drain_and_exit_codes_match_reference(fail_drain):
    got = _preemption_trace(tpreemption, tfaults, tengine, fail_drain)
    want = _preemption_trace(rpreemption, rfaults, rengine, fail_drain)
    assert got == want
    assert got[2] == ([1, 83] if fail_drain else [83, 83])


def test_preempted_is_a_system_exit():
    assert issubclass(tpreemption.Preempted, SystemExit)
    assert tpreemption.grace_s() == rpreemption.grace_s()


def test_waitall_drains_every_registered_object():
    log = []
    objs = [_Drainable(log, i) for i in range(3)]
    for o in objs:
        tengine.register_drainable(o)
    assert tengine.drainable_count() >= 3
    tengine.waitall()
    assert {("drain", i) for i in range(3)} <= set(log)
    n = tengine.drainable_count()
    del objs, o
    import gc
    gc.collect()
    assert tengine.drainable_count() <= n - 3        # weakly held
    assert tengine.engine_type() == rengine.engine_type()
    assert tengine.prefetch_depth() == rengine.prefetch_depth()


def test_naive_engine_forces_prefetch_depth_zero(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert tengine.is_naive() and tengine.prefetch_depth() == 0


# ---------------------------------------------------------------------------
# program store: captures from several threads
# ---------------------------------------------------------------------------
def test_two_threads_building_programs_at_once_on_cpu():
    cache = tps.scope("serving")
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def worker(k):
        try:
            x = torch.full((4, 3), float(k))
            barrier.wait()
            for i in range(20):
                out = tps.run(cache, ("thread", k, i % 2),
                              lambda: (lambda a: a * 2 + k), [x + i])
                assert torch.equal(out, (x + i) * 2 + k)
            results[k] = out
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors and set(results) == {1, 2}
    assert len(cache) == 4


def test_gc_is_held_until_the_last_capture_ends():
    import gc

    enabled = gc.isenabled()
    gc.enable()
    try:
        with tps._gc_held():
            assert not gc.isenabled()
            with tps._gc_held():
                assert not gc.isenabled()
            assert not gc.isenabled()        # the outer one still runs
        assert gc.isenabled()
    finally:
        if not enabled:
            gc.disable()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_threads_capture_while_a_third_replays(cuda_device):
    cache = tps.scope("serving")
    a = torch.randn(256, 256, device=cuda_device)
    replayed = tps.Program(cache.namespace, lambda x: x @ a + 1, [a],
                           cuda_device)
    want = a @ a + 1
    replayed(a)
    stop = threading.Event()
    errors = []

    def replayer():
        try:
            while not stop.is_set():
                out = replayed(a)
                # a stream's synchronization is safe beside a capture; a
                # device-wide one waits for the capture lock
                torch.cuda.current_stream().synchronize()
                assert torch.allclose(out, want)
                tps.synchronize()
                # a synchronizing host allocation beside the captures
                torch.empty(1 << 16, pin_memory=True)
        except BaseException as e:
            errors.append(e)

    def capturer(k):
        try:
            for i in range(6):
                x = torch.full((64, 64), float(k + i), device=cuda_device)
                prog = tps.Program(cache.namespace,
                                   lambda t, k=k: torch.relu(t) * k + t.sum(),
                                   [x], cuda_device)
                out = prog(x)
                again = prog(x)
                torch.cuda.current_stream().synchronize()
                ref = torch.relu(x) * k + x.sum()
                assert torch.allclose(out, ref) and torch.allclose(again, ref)
        except BaseException as e:
            errors.append(e)

    r = threading.Thread(target=replayer)
    caps = [threading.Thread(target=capturer, args=(k,)) for k in (1, 2)]
    r.start()
    for t in caps:
        t.start()
    for t in caps:
        t.join(timeout=JOIN_S)
    stop.set()
    r.join(timeout=JOIN_S)
    assert not r.is_alive() and not any(t.is_alive() for t in caps)
    assert not errors, errors
