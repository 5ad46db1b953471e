"""The port's replica router (``mxnet_tpu_torch/serving_router.py``) on the
CPU, against the JAX package's ``serving_router`` where the two can be held
side by side:

- ``CircuitBreaker``: the same state sequence as the reference's over 600
  seeded outcome scripts on an injected clock;
- ``FleetSupervisor.decide`` over 1200 seeded signal tables, and ``tick``'s
  cooldown and bounds over seeded (signals, clock) sequences on stub
  routers, action for action;
- ``ReplicaRouter._pick``: the same replica over 600 seeded load, affinity,
  in-flight, membership and breaker tables on stub replicas;
- failover token-exact against the reference's ``eager_generate`` on the
  reference's weights (moved over as numpy through ``convert``).

And the reference's behaviour tests (``tests/test_serving_router.py``),
each on the port's engines at the same widths: the breaker state machine,
the shared deadline budget, failover on death / wedge / injected faults,
hedging with first-wins cancellation (the loser's row retired at its next
step boundary, its pages freed), the degraded modes, deadlines through the
router, balancing and the heartbeat, one-shot ``ServingEngine`` replicas,
the drain, the dispatch-budget router and spec lanes, elastic membership
and the supervisor, cross-process replicas and the ``router.remote`` /
``router.scale`` fault sites.
"""
import functools
import threading
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import engine as _engine
from mxnet_tpu_torch import faults, preemption, serving, telemetry
from mxnet_tpu_torch import serving_decode as sd
from mxnet_tpu_torch import serving_router as sr
from mxnet_tpu_torch.convert import decode_params_from_numpy
from mxnet_tpu_torch.parallel.elastic import HeartbeatMonitor
from mxnet_tpu_torch.serving_router import (BREAKER_CLOSED,
                                            BREAKER_HALF_OPEN, BREAKER_OPEN,
                                            CircuitBreaker, ReplicaRouter)

from test_torch_package import LazyModule

rsr = LazyModule("mxnet_tpu.serving_router")
rsd = LazyModule("mxnet_tpu.serving_decode")

CPU = "cpu"
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _pristine():
    yield
    preemption.reset()
    faults.uninstall()


def tiny(seed=0, **kw):
    """Module-shared CPU model and params per (seed, config)."""
    return _tiny_cached(seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _tiny_cached(seed, kw_items):
    cfg = dict(vocab=31, d_model=16, n_layers=1, n_heads=2, max_seq=48)
    cfg.update(dict(kw_items))
    model = sd.TinyCausalLM(**cfg)
    return model, model.init_params(seed, device=CPU)


def _mk_engine(model, params, max_rows=2, warm=None, name=None):
    pool = sd.PagePool(pages=32, page=4)
    eng = sd.GenerativeEngine(model, params=params, pool=pool,
                              max_rows=max_rows, name=name, device=CPU)
    if warm:
        eng.warmup(max_len=warm)
    return eng, pool


def mk_router(n=2, seed=0, max_rows=2, warm=8, **kw):
    model, params = tiny(seed)
    engines, pools = [], []
    for i in range(n):
        eng, pool = _mk_engine(model, params, max_rows, warm, f"rep{i}")
        engines.append(eng)
        pools.append(pool)
    kw.setdefault("breaker_errs", 2)
    kw.setdefault("breaker_cooldown_s", 0.2)
    return ReplicaRouter(engines, **kw), engines, pools, model, params


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request thread hung"


# ---------------------------------------------------------------------------
# parity with the reference: breaker, supervisor, _pick
# ---------------------------------------------------------------------------
def _breaker_trace(mod, script, errs, window, cooldown):
    clock = [0.0]
    seen = []
    br = mod.CircuitBreaker(errs=errs, window=window, cooldown_s=cooldown,
                            clock=lambda: clock[0],
                            on_transition=lambda o, n, r: seen.append(
                                (o, n)))
    out = []
    for op, dt in script:
        clock[0] += dt
        if op == "ok":
            br.record_success()
        elif op == "fail":
            br.record_failure("x")
        elif op == "trip":
            br.trip("wedged")
        elif op == "allow":
            out.append(br.allow())
        out.append(br.state())
    return out, seen


def test_breaker_state_sequences_match_reference():
    rng = onp.random.RandomState(7)
    ops = ("ok", "fail", "trip", "allow", "state")
    for _ in range(600):
        errs = int(rng.randint(1, 5))
        window = int(rng.randint(1, 8))
        cooldown = float(rng.choice([0.0, 0.5, 2.0, 5.0]))
        script = [(ops[rng.choice(5, p=[0.3, 0.35, 0.05, 0.2, 0.1])],
                   float(rng.choice([0.0, 0.1, 1.0, 3.0])))
                  for _ in range(int(rng.randint(5, 40)))]
        assert _breaker_trace(sr, script, errs, window, cooldown) == \
            _breaker_trace(rsr, script, errs, window, cooldown), script


class _StubCounters(dict):
    def inc(self, key, n=1):
        self[key] = self.get(key, 0) + n


class _StubRouter:
    """What FleetSupervisor reads of its router, for both packages."""

    def __init__(self, mod, n):
        self._mod = mod
        self.name = "stub"
        self._fleet = _StubCounters()
        self._lat_request = []
        self._replicas = [self._rep(i) for i in range(n)]
        self.actions = []

    def _rep(self, i):
        class R:
            pass
        r = R()
        r.index, r.state, r.engine = i, self._mod.REPLICA_SERVING, object()
        return r

    def add_replica(self, engine, warmup_kwargs=None):
        self._replicas.append(self._rep(len(self._replicas)))
        self.actions.append("add")
        return len(self._replicas) - 1

    def drain_replica(self, index, timeout=60.0):
        self._replicas[index].state = self._mod.REPLICA_GONE
        self.actions.append(("drain", index))
        return True


def _signals(rng, n):
    return {"serving": float(n),
            "queue_per_replica": float(rng.choice(
                [0.0, 0.05, 0.1, 0.5, 0.75, 1.0, 1.5, 2.0, 10.0])),
            "pool_pressure": float(rng.choice(
                [0.0, 0.2, 0.42, 0.43, 0.5, 0.85, 0.9, 1.0])),
            "p99_s": float(rng.rand())}


def test_supervisor_decisions_match_reference():
    rng = onp.random.RandomState(11)
    for _ in range(1200):
        lo = int(rng.randint(1, 4))
        hi = lo + int(rng.randint(0, 4))
        kw = dict(enabled=True, min_replicas=lo, max_replicas=hi,
                  cooldown_s=1.0, up_queue=float(rng.choice([0.75, 1.5])),
                  down_queue=float(rng.choice([0.05, 0.1])),
                  pool_high=float(rng.choice([0.85, 0.95])))
        n = int(rng.randint(0, hi + 3))
        sig = _signals(rng, n)
        got = sr.FleetSupervisor(_StubRouter(sr, 1), lambda: None,
                                 **kw).decide(sig)
        want = rsr.FleetSupervisor(_StubRouter(rsr, 1), lambda: None,
                                   **kw).decide(sig)
        assert got == want, (kw, sig)


def test_supervisor_ticks_match_reference_cooldown_and_bounds():
    rng = onp.random.RandomState(12)
    for _ in range(60):
        kw = dict(enabled=True, min_replicas=int(rng.randint(1, 3)),
                  cooldown_s=float(rng.choice([0.0, 2.0, 10.0])),
                  up_queue=1.0, down_queue=0.1, pool_high=0.9)
        kw["max_replicas"] = kw["min_replicas"] + int(rng.randint(0, 3))
        script = [(_signals(rng, 0), float(rng.choice([0.0, 1.0, 5.0])))
                  for _ in range(25)]
        runs = []
        n0 = int(rng.randint(1, 4))
        for mod in (sr, rsr):
            router = _StubRouter(mod, n0)
            clk = [0.0]
            sup = mod.FleetSupervisor(router, lambda: object(),
                                      retire=lambda e, i: None,
                                      clock=lambda: clk[0], **kw)
            serving_now = lambda r=router, m=mod: float(sum(
                1 for x in r._replicas if x.state == m.REPLICA_SERVING))
            acts = []
            for sig, dt in script:
                clk[0] += dt
                sup.signals = lambda s=sig: dict(s, serving=serving_now())
                acts.append(sup.tick())
            runs.append((acts, router.actions))
        assert runs[0][0] == runs[1][0]
        assert runs[0][1] == runs[1][1]


class _StubEngine:
    def __init__(self, load, probe):
        self._load, self._probe = load, probe

    def generate(self, prompt, max_new_tokens=32, eos=None, sampling=None):
        raise AssertionError("never dispatched")

    def load(self):
        if self._load is None:
            raise ConnectionError("unreachable")
        return dict(self._load)

    def prefix_probe(self, prompt):
        return self._probe


def _pick_table(rng, n):
    table = []
    for _ in range(n):
        load = (None if rng.rand() < 0.05 else
                {"queue_depth": float(rng.randint(0, 4)),
                 "in_flight": float(rng.choice([0.0, 0.5, 1.0])),
                 "pool_pressure": float(rng.choice([0.0, 0.25, 0.9]))})
        table.append({
            "load": load, "probe": int(rng.randint(0, 4)),
            "in_flight": int(rng.randint(0, 3)),
            "state": str(rng.choice(["serving"] * 6 + ["joining",
                                                        "draining",
                                                        "gone"])),
            "breaker": str(rng.choice(["closed"] * 5 + ["open",
                                                        "half_open"]))})
    return table


def _pick_on(mod, table, exclude, prompt):
    router = mod.ReplicaRouter(
        [_StubEngine(t["load"], t["probe"]) for t in table],
        breaker_cooldown_s=1000.0)
    for r, t in zip(router._replicas, table):
        r.in_flight, r.state = t["in_flight"], t["state"]
        if t["breaker"] != "closed":
            r.breaker.trip("table")
        if t["breaker"] == "half_open":
            r.breaker.cooldown_s = 0.0
    got = router._pick(exclude=set(exclude), prompt=prompt)
    router.close()
    return None if got is None else got.index


def test_pick_matches_reference(monkeypatch):
    rng = onp.random.RandomState(13)
    for k in range(600):
        monkeypatch.setenv("MXNET_ROUTER_PREFIX_AFFINITY",
                           str(rng.choice([0.0, 0.5, 1.0, 2.0])))
        n = int(rng.randint(1, 6))
        table = _pick_table(rng, n)
        exclude = [i for i in range(n) if rng.rand() < 0.15]
        prompt = None if rng.rand() < 0.3 else [1, 2, 3]
        assert _pick_on(sr, table, exclude, prompt) == \
            _pick_on(rsr, table, exclude, prompt), (table, exclude, prompt)


def test_failover_token_exact_against_reference_eager_generate():
    cfg = dict(vocab=31, d_model=16, n_layers=1, n_heads=2, max_seq=48)
    rmodel = rsd.TinyCausalLM(**cfg)
    rparams = rmodel.init_params(3)
    params = decode_params_from_numpy(
        {"emb": onp.asarray(rparams["emb"]),
         "pos": onp.asarray(rparams["pos"]),
         "out": onp.asarray(rparams["out"]),
         "layers": [{k: onp.asarray(v) for k, v in lp.items()}
                    for lp in rparams["layers"]]}, device=CPU)
    model = sd.TinyCausalLM(**cfg)
    engines = [_mk_engine(model, params, warm=8, name=f"ref{i}")[0]
               for i in range(2)]
    router = ReplicaRouter(engines, breaker_errs=2)

    def boom(*a, **kw):
        raise RuntimeError("replica 0 died")

    engines[0]._call = boom
    prompts = [[1 + i, 2 + i, 3 + i, 4] for i in range(5)]
    outs = [router.generate(p, max_new_tokens=6) for p in prompts]
    for p, o in zip(prompts, outs):
        assert o == rsd.eager_generate(rmodel, rparams, p, 6)
    assert router.stats()["failovers"] >= 1
    _engine.waitall()
    assert engines[1].pool_in_use() == 0


# ---------------------------------------------------------------------------
# 1. circuit-breaker state machine (injectable clock, no waiting)
# ---------------------------------------------------------------------------
def test_breaker_state_machine():
    clock = [0.0]
    transitions = []
    br = CircuitBreaker(errs=2, window=4, cooldown_s=5.0,
                        clock=lambda: clock[0],
                        on_transition=lambda o, n, r: transitions.append(
                            (o, n)))
    assert br.state() == BREAKER_CLOSED and br.allow()
    br.record_failure("e1")
    assert br.state() == BREAKER_CLOSED
    br.record_failure("e2")
    assert br.state() == BREAKER_OPEN
    assert not br.allow()
    clock[0] = 4.9
    assert br.state() == BREAKER_OPEN
    clock[0] = 5.0
    assert br.state() == BREAKER_HALF_OPEN
    assert br.allow()
    assert not br.allow()
    br.record_failure("probe died")
    assert br.state() == BREAKER_OPEN
    clock[0] = 10.0
    assert br.state() == BREAKER_HALF_OPEN
    assert br.allow()
    br.record_success()
    assert br.state() == BREAKER_CLOSED
    br.record_failure("fresh")
    assert br.state() == BREAKER_CLOSED
    assert transitions == [
        (BREAKER_CLOSED, BREAKER_OPEN), (BREAKER_OPEN, BREAKER_HALF_OPEN),
        (BREAKER_HALF_OPEN, BREAKER_OPEN), (BREAKER_OPEN, BREAKER_HALF_OPEN),
        (BREAKER_HALF_OPEN, BREAKER_CLOSED)]


def test_breaker_trip_is_immediate():
    br = CircuitBreaker(errs=5, window=8, cooldown_s=5.0)
    br.trip("wedged")
    assert br.state() == BREAKER_OPEN


def test_breaker_rolling_window_forgets_old_failures():
    br = CircuitBreaker(errs=3, window=3, cooldown_s=1.0)
    br.record_failure("a")
    br.record_failure("b")
    for _ in range(3):
        br.record_success()
    br.record_failure("c")
    br.record_failure("d")
    assert br.state() == BREAKER_CLOSED


def test_router_knobs_read_the_reference_defaults(monkeypatch):
    from mxnet_tpu_torch import config

    for name, want in (("MXNET_ROUTER_BREAKER_ERRS", 3),
                       ("MXNET_ROUTER_BREAKER_WINDOW", 16),
                       ("MXNET_ROUTER_BREAKER_COOLDOWN_S", 2.0),
                       ("MXNET_ROUTER_HEDGE_PCTL", 0),
                       ("MXNET_ROUTER_WEDGE_S", 30.0),
                       ("MXNET_ROUTER_EAGER_FALLBACK", False),
                       ("MXNET_ROUTER_AUTOSCALE", False),
                       ("MXNET_ROUTER_MIN_REPLICAS", 1),
                       ("MXNET_ROUTER_MAX_REPLICAS", 4),
                       ("MXNET_ROUTER_SCALE_COOLDOWN_S", 10.0),
                       ("MXNET_ROUTER_SCALE_INTERVAL_S", 1.0),
                       ("MXNET_ROUTER_SCALE_UP_QUEUE", 1.5),
                       ("MXNET_ROUTER_SCALE_DOWN_QUEUE", 0.1),
                       ("MXNET_ROUTER_SCALE_POOL_HIGH", 0.85),
                       ("MXNET_ROUTER_PREFIX_AFFINITY", 1.0),
                       ("MXNET_ROUTER_REMOTE_TIMEOUT_S", 120.0)):
        monkeypatch.delenv(name, raising=False)
        assert config.get(name) == want, name
    monkeypatch.setenv("MXNET_ROUTER_HEDGE_PCTL", "40")
    with pytest.raises(ValueError):
        config.get("MXNET_ROUTER_HEDGE_PCTL")
    monkeypatch.setenv("MXNET_ROUTER_HEDGE_PCTL", "95")
    assert config.get("MXNET_ROUTER_HEDGE_PCTL") == 95
    assert {"router.dispatch", "router.remote", "router.scale"} <= set(
        faults.SITES)


# ---------------------------------------------------------------------------
# 2. the shared deadline budget (faults.deadline_scope / deadline_us)
# ---------------------------------------------------------------------------
def test_deadline_budget_shared_across_nested_sites(monkeypatch):
    sleeps = []
    monkeypatch.setattr(faults, "_sleep",
                        lambda s: sleeps.append(s) or time.sleep(0.001))

    def boom():
        raise faults.TransientFault("inner failure")

    def inner():
        return faults.retry_call(boom, site="router.test_inner", retries=50,
                                 backoff=0.05)

    t0 = time.monotonic()
    with pytest.raises(faults.DeadlineExceeded) as ei:
        faults.retry_call(inner, site="router.test_outer", retries=50,
                          backoff=0.05, deadline_us=60_000)
    assert "'router.test_outer'" in str(ei.value)
    assert "router.test_inner" in str(ei.value)
    assert time.monotonic() - t0 < 2.0
    assert all(s <= 0.06 + 0.05 for s in sleeps)


def test_deadline_scope_narrows_never_widens():
    with faults.deadline_scope(100_000, site="outer.site"):
        r_outer = faults.deadline_remaining_us()
        assert 0 < r_outer <= 100_000
        with faults.deadline_scope(10_000_000, site="inner.site"):
            assert faults.deadline_remaining_us() <= r_outer
            assert faults.deadline_site() == "outer.site"
        with faults.deadline_scope(1_000, site="inner.site"):
            assert faults.deadline_remaining_us() <= 1_000
            assert faults.deadline_site() == "outer.site"
    assert faults.deadline_remaining_us() is None
    assert faults.deadline_site() is None


def test_deadline_budget_expired_never_attempts(monkeypatch):
    monkeypatch.setattr(faults, "_sleep", lambda s: None)
    calls = []
    with faults.deadline_scope(1, site="spent.site"):
        time.sleep(0.001)
        with pytest.raises(faults.DeadlineExceeded):
            faults.retry_call(lambda: calls.append(1), site="spent.nested")
    assert calls == []


# ---------------------------------------------------------------------------
# 3. failover: replica death is invisible to the client (token-exact)
# ---------------------------------------------------------------------------
def test_failover_token_exact_vs_oracle():
    router, engines, pools, model, params = mk_router()

    def boom(*a, **kw):
        raise RuntimeError("replica 0 died")

    engines[0].generate = boom
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(6)]
    outs = [router.generate(p, max_new_tokens=5) for p in prompts]
    for p, o in zip(prompts, outs):
        assert o == sd.eager_generate(model, params, p, 5)
    st = router.stats()
    assert st["failovers"] >= 1 and st["breaker_opens"] >= 1
    assert router.breaker_state(0) in (BREAKER_OPEN, BREAKER_HALF_OPEN)
    assert router.breaker_state(1) == BREAKER_CLOSED
    snap = telemetry.snapshot()
    assert any(k.startswith("serving.router") and k.endswith(".failovers")
               and v for k, v in snap.items())
    _engine.waitall()
    assert all(p.in_use() == 0 for p in pools)


def test_router_dispatch_fault_site_injected_failover():
    router, engines, pools, model, params = mk_router()
    with faults.active(faults.FaultPlan().fail("router.dispatch", times=2)):
        out = router.generate([3, 4, 5], max_new_tokens=4)
    assert out == sd.eager_generate(model, params, [3, 4, 5], 4)
    c = faults.counters("router.dispatch")
    assert c["injected"] == 2 and c["retries"] >= 2
    assert router.breaker_state(0) == BREAKER_CLOSED
    assert router.breaker_state(1) == BREAKER_CLOSED


def test_wedged_dispatch_evicted_and_failed_over():
    router, engines, pools, model, params = mk_router(
        wedge_s=0.4, breaker_cooldown_s=30.0)
    release = threading.Event()

    def wedge(*a, **kw):
        release.wait(30.0)
        raise RuntimeError("released")

    engines[0].generate = wedge
    t0 = time.monotonic()
    out = router.generate([7, 8], max_new_tokens=4)
    elapsed = time.monotonic() - t0
    assert out == sd.eager_generate(model, params, [7, 8], 4)
    assert router.stats()["wedged"] == 1
    assert router.breaker_state(0) == BREAKER_OPEN
    assert 0.4 <= elapsed < 5.0
    _engine.waitall()                       # the abandoned dispatch
    assert router.stats()["delivered"] == 1
    release.set()


def test_breaker_flap_reopens_then_probe_readmits(monkeypatch):
    monkeypatch.setenv("MXNET_ROUTER_PREFIX_AFFINITY", "0")
    router, engines, pools, model, params = mk_router(
        breaker_cooldown_s=0.15)
    orig = engines[0].generate
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise faults.TransientFault(f"flap {calls['n']}")
        return orig(*a, **kw)

    engines[0].generate = flaky
    for _ in range(4):
        router.generate([1, 2], max_new_tokens=3)
    assert router.breaker_state(0) == BREAKER_OPEN
    time.sleep(0.2)
    deadline = time.monotonic() + 5.0
    while router.breaker_state(0) != BREAKER_CLOSED and \
            time.monotonic() < deadline:
        router.generate([1, 2], max_new_tokens=3)
    st = router.stats()
    assert router.breaker_state(0) == BREAKER_CLOSED
    assert st["breaker_opens"] >= 1 and st["breaker_closes"] >= 1
    assert st["probes"] >= 1


# ---------------------------------------------------------------------------
# 4. hedged requests: first-wins + cancellation at the step boundary
# ---------------------------------------------------------------------------
def test_hedge_first_wins_and_cancellation_counters():
    router, engines, pools, model, params = mk_router(hedge_pctl=50)
    for _ in range(20):
        router.generate([1, 2, 3], max_new_tokens=3)
    orig = engines[0].generate

    def slow(*a, **kw):
        time.sleep(1.5)
        return orig(*a, **kw)

    engines[0].generate = slow
    ref = sd.eager_generate(model, params, [1, 2, 3], 3)
    t0 = time.monotonic()
    outs = [router.generate([1, 2, 3], max_new_tokens=3) for _ in range(3)]
    elapsed = time.monotonic() - t0
    assert all(o == ref for o in outs)
    st = router.stats()
    assert st["hedges"] >= 1 and st["hedge_wins"] >= 1
    assert st["hedge_cancelled"] >= 1
    assert elapsed < 4.0
    _engine.waitall()


def test_hedge_loser_row_freed_at_the_next_step_boundary():
    """A hedge's loser cannot abort a replay in flight: its cancel token
    retires the row at the engine's next step boundary, its pages freed
    long before its own request would have finished."""
    model, params = tiny()
    eng, pool = _mk_engine(model, params, warm=8, name="loser")
    real_call = eng._call
    gate = threading.Event()
    steps = {"n": 0}

    def paced(*a, **kw):
        steps["n"] += 1
        if steps["n"] > 2:
            gate.wait(0.05)             # a slow decode step
        return real_call(*a, **kw)

    eng._call = paced
    token = threading.Event()
    err = []

    def run():
        with sd.cancel_scope(token):
            try:
                eng.generate([1, 2, 3], max_new_tokens=40)
            except sd.RequestCancelled as e:
                err.append(e)

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 10.0
    while pool.in_use() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pool.in_use() > 0
    token.set()
    _join([t])
    assert err and err[0].kind == "cancelled"
    assert pool.in_use() == 0 and eng.pool_audit() == []
    # the engine keeps serving
    assert eng.generate([4, 5], max_new_tokens=3) == \
        sd.eager_generate(model, params, [4, 5], 3)
    eng.close()


def test_hedge_off_by_default_and_below_min_samples():
    router, *_ = mk_router(warm=None)
    assert router._hedge_threshold() is None
    router2, *_ = mk_router(hedge_pctl=95, warm=None)
    assert router2._hedge_threshold() is None


# ---------------------------------------------------------------------------
# 5. degraded modes
# ---------------------------------------------------------------------------
def test_all_breakers_open_sheds_unavailable():
    router, engines, pools, model, params = mk_router(warm=None)

    def boom(*a, **kw):
        raise RuntimeError("dead")

    engines[0].generate = boom
    engines[1].generate = boom
    for _ in range(6):
        with pytest.raises(faults.ShedError) as ei:
            router.generate([1], max_new_tokens=2)
        assert ei.value.kind == "unavailable"
    assert router.stats()["shed_unavailable"] == 6
    assert all(router.breaker_state(i) != BREAKER_CLOSED for i in range(2))


def test_eager_fallback_serves_when_all_replicas_down():
    router, engines, pools, model, params = mk_router(
        eager_fallback=True, warm=None)

    def boom(*a, **kw):
        raise RuntimeError("dead")

    engines[0].generate = boom
    engines[1].generate = boom
    outs = [router.generate([2, 3], max_new_tokens=4) for _ in range(6)]
    ref = sd.eager_generate(model, params, [2, 3], 4)
    assert all(o == ref for o in outs)
    assert router.stats()["eager_fallbacks"] >= 1


def test_router_sheds_draining_on_preemption_notice():
    router, engines, pools, model, params = mk_router()
    router.generate([1, 2], max_new_tokens=2)
    preemption._DRAINING.set()
    try:
        with pytest.raises(faults.ShedError) as ei:
            router.generate([1, 2], max_new_tokens=2)
        assert ei.value.kind == "draining"
        assert router.stats()["shed_draining"] == 1
        _engine.waitall()
    finally:
        preemption.reset()


# ---------------------------------------------------------------------------
# 6. per-request deadlines through the router
# ---------------------------------------------------------------------------
def test_expired_deadline_sheds_typed_never_hangs():
    router, engines, pools, model, params = mk_router()
    router.generate([1, 2], max_new_tokens=2)
    t0 = time.monotonic()
    with pytest.raises(faults.ShedError) as ei:
        router.generate([1, 2], max_new_tokens=40, deadline_us=1_000)
    assert ei.value.kind == "deadline"
    assert time.monotonic() - t0 < 1.0
    assert router.stats()["shed_deadline"] >= 1


def test_deadline_budget_covers_engine_admission_cost_table():
    model, params = tiny()
    eng, pool = _mk_engine(model, params, warm=8, name="ded")
    eng.generate([1, 2, 3], max_new_tokens=6)
    d0 = eng._stats["decode_steps"]
    with faults.deadline_scope(1_500, site="client.deadline"):
        with pytest.raises(faults.ShedError) as ei:
            eng.generate([1, 2, 3], max_new_tokens=40)
    assert ei.value.kind == "deadline"
    assert eng._stats["shed_deadline"] == 1
    assert eng._stats["decode_steps"] == d0
    eng.close()


def test_generous_deadline_delivers_token_exact():
    router, engines, pools, model, params = mk_router()
    out = router.generate([4, 5, 6], max_new_tokens=5,
                          deadline_us=60_000_000)
    assert out == sd.eager_generate(model, params, [4, 5, 6], 5)
    assert router.stats()["shed_deadline"] == 0


# ---------------------------------------------------------------------------
# 7. balancing + heartbeat
# ---------------------------------------------------------------------------
def test_balancer_prefers_idle_replica():
    router, engines, pools, model, params = mk_router(warm=None)
    engines[0].load = lambda: {"queue_depth": 50.0, "in_flight": 1.0,
                               "pool_pressure": 0.9}
    assert router._pick(exclude=set()).index == 1


def test_heartbeat_monitor_in_memory_generalization():
    hb = HeartbeatMonitor(timeout=0.2)
    hb.beat("replica0")
    hb.beat("replica1")
    assert hb.ranks() == ["replica0", "replica1"]
    assert hb.dead_ranks() == []
    assert hb.age("replica0") < 0.2
    time.sleep(0.25)
    hb.beat("replica1")
    assert hb.dead_ranks() == ["replica0"]
    assert hb.age("missing") is None


def test_router_validates_replicas():
    model, params = tiny()
    eng, _pool = _mk_engine(model, params)
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(TypeError):
        ReplicaRouter([object()])
    router = ReplicaRouter([eng])
    with pytest.raises(RuntimeError):
        router.infer(onp.zeros((1, 4), onp.float32))
    eng.close()


# ---------------------------------------------------------------------------
# 8. one-shot inference replicas (ServingEngine kind)
# ---------------------------------------------------------------------------
def _infer_net(seed=0):
    import mxnet_tpu_torch as mx

    class Net(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = mx.gluon.nn.Dense(8, in_units=4, activation="relu")
            self.d2 = mx.gluon.nn.Dense(3, in_units=8)

        def forward(self, x):
            return self.d2(self.d1(x))

    net = Net()
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.from_numpy(
            (rng.randn(*p.shape) * 0.2).astype(onp.float32)))
    net.hybridize()
    return net


def test_infer_router_failover_matches_bare_forward():
    import mxnet_tpu_torch as mx

    net = _infer_net()
    e1 = serving.ServingEngine(net, max_delay_us=0)
    e2 = serving.ServingEngine(net, max_delay_us=0)
    router = ReplicaRouter([e1, e2], breaker_errs=2)
    x = mx.nd.array(onp.random.RandomState(3).randn(4, 4)
                    .astype(onp.float32), ctx=mx.cpu())
    want = net(x).asnumpy()
    assert onp.array_equal(router.infer(x).asnumpy(), want)
    orig = e1.infer

    def boom(*a, **kw):
        raise RuntimeError("replica 0 died")

    e1.infer = boom
    for _ in range(4):
        assert onp.array_equal(router.infer(x).asnumpy(), want)
    assert router.stats()["failovers"] >= 1
    e1.infer = orig
    e1.close()
    e2.close()


def test_infer_router_eager_fallback_and_generate_rejected():
    import mxnet_tpu_torch as mx

    net = _infer_net()
    e1 = serving.ServingEngine(net, max_delay_us=0)
    router = ReplicaRouter([e1], eager_fallback=True)
    with pytest.raises(RuntimeError):
        router.generate([1, 2])
    x = mx.nd.array(onp.ones((2, 4), onp.float32), ctx=mx.cpu())
    want = net(x).asnumpy()

    def boom(*a, **kw):
        raise RuntimeError("dead")

    e1.infer = boom
    for _ in range(4):
        assert onp.allclose(router.infer(x).asnumpy(), want, atol=1e-6)
    assert router.stats()["eager_fallbacks"] >= 1
    e1.close()


# ---------------------------------------------------------------------------
# 9. drain + dispatch budget
# ---------------------------------------------------------------------------
def test_waitall_drains_router_inflight():
    router, engines, pools, model, params = mk_router()
    outs = {}

    def fire(i):
        outs[i] = router.generate([1 + i, 2], max_new_tokens=6)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _engine.waitall()
    _join(threads)
    assert len(outs) == 4
    with router._lock:
        assert router._inflight == 0
    assert all(p.in_use() == 0 for p in pools)


def test_dispatch_budget_router_and_spec_lanes_in_process():
    import tools.torch_check_dispatch_budget as cdb

    router = cdb.measure_router(CPU)
    spec = cdb.measure_spec(CPU)
    assert cdb.router_failures(router) == []
    assert cdb.spec_failures(spec) == []
    assert router["extra_dispatches"] == 0 and router["outputs_equal"]
    assert spec["retraces_after_warm"] == 0 and spec["greedy_token_exact"]


@pytest.mark.slow
def test_availability_gate_subprocess_scenarios():
    import tools.torch_check_availability_budget as gate

    assert gate.main(["router_kill", "router_deadline_storm",
                      "--device", CPU]) == 0


# ---------------------------------------------------------------------------
# 11. elastic fleet membership
# ---------------------------------------------------------------------------
def test_add_replica_serves_only_after_warmup():
    router, engines, pools, model, params = mk_router(n=1)
    joiner, jpool = _mk_engine(model, params)
    mid_warm = {}
    real_warmup = joiner.warmup

    def observed_warmup(**kw):
        rep = router._replicas[1]
        mid_warm["state"] = rep.state
        mid_warm["serving"] = router.serving_replicas()
        mid_warm["out"] = router.generate([5, 6, 7], max_new_tokens=3)
        return real_warmup(**kw)

    joiner.warmup = observed_warmup
    assert router.add_replica(joiner, warmup_kwargs={"max_len": 8}) == 1
    assert mid_warm["state"] == sr.REPLICA_JOINING
    assert mid_warm["serving"] == 1
    assert mid_warm["out"] == sd.eager_generate(model, params, [5, 6, 7], 3)
    assert router._replicas[1].state == sr.REPLICA_SERVING
    fs = router.fleet_stats()
    assert fs["joins"] == 1 and fs["serving"] == 2
    assert fs["warm_programs"] > 0
    snap = telemetry.snapshot()
    assert any(k.endswith(".serving_replicas") and v == 2.0
               for k, v in snap.items())
    _engine.waitall()
    assert jpool.in_use() == 0 and pools[0].in_use() == 0


def test_joiner_captures_while_the_fleet_serves():
    """A joiner captures its programs while the incumbent serves a storm;
    no capture happens after the join."""
    router, engines, pools, model, params = mk_router(n=1)
    joiner, jpool = _mk_engine(model, params, name="joiner")
    prompts = [[1 + i % 7, 2, 3] for i in range(12)]
    outs = []

    def fire(p):
        outs.append((str(p), router.generate(p, max_new_tokens=4)))

    threads = [threading.Thread(target=fire, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    router.add_replica(joiner, warmup_kwargs={"max_len": 8})
    _join(threads)
    t0 = sd.trace_count()
    more = [router.generate(p, max_new_tokens=4) for p in prompts[:4]]
    assert sd.trace_count() == t0
    for key, out in outs:
        p = [int(x) for x in key.strip("[]").split(",")]
        assert out == sd.eager_generate(model, params, p, 4)
    assert more[0] == sd.eager_generate(model, params, prompts[0], 4)
    _engine.waitall()
    assert jpool.in_use() == 0 and pools[0].in_use() == 0


def test_drain_replica_idempotent_double_drain():
    router, engines, pools, model, params = mk_router()
    assert router.drain_replica(1) is True
    assert router.drain_replica(1) is True
    fs = router.fleet_stats()
    assert fs["drains"] == 1 and fs["gone"] == 1 and fs["serving"] == 1
    assert router.generate([2, 3, 4], max_new_tokens=4) == \
        sd.eager_generate(model, params, [2, 3, 4], 4)
    assert [r["state"] for r in router.stats()["replicas"]] == \
        [sr.REPLICA_SERVING, sr.REPLICA_GONE]
    _engine.waitall()
    assert all(p.in_use() == 0 for p in pools)


def test_drain_while_hedge_outstanding():
    router, engines, pools, model, params = mk_router(hedge_pctl=50)
    for i in range(20):
        router.generate([1 + i % 7, 2], max_new_tokens=2)
    real = engines[1].generate

    def slow(*a, **kw):
        time.sleep(0.8)
        return real(*a, **kw)

    engines[1].generate = slow
    prompts = [[3, 4, 5], [6, 7, 8], [9, 10, 11], [12, 13, 14]]
    outs = []
    threads = [threading.Thread(target=lambda p=p: outs.append(
        (str(p), router.generate(p, max_new_tokens=3)))) for p in prompts]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5.0
    while (router._replicas[1].in_flight == 0
           and time.monotonic() < deadline):
        time.sleep(0.002)
    assert router._replicas[1].in_flight > 0
    assert router.drain_replica(1, timeout=30.0) is True
    _join(threads)
    assert len(outs) == 4
    for key, out in outs:
        p = [int(x) for x in key.strip("[]").split(",")]
        assert out == sd.eager_generate(model, params, p, 3)
    assert router.fleet_stats()["drains"] == 1
    _engine.waitall()
    assert all(p.in_use() == 0 for p in pools)


def test_supervisor_cooldown_and_bounds_injectable_clock():
    router, engines, pools, model, params = mk_router(n=1)
    clk = [0.0]
    retired = []

    def spawn():
        return _mk_engine(model, params)[0]

    sup = sr.FleetSupervisor(
        router, spawn, retire=lambda eng, idx: retired.append(idx),
        enabled=True, min_replicas=1, max_replicas=2, cooldown_s=10.0,
        up_queue=1.0, down_queue=0.1, pool_high=0.9,
        warmup_kwargs={"max_len": 8}, clock=lambda: clk[0])
    sig = {"queue_per_replica": 5.0, "pool_pressure": 0.0, "p99_s": 0.0}
    sup.signals = lambda: dict(sig, serving=float(router.serving_replicas()))
    assert sup.tick() == "up"
    assert router.serving_replicas() == 2
    assert sup.tick() is None
    sig["queue_per_replica"] = 0.0
    assert sup.tick() is None
    clk[0] = 11.0
    assert sup.tick() == "down"
    assert retired == [1]
    assert router.serving_replicas() == 1
    clk[0] = 22.0
    assert sup.tick() is None
    fs = router.fleet_stats()
    assert fs["scale_ups"] == 1 and fs["scale_downs"] == 1
    assert fs["ticks"] >= 5
    _engine.waitall()


def test_supervisor_disabled_is_inert():
    router, *_ = mk_router(n=1, warm=None)
    sup = sr.FleetSupervisor(router, spawn=lambda: None,
                             enabled=False).start()
    assert sup.enabled is False and sup._thread is None
    sup.stop()


def test_router_scale_fault_site_injected():
    router, engines, pools, model, params = mk_router(n=1)
    joiner, _ = _mk_engine(model, params, warm=8)
    with faults.active(faults.FaultPlan().fail("router.scale", times=1)):
        with pytest.raises(faults.TransientFault):
            router.add_replica(joiner, warmup_kwargs={"max_len": 8})
        assert router.serving_replicas() == 1
        assert len(router._replicas) == 1
        assert router.fleet_stats()["joins"] == 0
        assert router.add_replica(joiner,
                                  warmup_kwargs={"max_len": 8}) == 1
    assert faults.counters("router.scale")["injected"] == 1
    assert router.serving_replicas() == 2
    with faults.active(faults.FaultPlan().fail("router.scale", times=1)):
        with pytest.raises(faults.TransientFault):
            router.drain_replica(1)
        assert router._replicas[1].state == sr.REPLICA_SERVING
        assert router.drain_replica(1) is True
    assert router._replicas[1].state == sr.REPLICA_GONE
    _engine.waitall()


def test_router_is_an_engine_drainable_and_sheds_after_close():
    router, *_ = mk_router(n=1, warm=None)
    assert router in _engine._DRAINABLES
    router.close()
    with pytest.raises(RuntimeError):
        router.generate([1], max_new_tokens=1)


# ---------------------------------------------------------------------------
# 12. cross-process replicas (serving_remote)
# ---------------------------------------------------------------------------
def test_router_remote_fault_site_injected_failover():
    from mxnet_tpu_torch import serving_remote as srm

    router, engines, pools, model, params = mk_router(n=1)
    eng2, pool2 = _mk_engine(model, params, warm=8, name="wire1")
    srv = srm.ReplicaServer(eng2).start()
    try:
        router.add_replica(srm.RemoteReplica("127.0.0.1", srv.port))
        prompts = [[1 + i, 2 + i, 3 + i] for i in range(6)]
        outs = []
        with faults.active(faults.FaultPlan().fail("router.remote",
                                                   times=2)):
            threads = [threading.Thread(target=lambda p=p: outs.append(
                (str(p), router.generate(p, max_new_tokens=4))))
                for p in prompts]
            for t in threads:
                t.start()
            _join(threads)
        assert len(outs) == 6
        for key, out in outs:
            p = [int(x) for x in key.strip("[]").split(",")]
            assert out == sd.eager_generate(model, params, p, 4)
        assert faults.counters("router.remote")["injected"] >= 1
    finally:
        srv.close()
    _engine.waitall()
    assert pool2.in_use() == 0 and pools[0].in_use() == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_router_on_card_fails_over_and_cancels_hedge_losers(cuda_device):
    """Two captured replicas on the card: a killed replica's requests fail
    over token-exact against the eager loop on the card, a hedged pass
    retires its losers' rows, and nothing is captured after the warm-up or
    left in the pools."""
    model = sd.TinyCausalLM(vocab=31, d_model=16, n_layers=1, n_heads=2,
                            max_seq=48)
    params = model.init_params(0, device=cuda_device)
    engines = [sd.GenerativeEngine(model, params=params,
                                   pool=sd.PagePool(pages=32, page=4),
                                   max_rows=2, name=f"card{i}",
                                   device=cuda_device) for i in range(2)]
    try:
        for e in engines:
            e.warmup(max_len=8)
        t0 = sd.trace_count()
        router = ReplicaRouter(engines, breaker_errs=2, hedge_pctl=50)
        prompts = [[1 + i % 9, 2, 3] for i in range(24)]
        want = {str(p): sd.eager_generate(model, params, p, 5)
                for p in prompts}
        outs = []
        threads = [threading.Thread(target=lambda p=p: outs.append(
            (str(p), router.generate(p, max_new_tokens=5))))
            for p in prompts[:12]]
        for t in threads:
            t.start()
        _join(threads)

        def boom(*a, **kw):
            raise RuntimeError("replica 0 died")

        engines[0]._call = boom
        threads = [threading.Thread(target=lambda p=p: outs.append(
            (str(p), router.generate(p, max_new_tokens=5))))
            for p in prompts[12:]]
        for t in threads:
            t.start()
        _join(threads)
        assert len(outs) == 24
        for key, out in outs:
            assert out == want[key]
        assert router.stats()["failovers"] >= 1
        _engine.waitall()
        assert sd.trace_count() == t0
        assert [e.pool_in_use() for e in engines] == [0, 0]
        assert [e.pool_audit() for e in engines] == [[], []]
    finally:
        for e in engines:
            e.close()


@pytest.mark.cuda
def test_dispatch_budget_lanes_on_card(cuda_device):
    import tools.torch_check_dispatch_budget as cdb

    router = cdb.measure_router("cuda")
    spec = cdb.measure_spec("cuda")
    assert cdb.router_failures(router) == []
    assert cdb.spec_failures(spec) == []


@pytest.mark.cuda
def test_joiner_captures_on_card_while_the_fleet_serves(cuda_device):
    """``add_replica`` during a storm on the card: the joiner captures its
    graphs (the process-wide capture lock, thread-local capture mode)
    while the incumbent replays its own from another thread; every stream
    stays token-exact, and nothing is captured once the joiner serves."""
    model = sd.TinyCausalLM(vocab=31, d_model=16, n_layers=1, n_heads=2,
                            max_seq=48)
    params = model.init_params(0, device=cuda_device)

    def engine(name):
        return sd.GenerativeEngine(model, params=params,
                                   pool=sd.PagePool(pages=32, page=4),
                                   max_rows=2, name=name,
                                   device=cuda_device)

    first, joiner = engine("incumbent"), engine("joiner")
    try:
        first.warmup(max_len=8)
        router = ReplicaRouter([first])
        prompts = [[1 + i % 9, 2, 3] for i in range(24)]
        outs = []
        threads = [threading.Thread(target=lambda p=p: outs.append(
            (str(p), router.generate(p, max_new_tokens=6))))
            for p in prompts]
        for t in threads:
            t.start()
        assert router.add_replica(joiner, warmup_kwargs={"max_len": 8}) == 1
        _join(threads)
        t0 = sd.trace_count()
        more = [router.generate(p, max_new_tokens=6) for p in prompts[:8]]
        assert sd.trace_count() == t0
        want = {str(p): sd.eager_generate(model, params, p, 6)
                for p in prompts}
        for key, out in outs:
            assert out == want[key]
        assert more == [want[str(p)] for p in prompts[:8]]
        _engine.waitall()
        assert first.pool_in_use() == 0 and joiner.pool_in_use() == 0
    finally:
        first.close()
        joiner.close()
