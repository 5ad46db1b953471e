#!/usr/bin/env python3
"""Serving-path latency of the PyTorch/CUDA port: the one-shot engine
(``serving.ServingEngine``) and the continuous-batching decode engine
(``serving_decode.GenerativeEngine``).

    python3 tools/torch_serving_latency.py [--serve] [--decode] [--storm]
        [--shared-prefix] [--speculative] [--router] [--device cuda|cpu]
        [--json]

The port of ``benchmark/serving_latency.py``'s workers, run in this
process (the functions are also what ``chip_smoke.py`` phase 11 calls):

- :func:`run_serving` (the reference's serve worker, ``bench.py``'s
  ``lane_infer``): the lane's MLP (three ``Dense`` of width 64, 8 outputs)
  over a seeded variable-length stream of 1-32 rows; the pow2 grid
  captured by ``warmup``, one request per bucket verified, then a
  sequential pass (p50/p99 request latency, throughput, captures after
  warm-up, bucket hits and misses, dispatches) and a concurrent pass from
  4 threads (requests per dispatch).
- :func:`run_decode` (the decode worker, ``lane_decode``): the same
  request set one request at a time against ``concurrency`` client
  threads through the scheduler, each pass from a cold prefix cache (the
  reference's worker lets the second pass hit the first's prompts, which
  flatters the continuous pass): tokens/s of each, the batching speedup,
  captures after warm-up, dispatches, rows per decode step, p50/p99; with
  ``profile=True`` also the device's busy time and idle share over the
  continuous pass, from a ``torch.profiler`` trace.
- :func:`storm_phase`: bursty Poisson arrivals of mixed-length prompts to
  a fast model co-hosted with a deliberately slow one on one shared page
  pool: per-model p50/p99, tokens/s and sheds, and the fast model's storm
  p99 over its solo p99 (the interference ratio).
- :func:`run_shared_prefix`: USERS copies of one system prompt through the
  prefix cache, warm (cache on) and cold (off): hit rate, prefills, and
  token-exactness against each other and the eager loop.
- :func:`run_speculative` (the reference's ``--speculative`` worker,
  ``benchmark/serving_latency.py:600-760``): the same greedy prompt set
  through ``high_agreement_pair(vocab=128, d_model=64, target_layers=8,
  draft_layers=1, n_heads=4, max_seq=96)`` at ``max_rows=2`` on a 256 x 8
  pool, three passes: the baseline (no speculation), a low-agreement
  draft (an independent 1-layer init, which must auto-disable), and the
  high-agreement draft at k=4: tokens/s of each, the speedup, the measured
  acceptance, the counters, and the cost table's draft-round, verify and
  decode-step times.

:func:`check_bars` holds a result to the lanes' bars (``bench.py``
:692-790): batching speedup >= 2 at concurrency >= 8 and 0 captures after
warm-up for decode, programs <= buckets and 0 captures after warm-up for
the one-shot lane, interference ratio <= 2, prefix hit rate >= 0.9, and
for the speculative lane the reference's: speedup >= 1.5 at acceptance >=
0.7, every pass token-exact against the eager loop, the low-agreement
draft auto-disabled and within 5% of the baseline's tokens/s.
- :func:`run_router_storm` and :func:`run_elastic_storm` (``--router``, the
  reference's router and elastic storms, ``benchmark/serving_latency.py``
  :326-470), each also with a speculative leg (a high-agreement pair at the
  fast model's widths behind every replica, ``MXNET_SPEC_DECODE=1``):
  dropped, hedged, failed over, breaker transitions, p50/p99 and tokens/s
  of a 2-replica router whose replica 0 is killed mid-storm; and the
  replica-count timeline, scale events and fleet tokens/s of a
  ``FleetSupervisor`` growing and shrinking an in-process fleet. Their bar:
  0 dropped, every delivery token-exact against the eager loop, 0 pages
  left in use. Every timed number is measured
on this process's device; on the card, print it beside
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
"""
import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from mxnet_tpu_torch import serving, serving_decode as sd  # noqa: E402
from mxnet_tpu_torch import program_store, telemetry  # noqa: E402

BARS = {"batching_speedup": 2.0, "min_concurrency": 8,
        "interference_p99_ratio": 2.0, "prefix_hit_rate": 0.9,
        "spec_speedup": 1.5, "spec_acceptance": 0.7,
        "spec_low_ratio": 0.95}
JOIN_S = 600.0


def _join(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not finish")


# ---------------------------------------------------------------------------
# one-shot inference (lane_infer)
# ---------------------------------------------------------------------------
def lane_mlp(width: int = 64, device="cuda", seed: int = 0):
    """The lane's net: Dense(width, relu), Dense(width, relu), Dense(8),
    Xavier from ``seed``, on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = nn.Dense(width, in_units=width, activation="relu")
            self.d2 = nn.Dense(width, in_units=width, activation="relu")
            self.out = nn.Dense(8, in_units=width)

        def forward(self, x):
            return self.out(self.d2(self.d1(x)))

    mx.random.seed(seed)
    net = Net()
    ctx = mx.cpu() if torch.device(device).type == "cpu" else mx.gpu(0)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def run_serving(requests: int = 64, threads: int = 4, maxlen: int = 32,
                width: int = 64, device="cuda", net=None, example=None,
                make_request=None) -> dict:
    """The serve worker: warm-up, per-bucket verify, a sequential and a
    concurrent pass. ``net`` (default :func:`lane_mlp`), ``example`` (one
    request giving the per-row shape) and ``make_request(rng, rows)`` let
    another net run the same lane."""
    net = net if net is not None else lane_mlp(width, device)
    rng = np.random.RandomState(0)
    if make_request is None:
        def make_request(rng_, n):
            return rng_.randn(n, width).astype(np.float32)
    example = example if example is not None else make_request(rng, 1)
    lengths = rng.randint(1, maxlen + 1, size=requests).tolist()
    reqs = [make_request(rng, n) for n in lengths]
    eng = serving.ServingEngine(net, max_delay_us=200)
    eng2 = None
    try:
        t_warm = time.perf_counter()
        warmup_programs = eng.warmup(example, max_rows=maxlen)
        capture_s = time.perf_counter() - t_warm
        b = 1
        while b <= maxlen:
            eng.infer(make_request(rng, b))
            b <<= 1
        t0, d0 = serving.trace_count(), serving.dispatch_count()
        h0 = serving.bucket_stats()
        t_start = time.perf_counter()
        for r in reqs:
            eng.infer(r)
        dt = time.perf_counter() - t_start
        seq = eng.stats()
        retraces = serving.trace_count() - t0
        h1 = serving.bucket_stats()
        dispatches = serving.dispatch_count() - d0

        eng2 = serving.ServingEngine(net, max_delay_us=3000)
        eng2.warmup(example, max_rows=serving.BucketPolicy().bucket(
            maxlen * threads))
        errs = []

        def fire(chunk):
            def go():
                try:
                    for r in chunk:
                        eng2.infer(r)
                except BaseException as e:
                    errs.append(repr(e))
            return go

        t2 = time.perf_counter()
        _join([threading.Thread(target=fire(reqs[i::threads]))
               for i in range(threads)])
        dt2 = time.perf_counter() - t2
        if errs:
            raise RuntimeError("; ".join(errs))
        conc = eng2.stats()
        return {
            "device": str(eng.device), "requests": requests,
            "buckets": serving.BucketPolicy().spec,
            "programs": seq["programs"],
            "warmup_programs": warmup_programs,
            "capture_s": capture_s,
            "retraces_after_warm": retraces,
            "bucket_hits": h1["hits"] - h0["hits"],
            "bucket_misses": h1["misses"] - h0["misses"],
            "dispatches": dispatches,
            "bucket_refused": seq["bucket_refused"],
            "verify_ulp_accepts": seq["verify_ulp_accepts"],
            "p50_us": seq["p50_us"], "p99_us": seq["p99_us"],
            "throughput_rps": requests / dt,
            "concurrent": {
                "threads": threads, "batches": conc["batches"],
                "requests": conc["requests"],
                "coalesced": conc["coalesced"],
                "requests_per_dispatch":
                    conc["requests"] / max(conc["batches"], 1),
                "p99_us": conc["p99_us"],
                "throughput_rps": conc["requests"] / dt2,
            },
        }
    finally:
        eng.close()
        if eng2 is not None:
            eng2.close()


# ---------------------------------------------------------------------------
# continuous-batching decode (lane_decode)
# ---------------------------------------------------------------------------
def fast_model():
    return sd.TinyCausalLM(vocab=128, d_model=64, n_layers=2, n_heads=4,
                           max_seq=64)


def slow_model():
    """The storm's deliberately slow co-tenant (the reference's): about
    2.5x the fast model's per-step work, deep rather than wide."""
    return sd.TinyCausalLM(vocab=128, d_model=72, n_layers=4, n_heads=4,
                           max_seq=64)


def mk_prompts(rng, n, vocab=128, lo=2, hi=17):
    return [rng.randint(0, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def drive(eng, prompts, conc, new, rng=None, poisson_rate=None,
          sampling=None):
    """Submit ``prompts`` from ``conc`` client threads (optionally with
    Poisson inter-arrival sleeps): (wall s, tokens, sheds, outputs)."""
    errs, sheds, tokens = [], [0], [0]
    outs = [None] * len(prompts)
    lock = threading.Lock()

    def fire(idx):
        def go():
            for i in idx:
                if poisson_rate:
                    time.sleep(rng.exponential(1.0 / poisson_rate))
                try:
                    out = eng.generate(prompts[i], max_new_tokens=new,
                                       sampling=sampling)
                    outs[i] = out
                    with lock:
                        tokens[0] += len(out)
                except sd.ShedError:
                    with lock:
                        sheds[0] += 1
                except BaseException as e:
                    errs.append(e)
        return go

    idx = list(range(len(prompts)))
    t0 = time.perf_counter()
    _join([threading.Thread(target=fire(idx[i::conc]))
           for i in range(conc)])
    if errs:
        raise errs[0]
    return time.perf_counter() - t0, tokens[0], sheds[0], outs


def _device_busy_ms(fn):
    """(fn's result, wall ms, device-busy ms, kernels, graph launches) from
    a ``torch.profiler`` trace of one call: busy is None where the trace
    holds no device time; graph launches count the host's
    ``cudaGraphLaunch`` calls (one per replay)."""
    from torch.profiler import ProfilerActivity, profile

    program_store.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        program_store.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n, graphs = 0.0, 0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += evt.time_range.elapsed_us() / 1e3
            n += 1
        elif evt.name == "cudaGraphLaunch":
            graphs += 1
    return out, wall, (busy or None), n, graphs


def run_decode(requests: int = 16, concurrency: int = 8, new_tokens: int = 8,
               device="cuda", model=None, params=None, pool=None,
               prompts=None, warmup_len=16, profile=False,
               name="fast", engine=None) -> dict:
    """The continuous-batching A/B: the same requests one at a time, then
    from ``concurrency`` threads through the scheduler. ``model`` /
    ``params`` / ``pool`` / ``prompts`` default to the lane's fast model,
    a 256-page pool of 8 tokens and seeded prompts of 2-16 tokens; an
    ``engine`` given is used (and left open) instead of a new one."""
    own = engine is None
    if own:
        model = model if model is not None else fast_model()
        params = params if params is not None else model.init_params(
            0, device)
        pool = pool if pool is not None else sd.PagePool(pages=256, page=8)
        engine = sd.GenerativeEngine(model, params=params, pool=pool,
                                     max_rows=max(8, concurrency),
                                     name=name, device=device)
    eng = engine
    rng = np.random.RandomState(0)
    prompts = prompts if prompts is not None else mk_prompts(
        rng, requests, eng._model.vocab)
    cuda = eng.device.type == "cuda"
    try:
        t_warm = time.perf_counter()
        warmup_programs = eng.warmup(max_len=warmup_len)
        capture_s = time.perf_counter() - t_warm
        eng.generate(prompts[0], max_new_tokens=2)
        # each pass starts from a cold prefix cache, so that both do the
        # same prefill work (the second would hit the first's prompts)
        eng._pool.clear_prefix_cache()
        t0, d0 = sd.trace_count(), sd.dispatch_count()
        seq_s, seq_tok, _, seq_outs = drive(eng, prompts, 1, new_tokens)
        eng._pool.clear_prefix_cache()
        s0 = eng.stats()
        d1 = sd.dispatch_count()
        if profile and cuda:
            (conc_s, conc_tok, _, conc_outs), wall_ms, busy_ms, launches, \
                graph_launches = _device_busy_ms(
                    lambda: drive(eng, prompts, concurrency, new_tokens))
        else:
            conc_s, conc_tok, _, conc_outs = drive(eng, prompts,
                                                   concurrency, new_tokens)
            busy_ms = None
        st = eng.stats()
        steps = st["decode_steps"] - s0["decode_steps"]
        out = {
            "device": str(eng.device), "requests": len(prompts),
            "concurrency": concurrency, "new_tokens": new_tokens,
            "programs": st["programs"], "warmup_programs": warmup_programs,
            "capture_s": capture_s,
            "retraces_after_warm": sd.trace_count() - t0,
            "dispatches": sd.dispatch_count() - d0,
            "continuous_dispatches": sd.dispatch_count() - d1,
            "continuous_decode_steps": steps,
            "continuous_prefills": st["prefills"] - s0["prefills"],
            "rows_per_decode": st.get("rows_per_decode", 0.0),
            "sequential_tokens_s": seq_tok / seq_s,
            "continuous_tokens_s": conc_tok / conc_s,
            "batching_speedup": (conc_tok / conc_s) / max(seq_tok / seq_s,
                                                          1e-9),
            "continuous_iteration_ms": conc_s * 1e3 / max(steps, 1),
            "p50_us": st["p50_us"], "p99_us": st["p99_us"],
            "same_tokens_both_passes": seq_outs == conc_outs,
            "pool": {k: st["pool"][k] for k in
                     ("pages", "page", "in_use", "high_water")},
        }
        if busy_ms is not None:
            out.update(continuous_busy_ms=busy_ms,
                       continuous_wall_ms=wall_ms,
                       continuous_idle_share=1 - busy_ms / wall_ms,
                       continuous_kernel_launches=launches,
                       continuous_graph_launches=graph_launches)
        return out
    finally:
        if own:
            eng.close()


def storm_phase(with_slow: bool, device="cuda", fast=None, slow=None,
                fast_requests: int = 104, slow_requests: int = 14,
                new_tokens: int = 8) -> dict:
    """The multi-tenant storm: the fast model (SLO 500 ms, so it outranks
    the slow one at the shared dispatch gate) under bursty Poisson
    arrivals, alone or beside the slow model (2 rows, a queue of 2, so
    that it also sheds). ``fast`` / ``slow`` are (model, params)."""
    rng = np.random.RandomState(1)
    fm, fparams = fast if fast is not None else (
        fast_model(), fast_model().init_params(0, device))
    pool = sd.PagePool(pages=256, page=8)
    fe = sd.GenerativeEngine(fm, params=fparams, pool=pool, max_rows=8,
                             name="fast", slo_us=500_000, device=device)
    engines = [fe]
    try:
        fe.warmup(max_len=16)
        agents = []
        if with_slow:
            sm, sparams = slow if slow is not None else (
                slow_model(), slow_model().init_params(1, device))
            se = sd.GenerativeEngine(sm, params=sparams, pool=pool,
                                     max_rows=2, max_queue=2, name="slow",
                                     device=device)
            engines.append(se)
            se.warmup(max_len=16)
            agents.append((se, mk_prompts(rng, slow_requests, sm.vocab,
                                          4, 13), 7, 50.0))
        agents.append((fe, mk_prompts(rng, fast_requests, fm.vocab), 8,
                       40.0))
        results = {}

        def run(eng, prompts, conc, rate):
            def go():
                results[eng.name] = drive(eng, prompts, conc, new_tokens,
                                          np.random.RandomState(2), rate)
            return go

        _join([threading.Thread(target=run(*a)) for a in agents])
        stats = {}
        for eng, _p, _c, _r in agents:
            s = eng.stats()
            wall, tok, _shed, _outs = results[eng.name]
            stats[eng.name] = {
                "p50_us": s["p50_us"], "p99_us": s["p99_us"],
                "tokens_s": tok / wall, "shed": s["shed"],
                "preempts": s["preempts"],
                "slo_violations": s["slo_violations"],
                "delivered": s["delivered"],
            }
        stats["pool_in_use_after"] = pool.in_use()
        stats["pool_audit"] = pool.audit()
        return stats
    finally:
        for eng in engines:
            eng.close()


def run_storm(device="cuda", **kw) -> dict:
    """The storm's report: the fast model solo, then beside the slow one."""
    solo = storm_phase(False, device, **kw)["fast"]
    storm = storm_phase(True, device, **kw)
    return {"fast_solo_p99_us": solo["p99_us"], "fast": storm["fast"],
            "slow": storm["slow"],
            "interference_p99_ratio":
                storm["fast"]["p99_us"] / max(solo["p99_us"], 1e-9),
            "shed_total": storm["fast"]["shed"] + storm["slow"]["shed"],
            "pool_in_use_after": storm["pool_in_use_after"],
            "pool_audit": storm["pool_audit"]}


# ---------------------------------------------------------------------------
# the fleet: router storm and elastic storm (benchmark/serving_latency.py
# :326-470), each with its speculative leg
# ---------------------------------------------------------------------------
FLEET_NEW = 8                    # the reference's DECODE_NEW_TOKENS


def _fleet_model(spec: bool, device):
    """(model, params, engine kwargs): the lane's fast model, or for the
    speculative leg a high-agreement pair at the fast model's widths (the
    draft engaged under MXNET_SPEC_DECODE=1)."""
    if not spec:
        m = fast_model()
        return m, m.init_params(0, device=device), {}
    target, tp, draft, dp = sd.high_agreement_pair(
        vocab=128, d_model=64, target_layers=4, draft_layers=1, n_heads=4,
        max_seq=64, device=device)
    return target, tp, dict(draft=draft, draft_params=dp, spec_k=4)


def _fleet_fire(front, prompts, threads, rate, seed, deadline_us, out):
    """Poisson arrivals of ``prompts`` from ``threads`` clients through
    ``front``; fills ``out`` with delivered / shed / errors / outputs."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=len(prompts))
    lock = threading.Lock()
    out.update(delivered=0, shed=0, errors=[], outs=[None] * len(prompts))

    def fire(idx):
        def go():
            for i in idx:
                time.sleep(gaps[i])
                try:
                    toks = front.generate(prompts[i],
                                          max_new_tokens=FLEET_NEW,
                                          deadline_us=deadline_us)
                    with lock:
                        out["delivered"] += 1
                        out["outs"][i] = toks
                except sd.ShedError:
                    with lock:
                        out["shed"] += 1
                except BaseException as e:
                    out["errors"].append(repr(e))
        return go

    return [threading.Thread(target=fire(list(range(k, len(prompts),
                                                    threads))))
            for k in range(threads)]


def _exact(model, params, prompts, outs) -> bool:
    """Every delivered stream equals the eager loop's (checked once per
    distinct prompt)."""
    seen = {}
    for p, o in zip(prompts, outs):
        if o is None:
            continue
        key = str(p)
        if key not in seen:
            seen[key] = sd.eager_generate(model, params, p, FLEET_NEW)
        if o != seen[key]:
            return False
    return True


def run_router_storm(device="cuda", spec: bool = False,
                     requests: int = 48) -> dict:
    """The router storm (reference :326-381): 2 replicas behind a
    ReplicaRouter (breaker 2 errors, cooldown 0.5 s, hedging at p95),
    Poisson arrivals at 40/s from 8 clients, replica 0's program dispatch
    made to raise 0.3 s into the storm. The availability columns: dropped
    (must be 0), hedged, failed over, breaker transitions, p50/p99,
    tokens/s; and every delivery token-exact against the eager loop."""
    from mxnet_tpu_torch.serving_router import ReplicaRouter

    prev = os.environ.get("MXNET_SPEC_DECODE")
    os.environ["MXNET_SPEC_DECODE"] = "1" if spec else "0"
    try:
        model, params, kw = _fleet_model(spec, device)
        engines = [sd.GenerativeEngine(model, params=params,
                                       pool=sd.PagePool(pages=256, page=8),
                                       max_rows=8, name=f"rr{i}",
                                       device=device, **kw)
                   for i in range(2)]
        for e in engines:
            e.warmup(max_len=16)
        c0 = sd.trace_count() + sd.spec_trace_count()
        router = ReplicaRouter(engines, name="bench", breaker_errs=2,
                               breaker_cooldown_s=0.5, hedge_pctl=95)
        prompts = mk_prompts(np.random.RandomState(7), requests)
        res = {}
        threads = _fleet_fire(router, prompts, 8, 40.0, 8, 20_000_000, res)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(0.3)                  # the storm is rolling: kill 0

        def boom(*a, **k):
            raise RuntimeError("bench replica kill")

        engines[0]._call = boom
        engines[0]._spec_call = boom
        for t in threads:
            t.join(timeout=JOIN_S)
        wall = time.perf_counter() - t0
        st = router.stats()
        from mxnet_tpu_torch import engine as _engine
        _engine.waitall()
        out = {
            "spec": spec, "requests": len(prompts),
            "delivered": res["delivered"],
            "dropped": len(prompts) - res["delivered"] - res["shed"],
            "shed": res["shed"], "errors": res["errors"],
            "hedged": st["hedges"], "hedge_cancelled": st["hedge_cancelled"],
            "failed_over": st["failovers"],
            "breaker_transitions": (st["breaker_opens"]
                                    + st["breaker_half_opens"]
                                    + st["breaker_closes"]),
            "p50_us": st["p50_us"], "p99_us": st["p99_us"],
            "tokens_s": res["delivered"] * FLEET_NEW / wall,
            "wall_s": wall,
            "captures_after_warm": (sd.trace_count() + sd.spec_trace_count()
                                    - c0),
            "pool_in_use_after": [e.pool_in_use() for e in engines],
            "token_exact": _exact(model, params, prompts, res["outs"]),
        }
        if spec:
            out["spec_rounds"] = sum(e.stats()["spec_rounds"]
                                     for e in engines)
        router.close()
        for e in engines:
            e.close()
        return out
    finally:
        if prev is None:
            os.environ.pop("MXNET_SPEC_DECODE", None)
        else:
            os.environ["MXNET_SPEC_DECODE"] = prev


def run_elastic_storm(device="cuda", spec: bool = False,
                      requests: int = 288) -> dict:
    """The elastic storm (reference :383-470): 1 replica and a
    FleetSupervisor (1..3 replicas, cooldown 0.4 s, ticks every 50 ms, up
    at 1.0 queued a replica, down at 0.1) under Poisson arrivals at 60/s
    from 12 clients; an in-process joiner pays its warm-up captures. The
    columns: the replica-count timeline, scale events, fleet tokens/s,
    dropped (must be 0), and every delivery token-exact."""
    from mxnet_tpu_torch.serving_router import (FleetSupervisor,
                                                ReplicaRouter)

    prev = os.environ.get("MXNET_SPEC_DECODE")
    os.environ["MXNET_SPEC_DECODE"] = "1" if spec else "0"
    try:
        model, params, kw = _fleet_model(spec, device)
        made = []

        def spawn():
            e = sd.GenerativeEngine(model, params=params,
                                    pool=sd.PagePool(pages=256, page=8),
                                    max_rows=8, name="elastic",
                                    device=device, **kw)
            made.append(e)
            return e

        first = spawn()
        first.warmup(max_len=16)
        router = ReplicaRouter([first], name="elastic", breaker_errs=2,
                               breaker_cooldown_s=0.5, hedge_pctl=95)
        sup = FleetSupervisor(router, spawn,
                              retire=lambda e, i: None, enabled=True,
                              min_replicas=1, max_replicas=3,
                              cooldown_s=0.4, interval_s=0.05, up_queue=1.0,
                              down_queue=0.1, warmup_kwargs={"max_len": 16})
        sup.start()
        prompts = mk_prompts(np.random.RandomState(9), requests)
        res = {}
        threads = _fleet_fire(router, prompts, 12, 60.0, 10, 30_000_000,
                              res)
        timeline = []
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            timeline.append([round(time.perf_counter() - t0, 2),
                             router.serving_replicas()])
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=JOIN_S)
        wall = time.perf_counter() - t0
        # the burst subsided: the supervisor shrinks back to the floor
        t_min, t_max = time.perf_counter() + 3.0, time.perf_counter() + 20.0
        while time.perf_counter() < t_max and (
                time.perf_counter() < t_min
                or router.serving_replicas() > 1):
            timeline.append([round(time.perf_counter() - t0, 2),
                             router.serving_replicas()])
            time.sleep(0.05)
        sup.stop()
        fleet = router.fleet_stats()
        from mxnet_tpu_torch import engine as _engine
        _engine.waitall()
        out = {
            "spec": spec, "requests": len(prompts),
            "delivered": res["delivered"],
            "dropped": len(prompts) - res["delivered"] - res["shed"],
            "shed": res["shed"], "errors": res["errors"],
            "scale_ups": fleet["scale_ups"],
            "scale_downs": fleet["scale_downs"], "joins": fleet["joins"],
            "drains": fleet["drains"], "scale_errors": fleet["scale_errors"],
            "warm_programs": fleet["warm_programs"],
            "peak_replicas": max((n for _, n in timeline), default=1),
            "final_replicas": router.serving_replicas(),
            "replica_timeline": timeline[:400],
            "fleet_tokens_s": res["delivered"] * FLEET_NEW / wall,
            "wall_s": wall,
            "pool_in_use_after": [e.pool_in_use() for e in made],
            "token_exact": _exact(model, params, prompts, res["outs"]),
        }
        router.close()
        for e in made:
            e.close()
        return out
    finally:
        if prev is None:
            os.environ.pop("MXNET_SPEC_DECODE", None)
        else:
            os.environ["MXNET_SPEC_DECODE"] = prev


def run_shared_prefix(users: int = 16, new_tokens: int = 8, device="cuda"
                      ) -> dict:
    """USERS copies of one 32-token system prompt (4 full page-8 blocks),
    warm (prefix cache on) and cold (off), over the same seeds."""
    from mxnet_tpu_torch import config

    model = fast_model()
    params = model.init_params(0, device)
    rng = np.random.RandomState(0)
    system = rng.randint(0, 128, size=32).tolist()

    def storm(knob):
        prev = os.environ.get("MXNET_PREFIX_CACHE")
        os.environ["MXNET_PREFIX_CACHE"] = knob
        config.refresh("MXNET_PREFIX_CACHE")
        pool = sd.PagePool(pages=256, page=8)
        eng = sd.GenerativeEngine(model, params=params, pool=pool,
                                  max_rows=max(8, users), name="px" + knob,
                                  device=device)
        try:
            eng.warmup(max_len=16)
            eng.generate(rng.randint(0, 128, size=5).tolist(),
                         max_new_tokens=2)
            base = telemetry.snapshot()
            p0 = eng.stats()["prefills"]
            t0 = time.perf_counter()
            first = eng.generate(list(system), max_new_tokens=new_tokens)
            _wall, _tok, _shed, outs = drive(
                eng, [list(system)] * (users - 1), users - 1, new_tokens)
            wall = time.perf_counter() - t0
            delta = telemetry.delta(base)
            prefills = eng.stats()["prefills"] - p0
        finally:
            eng.close()
            if prev is None:
                os.environ.pop("MXNET_PREFIX_CACHE", None)
            else:
                os.environ["MXNET_PREFIX_CACHE"] = prev
        if pool.in_use() or pool.audit():
            raise RuntimeError(f"pool leaked or unsound (knob {knob}): "
                               f"{pool.in_use()} {pool.audit()}")
        px = {k.split(".", 1)[1]: int(v) for k, v in delta.items()
              if k.startswith("prefix.")}
        return [first] + outs, wall, px, prefills

    warm, warm_wall, px, warm_prefills = storm("1")
    cold, cold_wall, px_off, cold_prefills = storm("0")
    oracle = sd.eager_generate(model, params, system, new_tokens)
    hit, miss = px.get("hit_blocks", 0), px.get("miss_blocks", 0)
    return {
        "users": users, "prompt_tokens": len(system),
        "new_tokens": new_tokens,
        "prefix_hit_rate": hit / max(hit + miss, 1),
        "prefix_hit_blocks": hit, "prefix_miss_blocks": miss,
        "prefix_cow_forks": px.get("cow_forks", 0),
        "prefix_counters_off": {k: v for k, v in px_off.items() if v},
        "prefills_warm": warm_prefills, "prefills_cold": cold_prefills,
        "warm_tokens_s": users * new_tokens / warm_wall,
        "cold_tokens_s": users * new_tokens / cold_wall,
        "token_exact": all(o == oracle for o in warm + cold),
    }


# ---------------------------------------------------------------------------
# speculative decoding (the reference's --speculative lane)
# ---------------------------------------------------------------------------
def _spec_pass(target, tp, prompts, new_tokens, spec_on, draft=None,
               dparams=None, k=4, label="x", device="cuda"):
    """One pass of the prompt set from one client thread per request;
    tokens/s, the outputs and the engine's spec counters and cost table."""
    prev = os.environ.get("MXNET_SPEC_DECODE")
    os.environ["MXNET_SPEC_DECODE"] = "1" if spec_on else "0"
    pool = sd.PagePool(pages=256, page=8)
    kw = (dict(draft=draft, draft_params=dparams, spec_k=k)
          if draft is not None else {})
    # max_rows=2: decode-bound rows, the workload the k-for-1 verify
    # targets (wide batches amortize the dispatch on their own)
    eng = sd.GenerativeEngine(target, params=tp, pool=pool, max_rows=2,
                              name="spec_" + label, device=device, **kw)
    try:
        eng.warmup(max_len=16)
        eng.generate(prompts[0], max_new_tokens=2)
        t0 = sd.trace_count() + sd.spec_trace_count()
        wall, tokens, sheds, outs = drive(eng, prompts, len(prompts),
                                          new_tokens)
        st = eng.stats()
        cost = dict(eng._cost)
        captures = sd.trace_count() + sd.spec_trace_count() - t0
    finally:
        eng.close()
        if prev is None:
            os.environ.pop("MXNET_SPEC_DECODE", None)
        else:
            os.environ["MXNET_SPEC_DECODE"] = prev
    if sheds or pool.in_use() or pool.audit():
        raise RuntimeError(f"speculative lane ({label}): {sheds} sheds, "
                           f"{pool.in_use()} pages leaked, audit "
                           f"{pool.audit()}")

    def ms(key):
        return None if key not in cost else cost[key] * 1e3

    return {
        "outs": outs, "wall_s": wall, "tokens": tokens,
        "tokens_s": tokens / wall, "captures_after_warm": captures,
        "rounds": st["spec_rounds"], "proposed": st["spec_proposed"],
        "accepted": st["spec_accepted"], "fallbacks": st["spec_fallbacks"],
        "disabled": st["spec_disabled"], "decode_steps": st["decode_steps"],
        "draft_round_ms": ms(("spec", "draft")),
        "verify_ms": ms(("spec_verify", k)), "decode_step_ms": ms("decode"),
    }


def run_speculative(requests: int = 12, new_tokens: int = 24, k: int = 4,
                    device="cuda") -> dict:
    """The speculative lane: the baseline, the low-agreement leg and the
    high-agreement leg over one seeded greedy prompt set (prompts of 4-12
    tokens), each held token-exact against the eager loop. The pair is a
    deep target whose extra layers are the identity, so that the draft's
    logits are the target's (acceptance 1.0) while the target pays 8x the
    draft's per-token compute."""
    target, tp, draft, dp = sd.high_agreement_pair(
        vocab=128, d_model=64, target_layers=8, draft_layers=1, n_heads=4,
        max_seq=96, seed=0, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, size=rng.randint(4, 13)).tolist()
               for _ in range(requests)]
    base = _spec_pass(target, tp, prompts, new_tokens, False, label="base",
                      device=device)
    # the low-agreement leg first (an independently drawn draft whose
    # proposals rarely match): the arbiter must auto-disable it
    low_draft = sd.TinyCausalLM(vocab=128, d_model=64, n_layers=1,
                                n_heads=4, max_seq=96)
    low = _spec_pass(target, tp, prompts, new_tokens, True, low_draft,
                     low_draft.init_params(99, device=device), k,
                     label="low", device=device)
    on = _spec_pass(target, tp, prompts, new_tokens, True, draft, dp, k,
                    label="on", device=device)
    oracle = [sd.eager_generate(target, tp, p, new_tokens) for p in prompts]
    out = {
        "device": str(torch.device(device)), "requests": requests,
        "new_tokens": new_tokens, "spec_k": k,
        "baseline_tokens_s": base["tokens_s"],
        "spec_tokens_s": on["tokens_s"],
        "speedup": on["tokens_s"] / max(base["tokens_s"], 1e-9),
        "acceptance": on["accepted"] / max(on["proposed"], 1),
        "token_exact": all(r["outs"] == oracle for r in (base, low, on)),
        "rounds": on["rounds"], "proposed": on["proposed"],
        "accepted": on["accepted"], "fallback_rounds": on["fallbacks"],
        "tokens_per_round": on["tokens"] / max(on["rounds"], 1),
        "target_dispatches_per_token": (on["decode_steps"] + on["rounds"])
        / max(on["tokens"], 1),
        "captures_after_warm": base["captures_after_warm"]
        + low["captures_after_warm"] + on["captures_after_warm"],
        "draft_round_ms": on["draft_round_ms"], "verify_ms": on["verify_ms"],
        "baseline_decode_step_ms": base["decode_step_ms"],
        "low_agreement": {
            "tokens_s": low["tokens_s"],
            "ratio_vs_baseline": low["tokens_s"] / max(base["tokens_s"],
                                                       1e-9),
            "autodisabled": low["disabled"],
            "rounds_before_disable": low["rounds"],
        },
    }
    return out


def check_bars(decode=None, serve=None, storm=None, prefix=None,
               spec=None, fleet=None) -> list:
    """The lanes' bars the results miss (empty when all hold)."""
    bad = []
    for leg in (fleet or {}).values():
        name = ("router" if "hedged" in leg else "elastic") + \
            (" spec" if leg["spec"] else "")
        if leg["dropped"] or leg["errors"]:
            bad.append(f"{name} storm dropped {leg['dropped']} request(s), "
                       f"errors {leg['errors'][:2]}")
        if not leg["token_exact"]:
            bad.append(f"{name} storm delivered a stream that is not the "
                       "eager loop's")
        if any(leg["pool_in_use_after"]):
            bad.append(f"{name} storm left pages in use "
                       f"{leg['pool_in_use_after']}")
    if spec is not None:
        if not spec["token_exact"]:
            bad.append("speculative lane not token-exact against the "
                       "eager loop")
        if spec["acceptance"] < BARS["spec_acceptance"]:
            bad.append(f"spec acceptance {spec['acceptance']:.3f} < "
                       f"{BARS['spec_acceptance']}")
        if spec["speedup"] < BARS["spec_speedup"]:
            bad.append(f"spec speedup {spec['speedup']:.2f} < "
                       f"{BARS['spec_speedup']}")
        low = spec["low_agreement"]
        if not low["autodisabled"]:
            bad.append("the low-agreement draft never auto-disabled")
        if low["ratio_vs_baseline"] < BARS["spec_low_ratio"]:
            bad.append(f"low-agreement leg at {low['ratio_vs_baseline']:.2f}"
                       f"x the baseline (< {BARS['spec_low_ratio']})")
        if spec["captures_after_warm"]:
            bad.append(f"{spec['captures_after_warm']} captures after "
                       "warm-up in the speculative lane")
    if decode is not None:
        if decode["concurrency"] >= BARS["min_concurrency"] and \
                decode["batching_speedup"] < BARS["batching_speedup"]:
            bad.append(f"batching speedup {decode['batching_speedup']:.2f} "
                       f"< {BARS['batching_speedup']}")
        if decode["retraces_after_warm"]:
            bad.append(f"{decode['retraces_after_warm']} decode captures "
                       "after warm-up")
    if serve is not None and serve["bucket_refused"] is None:
        if serve["retraces_after_warm"]:
            bad.append(f"{serve['retraces_after_warm']} serving captures "
                       "after warm-up")
        if serve["programs"] > serve["warmup_programs"]:
            bad.append(f"{serve['programs']} serving programs > "
                       f"{serve['warmup_programs']} buckets")
    if storm is not None and \
            storm["interference_p99_ratio"] > BARS["interference_p99_ratio"]:
        bad.append(f"storm p99 ratio {storm['interference_p99_ratio']:.2f}"
                   f" > {BARS['interference_p99_ratio']}")
    if prefix is not None:
        if prefix["prefix_hit_rate"] < BARS["prefix_hit_rate"]:
            bad.append(f"prefix hit rate {prefix['prefix_hit_rate']:.3f} "
                       f"< {BARS['prefix_hit_rate']}")
        if not prefix["token_exact"] or prefix["prefix_counters_off"]:
            bad.append("shared-prefix lane not token-exact, or counters "
                       "moved with the cache off")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--storm", action="store_true")
    ap.add_argument("--shared-prefix", action="store_true")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--router", action="store_true",
                    help="the router storm and the elastic storm, each "
                         "plain and speculative")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if not (args.serve or args.decode or args.storm or args.shared_prefix
            or args.speculative or args.router):
        args.serve = args.decode = args.storm = args.shared_prefix = True
        args.speculative = args.router = True
    out = {}
    if args.serve:
        out["serving"] = run_serving(requests=args.requests or 64,
                                     device=args.device)
    if args.decode:
        out["decode"] = run_decode(requests=args.requests or 16,
                                   device=args.device,
                                   profile=args.device != "cpu")
    if args.storm:
        out["storm"] = run_storm(args.device)
    if args.shared_prefix:
        out["shared_prefix"] = run_shared_prefix(device=args.device)
    if args.speculative:
        out["speculative"] = run_speculative(requests=args.requests or 12,
                                             device=args.device)
    if args.router:
        out["fleet"] = {
            "router_storm": run_router_storm(args.device),
            "router_storm_spec": run_router_storm(args.device, spec=True),
            "elastic_storm": run_elastic_storm(args.device),
            "elastic_storm_spec": run_elastic_storm(args.device,
                                                    spec=True)}
    out["bars_missed"] = check_bars(out.get("decode"), out.get("serving"),
                                    out.get("storm"),
                                    out.get("shared_prefix"),
                                    out.get("speculative"),
                                    out.get("fleet"))
    if torch.device(args.device).type == "cuda":
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(out, indent=None if args.json else 1, default=str))
    return 1 if out["bars_missed"] else 0


if __name__ == "__main__":
    sys.exit(main())
