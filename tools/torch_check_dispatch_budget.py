#!/usr/bin/env python3
"""Gate: the port's replica router and speculative decoding stay inside
their dispatch budgets.

    python3 tools/torch_check_dispatch_budget.py [--device cuda|cpu]
        [--json]

The port of two lanes of ``tools/check_dispatch_budget.py``, with their
gates (reference :1150-1210); its other lanes (the compiled train step,
AMP, the one-shot and decode serving lanes, the mesh, the sentinel and the
program-store worker) are still to be ported (ROADMAP):

- **router** (reference :729-808), the zero-overhead-off rule: the same
  sequential request stream through a bare ``GenerativeEngine`` and
  through a ``ReplicaRouter`` over that one replica (hedging off, breaker
  closed, no supervisor) must cost the same dispatches, the same captures
  and the same host syncs, with the same token streams and 0 leaked
  pages; with ``MXNET_TELEMETRY_TRACE=0`` as well, and then no trace field
  on any event or span.
- **spec** (reference :810-940): a high-agreement draft under
  ``MXNET_SPEC_DECODE=1`` drives a mixed greedy / sampled join-retire
  storm: programs bounded by the warm-up grid across both namespaces
  (``serving_decode`` and ``serving_spec``), 0 captures after warm-up, < 1
  target dispatch per committed token, acceptance >= 0.7, greedy rows
  token-exact against the eager oracle, 0 leaked pages; then the off leg:
  the same greedy stream through a draft-attached engine with
  ``MXNET_SPEC_DECODE=0`` costs a draft-free engine's dispatches and
  captures, with the same tokens.

The engines run on ``--device`` (default ``cuda``; ``cpu`` on a machine
without a GPU and in the CPU tests). Prints one JSON line a lane and exits
1 when a budget breaks.
"""
import argparse
import contextlib
import json
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROUTER_BUDGET = {"extra_dispatches": 0, "extra_retraces": 0,
                 "extra_host_syncs": 0}
SPEC_BUDGET = {"retraces_after_warm": 0, "programs_over_grid": 0,
               "leaked_pages": 0, "greedy_off_extra_dispatches": 0,
               "greedy_off_extra_retraces": 0}
TRACED_OFF = ("traced_off_extra_dispatches", "traced_off_extra_retraces",
              "traced_off_extra_host_syncs", "traced_off_trace_fields")


def _host_syncs() -> int:
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ndarray import host_sync_count

    return int(host_sync_count()) + int(engine.sync_count())


@contextlib.contextmanager
def _env(name, value):
    """``os.environ[name] = value`` inside the scope (the knobs read here
    are uncached)."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def measure_router(device: str = "cuda") -> dict:
    """Zero-overhead-off lane: the same sequential request stream through a
    bare GenerativeEngine and through a ReplicaRouter over one replica
    (hedging off, breaker closed)."""
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.serving_router import ReplicaRouter

    model = sd.TinyCausalLM(vocab=31, d_model=16, n_layers=1, n_heads=2,
                            max_seq=32)
    params = model.init_params(5, device=device)
    prompts = [[1 + (i * 3 + j) % 29 for j in range(3 + i % 3)]
               for i in range(6)]

    def run(route: bool) -> dict:
        pool = sd.PagePool(pages=32, page=4)
        eng = sd.GenerativeEngine(model, params=params, pool=pool,
                                  max_rows=2, name="lane", device=device)
        eng.warmup(max_len=8)
        front = ReplicaRouter([eng], hedge_pctl=0) if route else eng
        t0, d0, h0 = sd.trace_count(), sd.dispatch_count(), _host_syncs()
        evs = tel.events()
        e0 = evs[-1]["seq"] if evs else 0
        sp0 = {id(s) for s in tel.spans()}
        outs = [front.generate(p, max_new_tokens=5) for p in prompts]
        new_evs = [e for e in tel.events() if e["seq"] > e0]
        new_sps = [s for s in tel.spans() if id(s) not in sp0]
        row = {"outs": outs,
               "dispatches": sd.dispatch_count() - d0,
               "retraces": sd.trace_count() - t0,
               "host_syncs": _host_syncs() - h0,
               "trace_fields": sum(1 for e in new_evs if "trace_id" in e)
               + sum(1 for s in new_sps if "trace_id" in s),
               "leaked_pages": pool.in_use()}
        if route:
            front.close()
        eng.close()
        return row

    bare = run(False)
    routed = run(True)
    with _env("MXNET_TELEMETRY_TRACE", "0"):
        routed_off = run(True)
    return {
        "mode": "router", "device": device,
        "requests": len(prompts),
        "bare_dispatches": bare["dispatches"],
        "routed_dispatches": routed["dispatches"],
        "extra_dispatches": routed["dispatches"] - bare["dispatches"],
        "extra_retraces": routed["retraces"] - bare["retraces"],
        "extra_host_syncs": routed["host_syncs"] - bare["host_syncs"],
        "outputs_equal": bare["outs"] == routed["outs"],
        "leaked_pages": (bare["leaked_pages"] + routed["leaked_pages"]
                         + routed_off["leaked_pages"]),
        "traced_off_outputs_equal": routed_off["outs"] == bare["outs"],
        "traced_off_extra_dispatches":
            routed_off["dispatches"] - bare["dispatches"],
        "traced_off_extra_retraces":
            routed_off["retraces"] - bare["retraces"],
        "traced_off_extra_host_syncs":
            routed_off["host_syncs"] - bare["host_syncs"],
        "traced_off_trace_fields": routed_off["trace_fields"],
    }


def measure_spec(device: str = "cuda") -> dict:
    """Speculative lane: a high-agreement draft drives a mixed greedy /
    sampled join-retire storm; then the off leg against a draft-free
    engine."""
    import numpy as onp

    from mxnet_tpu_torch import engine as _engine
    from mxnet_tpu_torch import serving_decode as sd

    target, tp, draft, dp = sd.high_agreement_pair(
        vocab=41, d_model=16, target_layers=2, draft_layers=1, n_heads=2,
        max_seq=64, seed=5, device=device)
    rng = onp.random.RandomState(23)
    prompts = [rng.randint(0, 41, size=rng.randint(1, 10)).tolist()
               for _ in range(8)]
    budgets = [6, 9, 4, 8, 5, 7, 10, 6]
    samps = [None if i % 2 == 0
             else sd.SamplingSpec(temperature=0.9, top_k=7, top_p=0.95,
                                  seed=100 + i)
             for i in range(8)]
    with _env("MXNET_SPEC_DECODE", "1"):
        pool = sd.PagePool(pages=96, page=4)
        eng = sd.GenerativeEngine(target, params=tp, pool=pool, max_rows=4,
                                  name="spec_lane", draft=draft,
                                  draft_params=dp, spec_k=4, device=device)
        grid = eng.warmup(max_len=16)
        t0 = sd.trace_count() + sd.spec_trace_count()
        d0 = sd.dispatch_count() + sd.spec_dispatch_count()
        outs: list = [None] * 8
        errs: list = []

        def fire(i):
            try:
                outs[i] = eng.generate(prompts[i], max_new_tokens=budgets[i],
                                       sampling=samps[i])
            except BaseException as e:
                errs.append(repr(e))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _engine.waitall()
        st = eng.stats()
        greedy_exact = all(
            outs[i] == sd.eager_generate(target, tp, prompts[i], budgets[i])
            for i in range(0, 8, 2) if outs[i] is not None)
        tokens = sum(len(o) for o in outs if o is not None)
        target_dispatches = st["decode_steps"] + st["spec_rounds"]
        row = {
            "mode": "spec", "device": device,
            "errors": errs,
            "warmup_programs": grid,
            "programs": st["programs"] + st["spec_programs"],
            "programs_over_grid":
                max(0, st["programs"] + st["spec_programs"] - grid),
            "retraces_after_warm":
                (sd.trace_count() + sd.spec_trace_count()) - t0,
            "dispatches":
                (sd.dispatch_count() + sd.spec_dispatch_count()) - d0,
            "spec_rounds": st["spec_rounds"],
            "spec_proposed": st["spec_proposed"],
            "spec_accepted": st["spec_accepted"],
            "acceptance": st["spec_accepted"] / max(st["spec_proposed"], 1),
            "spec_disabled": st["spec_disabled"],
            "tokens": tokens,
            "target_dispatches_per_token":
                target_dispatches / max(tokens, 1),
            "greedy_token_exact": greedy_exact,
            "leaked_pages": pool.in_use(),
        }
        eng.close()

    def run_off(with_draft: bool) -> dict:
        pool2 = sd.PagePool(pages=64, page=4)
        kw = (dict(draft=draft, draft_params=dp, spec_k=4)
              if with_draft else {})
        e2 = sd.GenerativeEngine(target, params=tp, pool=pool2, max_rows=2,
                                 name="spec_off", device=device, **kw)
        e2.warmup(max_len=16)
        t1 = sd.trace_count() + sd.spec_trace_count()
        d1 = sd.dispatch_count() + sd.spec_dispatch_count()
        toks = [e2.generate(p, max_new_tokens=5) for p in prompts[:4]]
        got = {
            "outs": toks,
            "dispatches":
                (sd.dispatch_count() + sd.spec_dispatch_count()) - d1,
            "retraces": (sd.trace_count() + sd.spec_trace_count()) - t1,
            "leaked_pages": pool2.in_use(),
        }
        e2.close()
        return got

    with _env("MXNET_SPEC_DECODE", "0"):
        bare = run_off(False)
        offd = run_off(True)
    row["greedy_off_extra_dispatches"] = (offd["dispatches"]
                                          - bare["dispatches"])
    row["greedy_off_extra_retraces"] = offd["retraces"] - bare["retraces"]
    row["greedy_off_outputs_equal"] = offd["outs"] == bare["outs"]
    row["leaked_pages"] += bare["leaked_pages"] + offd["leaked_pages"]
    return row


def gate(router: dict, spec: dict) -> list:
    """The lanes' failures (reference :1150-1210)."""
    failures = []
    if spec["errors"]:
        failures.append(f"spec storm errors: {spec['errors']}")
    for key, budget in SPEC_BUDGET.items():
        if spec[key] > budget:
            failures.append(
                f"spec {key} = {spec[key]} exceeds budget {budget}")
    if spec["spec_rounds"] == 0 or spec["spec_disabled"]:
        failures.append(
            "spec lane never engaged speculation (0 rounds or "
            "auto-disabled) on the high-agreement fixture")
    if spec["acceptance"] < 0.7:
        failures.append(
            f"spec acceptance {spec['acceptance']:.2f} < 0.7 on the "
            "high-agreement draft (rejection sampling broken?)")
    if spec["target_dispatches_per_token"] >= 1.0:
        failures.append(
            f"spec pays {spec['target_dispatches_per_token']:.2f} target "
            "dispatches per committed token (must be < 1: the k-for-1 "
            "verify win is gone)")
    if not spec["greedy_token_exact"]:
        failures.append(
            "spec greedy rows diverge from the eager oracle "
            "(token-exactness broken under speculation)")
    if not spec["greedy_off_outputs_equal"]:
        failures.append(
            "MXNET_SPEC_DECODE=0 draft-attached token streams differ from "
            "the draft-free engine's")
    for key, budget in ROUTER_BUDGET.items():
        if router[key] > budget:
            failures.append(
                f"router {key} = {router[key]} exceeds budget {budget} "
                "(zero-overhead-off broken)")
    if not router["outputs_equal"]:
        failures.append(
            "router-wrapped token streams differ from the bare engine's")
    if router["leaked_pages"]:
        failures.append(
            f"router lane leaked {router['leaked_pages']} KV pages")
    if not router["traced_off_outputs_equal"]:
        failures.append(
            "router token streams under MXNET_TELEMETRY_TRACE=0 differ "
            "from the bare engine's")
    for key in TRACED_OFF:
        if router[key] != 0:
            failures.append(
                f"router {key} = {router[key]} with tracing disabled (must "
                "be 0: zero overhead when off)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_check_dispatch_budget: no CUDA device (pass "
                  "--device cpu)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
    router = measure_router(a.device)
    spec = measure_spec(a.device)
    print(f"torch_check_dispatch_budget: {json.dumps(router)}")
    print(f"torch_check_dispatch_budget: {json.dumps(spec, default=str)}")
    failures = gate(router, spec)
    if failures:
        print("torch_check_dispatch_budget: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("torch_check_dispatch_budget: router and spec lanes inside "
          "their budgets")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
