#!/usr/bin/env python3
"""Gate: the port's serving plane has a MEASURED availability budget.

    python3 tools/torch_check_availability_budget.py [scenario ...]
        [--device cuda|cpu] [--json]

The port of ``tools/check_availability_budget.py``: runs the
``mxnet_tpu_torch.drills`` router matrix (``ROUTER_SCENARIOS``: a replica
killed mid-decode plus a preemption drain, a wedged dispatch, a breaker
flap, a deadline storm, a shared-prefix storm, the scale storm and the
host loss with replica processes, a poisoned draft) against a 2-replica
``serving_router.ReplicaRouter`` and exits 1 unless:

- every scenario is green: 0 dropped requests (every submission ends
  delivered or typed-shed), every delivery token-exact against the
  uninterrupted ``eager_generate`` oracle, 0 captures after warm-up;
- failover is bounded: chaos p99 <= ``failover_p99_mult`` x steady p99 +
  ``failover_p99_slack_s``;
- nothing leaks: 0 KV pages in use after ``engine.waitall()`` and a clean
  ``PagePool.audit()``;
- the breaker re-admits within ``breaker_readmit_s`` after a flap;
- an infeasible ``deadline_us`` sheds ``ShedError(kind="deadline")``
  within its budget + ``deadline_overrun_s`` (held inside the drill);
- the elastic fleet heals itself: every joiner serves its first request
  within ``join_first_serve_s`` of its spawn (process start, CUDA
  initialization and its warm-up captures included: the port has no
  persistent program cache) and shrinks back through exit 83; a SIGKILLed
  replica costs at most ``kill_recover_s`` before the fleet delivers again;
- a poisoned draft costs zero availability: speculation turned off by the
  engine's acceptance cutoff, plain decode in place.

``BUDGET`` is the reference's (``tools/check_availability_budget.py``),
value for value. The children run on ``--device`` (default ``cuda``;
``cpu`` on a machine without a GPU and in the CPU tests). One JSON line
a scenario; exit 0 when every budget holds.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BUDGET = {
    "dropped": 0,
    "leaked_kv_pages": 0,
    "failover_p99_mult": 10.0,
    "failover_p99_slack_s": 5.0,
    "breaker_readmit_s": 8.0,
    "deadline_overrun_s": 1.0,     # held inside the drill itself
    "join_first_serve_s": 90.0,
    "kill_recover_s": 10.0,
}

LINE_KEYS = ("scenario", "device", "ok", "dropped", "delivered",
             "leaked_pages", "steady_p99_s", "chaos_p99_s", "failovers",
             "breaker_opens", "breaker_closes", "re_admit_s", "drain_s",
             "join_to_first_served_s", "kill_to_recovered_s",
             "spec_autodisabled", "warmup_captures",
             "captures_after_warmup", "drill_wall_s")


def budget_failures(name: str, rep: dict) -> list:
    """The budget lines one report breaks (the drill's own contract
    failures included)."""
    failures = [f"{name}: {f}" for f in rep["failures"]]
    if rep.get("dropped"):
        failures.append(
            f"{name}: {rep['dropped']} request(s) dropped (budget: 0, "
            "every request delivered or typed-shed)")
    if rep.get("leaked_pages") not in (None, BUDGET["leaked_kv_pages"]):
        failures.append(
            f"{name}: {rep['leaked_pages']} KV pages leaked (budget: 0)")
    steady, chaos = rep.get("steady_p99_s"), rep.get("chaos_p99_s")
    if steady and chaos is not None:
        cap = (steady * BUDGET["failover_p99_mult"]
               + BUDGET["failover_p99_slack_s"])
        if chaos > cap:
            failures.append(
                f"{name}: chaos p99 {chaos:.3f}s exceeds "
                f"{BUDGET['failover_p99_mult']}x steady p99 "
                f"({steady:.3f}s) + {BUDGET['failover_p99_slack_s']}s")
    if name == "router_flap":
        ra = rep.get("re_admit_s")
        if ra is not None and ra > BUDGET["breaker_readmit_s"]:
            failures.append(
                f"{name}: breaker re-admitted after {ra:.2f}s (probe "
                f"budget {BUDGET['breaker_readmit_s']}s)")
    if name == "router_scale_storm":
        js = rep.get("join_to_first_served_s")
        if js is not None and js > BUDGET["join_first_serve_s"]:
            failures.append(
                f"{name}: slowest join served its first request after "
                f"{js:.2f}s (wall {BUDGET['join_first_serve_s']}s)")
    if name == "spec_draft_poison":
        spec = rep.get("spec") or []
        if spec and not any(s.get("spec_rounds") for s in spec):
            failures.append(
                f"{name}: no spec rounds: the drill exercised plain "
                "decode only")
    if name == "router_host_loss":
        kr = rep.get("kill_to_recovered_s")
        if kr is not None and kr > BUDGET["kill_recover_s"]:
            failures.append(
                f"{name}: first delivery {kr:.2f}s after the SIGKILL "
                f"(wall {BUDGET['kill_recover_s']}s)")
    return failures


def run(names, device: str, root=None):
    """(reports, failures) of the named scenarios under one root."""
    from mxnet_tpu_torch.drills import run_drill

    root = root or tempfile.mkdtemp(prefix="mxnet-torch-availability-")
    reports, failures = [], []
    for name in names:
        rep = run_drill(name, root, device=device)
        reports.append(rep)
        failures += budget_failures(name, rep)
    return reports, failures


def main(argv=None) -> int:
    from mxnet_tpu_torch.drills import ROUTER_SCENARIOS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None)
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    names = a.scenarios or list(ROUTER_SCENARIOS)
    reports, failures = run(names, a.device, a.root)
    for rep in reports:
        line = {k: rep.get(k) for k in LINE_KEYS}
        print(f"torch_check_availability_budget: "
              f"{json.dumps(line, default=str)}")
    if failures:
        print("torch_check_availability_budget: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"torch_check_availability_budget: {len(names)} scenario(s) "
          "green: 0 dropped, 0 leaked pages, failover p99 inside budget, "
          "breaker re-admitted, deadlines honest")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
