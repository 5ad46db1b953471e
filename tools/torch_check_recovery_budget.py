#!/usr/bin/env python3
"""Gate: preemption survival in the port has a MEASURED recovery budget.

    python3 tools/torch_check_recovery_budget.py [scenario ...]
        [--device cuda|cpu]

The port of ``tools/check_recovery_budget.py``: runs the
``mxnet_tpu_torch.drills`` recovery matrix (``SCENARIOS``: real
subprocesses, real SIGTERM / SIGKILL, a world of 4 restored into a world
of 2, a corrupted checkpoint, a mid-stream decode kill, a flipped bit on
one rank, a poisoned batch) and exits 1 unless:

- every scenario is green (bitwise resumed loss trajectories, token-exact
  decode completions and re-queues, typed ``draining`` sheds, the
  distinguished preemption exit code);
- a graceful drain replays 0 steps and a SIGKILL exactly the save gap;
- a restart or a rollback captures nothing after its warm-up
  (``captures_after_warmup == 0``: where the reference holds 0 fresh
  compiles on a warm ``MXNET_PROGRAM_CACHE_DIR``, the port, which has no
  persistent program cache, holds that a restored step replays the program
  its warm-up captured);
- nothing leaks: 0 KV pages after the decode drain, 0 temp checkpoint
  files after a kill;
- recovery fits the reference's walls: restore under ``recovery_s_max``
  and process start to first resumed step under ``recovery_wall_s_max``.

``BUDGET`` is the reference's bounds, with ``warm_recovery_fresh_compiles``
read as captures after warm-up. Children run on ``--device`` (default
``cuda``); ``topology_change`` and ``bitflip_param`` always run as gloo
worlds on the CPU. One JSON line a scenario; exit 0 when every budget
holds.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BUDGET = {
    "graceful_steps_replayed": 0,
    "warm_recovery_captures_after_warmup": 0,
    "leaked_kv_pages": 0,
    "leaked_tmp_files": 0,
    "recovery_s_max": 60.0,
    "recovery_wall_s_max": 120.0,
}

LINE_KEYS = ("scenario", "device", "ok", "recovery_s", "recovery_wall_s",
             "steps_replayed", "drain_s", "warmup_captures",
             "captures_after_warmup", "restored_at", "drill_wall_s")


def budget_failures(name: str, rep: dict) -> list:
    failures = [f"{name}: {f}" for f in rep["failures"]]
    n = rep.get("captures_after_warmup")
    if n is not None and n != BUDGET["warm_recovery_captures_after_warmup"]:
        failures.append(
            f"{name}: recovery captured {n} program(s) after its warm-up "
            "(budget: 0)")
    if name == "sigterm_drain" and rep.get("steps_replayed") not in (
            None, BUDGET["graceful_steps_replayed"]):
        failures.append(
            f"{name}: graceful drain replayed {rep['steps_replayed']} "
            "steps (budget: 0)")
    if rep.get("leaked_pages") not in (None, BUDGET["leaked_kv_pages"]):
        failures.append(
            f"{name}: {rep['leaked_pages']} KV pages leaked (budget: 0)")
    if rep.get("leaked_tmp"):
        failures.append(
            f"{name}: temp checkpoint litter {rep['leaked_tmp']} (budget: "
            "0 files)")
    if rep.get("recovery_s") is not None and \
            rep["recovery_s"] > BUDGET["recovery_s_max"]:
        failures.append(
            f"{name}: checkpoint restore took {rep['recovery_s']:.2f}s "
            f"(budget {BUDGET['recovery_s_max']}s)")
    if rep.get("recovery_wall_s") is not None and \
            rep["recovery_wall_s"] > BUDGET["recovery_wall_s_max"]:
        failures.append(
            f"{name}: restart->first-step took "
            f"{rep['recovery_wall_s']:.2f}s (budget "
            f"{BUDGET['recovery_wall_s_max']}s)")
    return failures


def run(names, device: str, root=None):
    from mxnet_tpu_torch.drills import run_drill

    root = root or tempfile.mkdtemp(prefix="mxnet-torch-recovery-")
    reports, failures = [], []
    for name in names:
        rep = run_drill(name, root, device=device)
        reports.append(rep)
        failures += budget_failures(name, rep)
    return reports, failures


def main(argv=None) -> int:
    from mxnet_tpu_torch.drills import SCENARIOS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None)
    a = ap.parse_args(argv)
    names = a.scenarios or list(SCENARIOS)
    reports, failures = run(names, a.device, a.root)
    for rep in reports:
        line = {k: rep.get(k) for k in LINE_KEYS}
        print(f"torch_check_recovery_budget: "
              f"{json.dumps(line, default=str)}")
    if failures:
        print("torch_check_recovery_budget: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"torch_check_recovery_budget: {len(names)} scenario(s) green, "
          "0 captures after warm-up on recovery, 0 leaks, inside the "
          "recovery budget")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
