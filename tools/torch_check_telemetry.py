#!/usr/bin/env python3
"""Gate: the port's counters are registered and tested, its steady state
is reproducible, and its traces carry what the tools read.

    python3 tools/torch_check_telemetry.py [--device cuda|cpu] [root]

The port of ``tools/check_telemetry.py`` over ``mxnet_tpu_torch/`` (its own
AST walk: the reference's, ``tools.lint``, reads ``mxnet_tpu/``):

1. **No unregistered counters** (reference :74-104). Every public
   ``<base>_count`` function or property is a view over a registered
   telemetry counter: ``<base>`` (or its plural) is the last segment of a
   registered name, or that segment behind the last word of the segment
   before it (``spec_dispatch_count`` over
   ``program_store.serving_spec.dispatches``). Raw module-level counter
   state (``_X_COUNT = 0``) and public ``self.x_count = <n>`` are refused
   outright.
2. **No untested counters** (:105). Every registered counter's name, or
   its ``family`` where it has one, appears in a ``tests/test_torch_*.py``
   file.
3. **Deterministic steady state** (:177). Two identical warm 3-step
   windows of a compiled ``TrainStep`` give byte-identical
   ``telemetry.delta()`` results over the deterministic counters, with 3
   train-step dispatches each.
4. **Chrome trace** (:198). One compiled train step inside a
   ``StepTimeline`` phase and one decode request, under the profiler,
   dump valid JSON with at least 3 span categories of ``train_step``,
   ``decode``, ``serving`` and ``step_phase``, ``train_step`` among them.
5. **Routed requests are traced** (:242). A 2-replica ``ReplicaRouter``
   driven through a failover, a deadline shed and a hedge stamps a
   non-empty ``trace_id`` on every ``failover``, ``shed`` and ``hedge``
   event.
6. **Prefix counters at zero with the knob off** (:359). Under
   ``MXNET_PREFIX_CACHE=0`` the same prompt twice moves no ``prefix.*``
   counter and leaves nothing resident in the pool.
7. **Merge correctness** (:401). Two processes (``--merge-worker``) run
   the same window and flush one flight-recorder shard each;
   ``telemetry.merge`` over the pair is exactly 2x one window on the
   deterministic counters.

The runtime checks run on ``--device`` (default ``cuda``; ``cpu`` on a
machine without a GPU and in the CPU tests) and run first, so that the
per-instance counter families they create are in the registry the static
checks read. Exits 1 when a check fails.
"""
import argparse
import ast
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List, Set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PACKAGE = "mxnet_tpu_torch"
TEST_GLOB = re.compile(r"^test_torch_.*\.py$")
_RAW_GLOBAL = re.compile(r"^_[A-Z0-9_]*_COUNTS?$")
_RAW_ATTR = re.compile(r"^[a-z0-9][a-z0-9_]*_count$")
_ATTR_ALLOW = {"last_count", "step_count"}
MERGE_WORKER = "--merge-worker"
# the counters a steady-state compiled train step may move: the windows
# compare exactly these, so that a thread of another test cannot move them
DETERMINISTIC_PREFIXES = ("program_store.train_step.", "cached_step.",
                          "spmd.", "sharding.", "metric.", "ndarray.",
                          "faults.", "telemetry.", "prefix.")
SPAN_CATS = {"train_step", "decode", "serving", "step_phase"}


def _py_files(root: str):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _sources(pkg_dir: str):
    pkg_dir = os.path.abspath(pkg_dir)
    base = os.path.dirname(pkg_dir)
    for path in _py_files(pkg_dir):
        with open(path, encoding="utf-8") as f:
            yield os.path.relpath(path, base), ast.parse(f.read(), path)


def collect_accessors(pkg_dir: str) -> Dict[str, Set[str]]:
    """Accessor base (the name less ``_count``) -> files declaring it: every
    public function or property named ``*_count`` except ``reset_*``."""
    acc: Dict[str, Set[str]] = {}
    for rel, tree in _sources(pkg_dir):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name.endswith("_count") \
                    and not node.name.startswith(("_", "reset_")):
                acc.setdefault(node.name[:-len("_count")], set()).add(rel)
    return acc


def collect_raw_state(pkg_dir: str) -> List[str]:
    """Counter state outside the registry: module-level ``_X_COUNT = <n>``
    and public ``self.x_count = <n>``."""
    raw = []
    for rel, tree in _sources(pkg_dir):
        module_level = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, (int, float))
                    and not isinstance(node.value.value, bool)):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and _RAW_GLOBAL.match(tgt.id) \
                        and id(node) in module_level:
                    raw.append(f"{rel}: {tgt.id} = ...")
                elif isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self" \
                        and _RAW_ATTR.match(tgt.attr) \
                        and tgt.attr not in _ATTR_ALLOW:
                    raw.append(f"{rel}: self.{tgt.attr} = ...")
    return sorted(raw)


def _segments(name: str) -> Set[str]:
    """The names an accessor may take over counter ``name``: its last
    segment, and that segment behind the last word of the one before."""
    parts = name.split(".")
    out = {parts[-1]}
    if len(parts) > 1:
        out.add(parts[-2].rsplit("_", 1)[-1] + "_" + parts[-1])
    return out


def check_registered(accessors: Dict[str, Set[str]],
                     registry: Dict[str, dict]) -> List[str]:
    """Accessors with no registered counter under them."""
    segs = set().union(*(_segments(n) for n in registry)) if registry \
        else set()
    return [f"{base}_count (declared in {', '.join(sorted(files))})"
            for base, files in sorted(accessors.items())
            if not {base, base + "s", base + "es"} & segs]


def tests_text(tests_dir: str) -> str:
    parts = []
    for name in sorted(os.listdir(tests_dir)):
        if TEST_GLOB.match(name):
            with open(os.path.join(tests_dir, name), encoding="utf-8") as f:
                parts.append(f.read())
    return "\n".join(parts)


def check_tested(registry: Dict[str, dict], tests_dir: str) -> List[str]:
    """Registered counters whose name (or family) no
    ``tests/test_torch_*.py`` file names. ``test.*`` counters are fixtures
    a test registered in this process."""
    text = tests_text(tests_dir)
    missing = set()
    for name, meta in registry.items():
        if name.startswith("test."):
            continue
        needle = meta.get("family") or name
        if needle not in text:
            missing.add(name if needle == name
                        else f"{name} (family {needle!r})")
    return sorted(missing)


# ---------------------------------------------------------------------------
# runtime checks
# ---------------------------------------------------------------------------
def _train_fixture(device: str):
    """A hybridized two-layer MLP on ``device``, its compiled SGD-momentum
    step and a seeded batch of 8."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = nn.Dense(16, in_units=8, activation="relu")
            self.out = nn.Dense(4, in_units=16)

        def forward(self, x):
            return self.out(self.d1(x))

    ctx = mx.cpu() if device == "cpu" else mx.gpu(0)
    net = Net()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    rng = onp.random.RandomState(0)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.tensor(rng.randn(*p.shape) * 0.1,
                                dtype=torch.float32))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    step = trainer.compile_step(
        net, lambda n, x, y: ((n(x) - y) ** 2).mean())
    x = torch.tensor(rng.randn(8, 8), dtype=torch.float32, device=device)
    y = torch.tensor(rng.randn(8, 4), dtype=torch.float32, device=device)
    return step, x, y


def _steady_delta(telemetry, step, x, y, n: int = 3) -> Dict[str, object]:
    base = telemetry.snapshot()
    for _ in range(n):
        loss = step(x, y, batch_size=8)
    loss.detach().cpu()
    kinds = telemetry.registered()
    return {k: v for k, v in telemetry.delta(base).items()
            if k.startswith(DETERMINISTIC_PREFIXES)
            and kinds.get(k, {}).get("kind") == "cumulative"}


def check_deterministic_snapshot(device: str = "cuda") -> List[str]:
    from mxnet_tpu_torch import telemetry

    step, x, y = _train_fixture(device)
    for _ in range(2):                    # warm: the eager run and capture
        loss = step(x, y, batch_size=8)
    loss.detach().cpu()
    if step.last_fallback_reason is not None:
        return [f"TrainStep ran the eager tape: "
                f"{step.last_fallback_reason}"]
    d1 = _steady_delta(telemetry, step, x, y)
    d2 = _steady_delta(telemetry, step, x, y)
    if d1 != d2:
        diff = {k: (d1.get(k), d2.get(k)) for k in set(d1) | set(d2)
                if d1.get(k) != d2.get(k)}
        return [f"steady-state TrainStep delta not reproducible: {diff}"]
    if d1.get("program_store.train_step.dispatches") != 3:
        return [f"the steady-state window did not dispatch 3 compiled "
                f"steps: {d1}"]
    return []


def check_chrome_trace(device: str = "cuda") -> List[str]:
    """One compiled train step inside a StepTimeline phase and one decode
    request under the profiler: the dump is valid JSON with >= 3 span
    categories, ``train_step`` among them."""
    from mxnet_tpu_torch import profiler, serving_decode, telemetry

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.set_config(filename=path)
        profiler.set_state("run")
        try:
            step, x, y = _train_fixture(device)
            tl = profiler.StepTimeline()
            with tl.phase("dispatch"):
                step(x, y, batch_size=8).detach().cpu()
            tl.step()
            eng = serving_decode.GenerativeEngine(
                serving_decode.TinyCausalLM(),
                pool=serving_decode.PagePool(pages=64, page=8),
                max_rows=2, device=device)
            try:
                eng.generate([3, 1, 4], max_new_tokens=2)
            finally:
                eng.close()
        finally:
            profiler.set_state("stop")
        out = profiler.dump()
        with open(out) as f:
            trace = json.load(f)
        cats = {e.get("cat") for e in trace["traceEvents"]
                if e.get("ph") == "X"}
        got = cats & SPAN_CATS
        if len(got) < 3 or "train_step" not in got:
            return [f"the chrome trace carries span categories "
                    f"{sorted(got)} of {sorted(SPAN_CATS)} (need >= 3, "
                    f"train_step among them); all: "
                    f"{sorted(c for c in cats if c)}"]
        if len(telemetry.spans()) < 3:
            return [f"the span buffer holds {len(telemetry.spans())} "
                    "records"]
    finally:
        os.unlink(path)
    return []


def check_routed_trace_ids(device: str = "cuda") -> List[str]:
    """A 2-replica router through a failover, a deadline shed and a hedge:
    every ``failover`` / ``shed`` / ``hedge`` event carries a trace id."""
    import time as _time
    from collections import deque as _deque

    from mxnet_tpu_torch import faults, telemetry
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch.serving_router import ReplicaRouter

    model = sd.TinyCausalLM(vocab=31, d_model=16, n_layers=1, n_heads=2,
                            max_seq=48)
    params = model.init_params(0, device=device)
    engines, pools = [], []
    for i in range(2):
        pool = sd.PagePool(pages=32, page=4)
        eng = sd.GenerativeEngine(model, params=params, pool=pool,
                                  max_rows=2, name=f"trace_gate{i}",
                                  device=device)
        eng.warmup(max_len=8)
        engines.append(eng)
        pools.append(pool)
    router = ReplicaRouter(engines, breaker_errs=4, breaker_cooldown_s=0.2,
                           hedge_pctl=50)
    evs0 = telemetry.events()
    base_seq = evs0[-1]["seq"] if evs0 else 0
    failures: List[str] = []
    orig = engines[0].generate
    try:
        calls = [0]

        def flaky(*a, **kw):              # replica 0 fails its first call
            calls[0] += 1
            if calls[0] == 1:
                raise faults.TransientFault("trace gate failover")
            return orig(*a, **kw)

        engines[0].generate = flaky
        router.generate([1, 2, 3], max_new_tokens=3)
        engines[0].generate = orig
        try:                              # a 1 us budget never admits
            router.generate([1, 2, 3], max_new_tokens=3, deadline_us=1)
            failures.append("the 1 us request was not shed")
        except faults.ShedError:
            pass
        # hedge: a primed latency record, both replicas slowed past it
        router._lat_dispatch = _deque((0.001,) * 16, maxlen=4096)

        def slow(*a, **kw):
            _time.sleep(0.25)
            return orig(*a, **kw)

        engines[0].generate = engines[1].generate = slow
        router.generate([1, 2, 3], max_new_tokens=2)
    finally:
        engines[0].generate = orig
        engines[1].generate = orig
        router.close()
        for eng in engines:
            eng.close()
    new = [e for e in telemetry.events() if e["seq"] > base_seq]
    for want in ("failover", "shed", "hedge"):
        of_kind = [e for e in new if e["kind"] == want]
        if not of_kind:
            failures.append(f"no {want!r} event: the scenario broke, the "
                            "stamping is unchecked")
        bad = [e for e in of_kind if not e.get("trace_id")]
        if bad:
            failures.append(f"{len(bad)} routed {want!r} event(s) without "
                            f"a trace_id: {bad[:2]}")
    leaked = sum(p.in_use() for p in pools)
    if leaked:
        failures.append(f"the trace gate leaked {leaked} KV pages")
    return failures


def check_prefix_zero_when_off(device: str = "cuda") -> List[str]:
    """``MXNET_PREFIX_CACHE=0`` (uncached): the same prompt twice moves no
    ``prefix.*`` counter and parks nothing in the pool."""
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch import telemetry

    prev = os.environ.get("MXNET_PREFIX_CACHE")
    os.environ["MXNET_PREFIX_CACHE"] = "0"
    try:
        model = sd.TinyCausalLM(vocab=29, d_model=16, n_layers=1,
                                n_heads=2, max_seq=48)
        pool = sd.PagePool(pages=32, page=4)
        eng = sd.GenerativeEngine(model, params=model.init_params(
            2, device=device), pool=pool, max_rows=2,
            name="prefix_off_gate", device=device)
        base = telemetry.snapshot()
        try:
            for _ in range(2):
                eng.generate([5, 4, 3, 2, 1, 6, 7, 8], max_new_tokens=3)
        finally:
            eng.close()
        moved = {k: v for k, v in telemetry.delta(base).items()
                 if k.startswith("prefix.") and v}
        out = []
        if moved:
            out.append(f"MXNET_PREFIX_CACHE=0 moved prefix counters: "
                       f"{moved}")
        st = pool.stats()
        if st["cached"] != 0 or st["in_use"] != 0:
            out.append(f"the pool holds pages with the knob off: {st}")
        return out
    finally:
        if prev is None:
            os.environ.pop("MXNET_PREFIX_CACHE", None)
        else:
            os.environ["MXNET_PREFIX_CACHE"] = prev


def merge_worker(device: str) -> int:
    """``--merge-worker``: warm the train step and a decode engine, reset
    the counters, run the window (3 steps and a full prefix hit), and
    flush this process's shard (``engine.waitall``)."""
    from mxnet_tpu_torch import engine, telemetry
    from mxnet_tpu_torch import serving_decode as sd

    step, x, y = _train_fixture(device)
    for _ in range(2):
        loss = step(x, y, batch_size=8)
    loss.detach().cpu()
    model = sd.TinyCausalLM(vocab=29, d_model=16, n_layers=1, n_heads=2,
                            max_seq=48)
    eng = sd.GenerativeEngine(model, params=model.init_params(
        4, device=device), pool=sd.PagePool(pages=32, page=4), max_rows=2,
        name="merge_gate", device=device)
    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    eng.generate(shared, max_new_tokens=2)
    telemetry.reset()
    for _ in range(3):
        loss = step(x, y, batch_size=8)
    loss.detach().cpu()
    eng.generate(shared, max_new_tokens=2)   # a full hit, no prefill
    eng.close()
    engine.waitall()
    return 0


def _cumulative_window(telemetry, path) -> Dict[str, object]:
    sh = telemetry._read_shard(path)
    kinds = (sh["meta"] or {}).get("counter_kinds", {})
    snap = (sh["snapshot"] or {}).get("counters", {})
    return {n: v for n, v in snap.items()
            if n.startswith(DETERMINISTIC_PREFIXES)
            and kinds.get(n) == "cumulative"}


def check_merge_correctness(device: str = "cuda") -> List[str]:
    """Two processes, one window each: equal shards, and a merge of
    exactly twice one of them."""
    from mxnet_tpu_torch import telemetry

    with tempfile.TemporaryDirectory(
            prefix="torch-check-telemetry-merge-") as d:
        env = dict(os.environ, MXNET_TELEMETRY_DIR=d)
        env.pop("MXNET_FAULT_PLAN", None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), MERGE_WORKER,
             "--device", device], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
        for i, p in enumerate(procs):
            try:
                _out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                return [f"merge worker {i} timed out"]
            if p.returncode != 0:
                return [f"merge worker {i} failed, rc {p.returncode}: "
                        f"{err[-1000:]}"]
        merged = telemetry.merge(d)
        if len(merged["shards"]) != 2:
            return [f"expected 2 shards, merged {merged['shards']}"]
        windows = [_cumulative_window(telemetry, os.path.join(d, p["shard"]))
                   for p in merged["processes"]]
        if windows[0] != windows[1]:
            diff = {k: (windows[0].get(k), windows[1].get(k))
                    for k in set(windows[0]) | set(windows[1])
                    if windows[0].get(k) != windows[1].get(k)}
            return [f"identical windows wrote different shards: {diff}"]
        doubled = {n: 2 * v for n, v in windows[0].items()}
        got = {n: merged["counters"].get(n, 0) for n in doubled}
        if got != doubled:
            diff = {k: (doubled[k], got[k]) for k in doubled
                    if doubled[k] != got[k]}
            return [f"the 2-process merge is not 2x one window: {diff}"]
        if windows[0].get("program_store.train_step.dispatches") != 3:
            return [f"the worker's window did not dispatch 3 compiled steps: "
                    f"{windows[0]}"]
        return []


RUNTIME_CHECKS = (
    ("deterministic steady-state snapshot", check_deterministic_snapshot),
    ("chrome-trace export", check_chrome_trace),
    ("routed-request trace stamping", check_routed_trace_ids),
    ("prefix counters zero with the knob off", check_prefix_zero_when_off),
    ("two-process merge correctness", check_merge_correctness),
)


def static_failures(root: str) -> List[tuple]:
    """Checks 1 and 2 over the registry as it stands in this process."""
    from mxnet_tpu_torch import telemetry

    pkg = os.path.join(root, PACKAGE)
    failures = []
    raw = collect_raw_state(pkg)
    if raw:
        failures.append(("raw (non-registry) counter state", raw))
    registry = telemetry.registered()
    unregistered = check_registered(collect_accessors(pkg), registry)
    if unregistered:
        failures.append(("accessors with no registered counter",
                         unregistered))
    untested = check_tested(registry, os.path.join(root, "tests"))
    if untested:
        failures.append(("registered counters no test names", untested))
    return failures


def import_counter_modules() -> None:
    """Import every module of the port that declares counters."""
    import mxnet_tpu_torch  # noqa: F401
    from mxnet_tpu_torch import (cached_step, drills, engine,  # noqa: F401
                                 faults, metric, preemption, profiler,
                                 program_store, sentinel, serving,
                                 serving_decode, serving_router,
                                 telemetry)
    from mxnet_tpu_torch.contrib import quantization  # noqa: F401
    from mxnet_tpu_torch.models import transformer_lm  # noqa: F401
    from mxnet_tpu_torch.parallel import (elastic, sharding,  # noqa: F401
                                          spmd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("root", nargs="?", default=ROOT)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_check_telemetry: no CUDA device (pass --device "
                  "cpu)", file=sys.stderr)
            return 1
    pkg = os.path.join(a.root, PACKAGE)
    accessors = collect_accessors(pkg)
    if not accessors:
        print(f"torch_check_telemetry: no *_count accessors under {pkg}",
              file=sys.stderr)
        return 1
    import_counter_modules()
    failures = [(what, [m]) for what, check in RUNTIME_CHECKS
                for m in check(a.device)]
    failures += static_failures(a.root)
    if failures:
        print("torch_check_telemetry: FAIL", file=sys.stderr)
        for what, items in failures:
            print(f"  [{what}]", file=sys.stderr)
            for it in items:
                print(f"    {it}", file=sys.stderr)
        return 1
    from mxnet_tpu_torch import telemetry

    print(f"torch_check_telemetry: {len(accessors)} accessors, "
          f"{len(telemetry.registered())} registered counters, a "
          "deterministic steady-state delta, a chrome trace of >= 3 span "
          "categories with train_step, routed events trace-stamped, "
          "prefix counters at 0 with the knob off, a 2-process merge of "
          "2x one window")
    return 0


if __name__ == "__main__":
    if MERGE_WORKER in sys.argv:
        args = sys.argv[1:]
        dev = args[args.index("--device") + 1] if "--device" in args \
            else "cuda"
        sys.exit(merge_worker(dev))
    sys.exit(main(sys.argv[1:]))
