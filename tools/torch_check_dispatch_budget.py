#!/usr/bin/env python3
"""Gate: the port's compiled step, its serving paths, its meshes, the
replica router and speculative decoding stay inside their dispatch
budgets.

    python3 tools/torch_check_dispatch_budget.py [--device cuda|cpu]
        [--world N] [--lanes a,b,...]

The port of ``tools/check_dispatch_budget.py`` (budgets :51-141, gates
:1133-1330). One function a lane measures it (``measure_<lane>``) and one
holds it to its budget (``<lane>_failures``), so that ``chip_smoke.py`` and
the tests can run one lane at a time (``LANES``):

- **compiled** (reference :189): a tiny MLP (:158) through
  ``Trainer.compile_step``: 1 launch, 0 eager invokes, 0 group launches,
  0 re-captures and 0 host syncs a step, and 1 live train program (the
  store lane's in-process half). A launch is a dispatch of the step's
  program (``cached_step.dispatch_count``); an eager invoke an operator
  dispatch (``ndarray.invoke_count``) outside every program's body (on the
  CPU a program runs its body each call, and those dispatches are the
  program's own); a group launch a dispatch of any other program-store
  namespace; a host sync a blocking read (``ndarray.host_sync_count`` and
  ``engine.sync_count``). The eager tape's lane is printed, not gated.
- **amp**: the same step under a loss scaler: at most one host sync a
  step, and that sync the deferred read of the previous step's flag
  (``cached_step.deferred_read_count``).
- **sentinel** (:242): cadence 2 over 5 steps after the first: 1 launch
  a step, 0 re-captures, 3 digest reads (``sentinel.digests``), no host
  sync beyond them, and the in-program fold equal to
  ``sentinel.tree_digest`` of the live state.
- **serving** (:626): every bucket warmed, then 24 requests of random
  length up to 16 through ``ServingEngine``: 1 launch a batch, 0
  re-captures, programs <= buckets, ``bucket_refused`` None.
- **decode** (:668): a join/retire storm of 8 requests through
  ``GenerativeEngine``: programs = prefill buckets + 1, 0 re-captures, one
  dispatch a decode step or prefill and nothing else, 0 leaked pages, 0
  shed, 0 errors.
- **mesh** (:298), **fsdp** (:350), **pp** (:443), **moe** (:550):
  ``Trainer(kvstore='tpu').compile_step`` under ``MXNET_SPMD_MESH``: the
  per-step budget above plus 0 steady-state reshards
  (``spmd.reshard_count``) and 0 replicated batches
  (``spmd.replicated_batch_count``); fsdp and pp also an
  ``accum_steps=2`` window of exactly 3 dispatches. Their placement
  checks (parameters over every rank, ``param_bytes_frac`` <= 0.75 under
  fsdp, the stage buffer one stage a pp group, one expert an ep group)
  need more than one rank: on the card the lanes run as meshes of one
  and print the placement checks as skipped, as the reference skips a
  lane with too few devices; on the CPU (``--device cpu``) they run in a
  gloo world of ``--world`` processes (4: mesh ``dp=4``, fsdp
  ``dp=2,fsdp=2``, pp ``pp=2,dp=2``, moe ``ep=4,dp=1``; 8: the reference's
  ``dp=8``, ``dp=4,fsdp=2``, ``pp=2,dp=2,fsdp=2``, ``ep=4,dp=2``).
- **router** (:729-808), the zero-overhead-off rule: the same request
  stream through a bare ``GenerativeEngine`` and through a
  ``ReplicaRouter`` over that one replica costs the same dispatches,
  captures and host syncs, with the same tokens and 0 leaked pages; with
  ``MXNET_TELEMETRY_TRACE=0`` as well, and then no trace field.
- **spec** (:810-940): a high-agreement draft under
  ``MXNET_SPEC_DECODE=1`` drives a mixed greedy / sampled storm: programs
  bounded by the warm-up grid, 0 captures after warm-up, < 1 target
  dispatch a committed token, acceptance >= 0.7, greedy rows token-exact
  against the eager oracle, 0 leaked pages; then the off leg.
- **store**: every lane above ran through the program store: 0
  evictions after warm-up. The reference's second half, a warm second
  process that compiles nothing (:942-1018), stays out: the port has no
  persistent program cache, as a CUDA graph lives in one process.

Prints one JSON line a lane and exits 1 when a budget breaks.
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEPS = 5
INFER_REQUESTS = 24
INFER_MAXLEN = 16
BUDGET = {"compiled_launches_per_step": 1, "eager_invokes_per_step": 0,
          "group_launches_per_step": 0, "retraces_after_warm": 0,
          "host_syncs_per_step": 0}
AMP_BUDGET = {"host_syncs_per_step": 1, "deferred_reads_per_step": 1}
INFER_BUDGET = {"launches_per_batch": 1, "retraces_after_warm": 0,
                "programs_over_buckets": 0}
DECODE_BUDGET = {"retraces_after_warm": 0, "programs_over_grid": 0,
                 "extra_dispatches": 0, "leaked_pages": 0}
STORE_BUDGET = {"evictions_after_warm": 0, "live_train_programs_over": 0}
SENTINEL_BUDGET = {"compiled_launches_per_step": 1,
                   "eager_invokes_per_step": 0, "retraces_after_warm": 0,
                   "replica_divergence": 0}
MESH_BUDGET = dict(BUDGET, reshards_after_warm=0, replicated_batches=0)
FSDP_BUDGET = dict(MESH_BUDGET, accum_extra_dispatches=0,
                   accum_retraces_after_warm=0)
PP_BUDGET = {"compiled_launches_per_step": 1, "eager_invokes_per_step": 0,
             "group_launches_per_step": 0, "retraces_after_warm": 0,
             "reshards_after_warm": 0, "replicated_batches": 0,
             "accum_extra_dispatches": 0, "accum_retraces_after_warm": 0}
MOE_BUDGET = {"compiled_launches_per_step": 1, "eager_invokes_per_step": 0,
              "group_launches_per_step": 0, "retraces_after_warm": 0,
              "reshards_after_warm": 0, "replicated_batches": 0}
ROUTER_BUDGET = {"extra_dispatches": 0, "extra_retraces": 0,
                 "extra_host_syncs": 0}
SPEC_BUDGET = {"retraces_after_warm": 0, "programs_over_grid": 0,
               "leaked_pages": 0, "greedy_off_extra_dispatches": 0,
               "greedy_off_extra_retraces": 0}
TRACED_OFF = ("traced_off_extra_dispatches", "traced_off_extra_retraces",
              "traced_off_extra_host_syncs", "traced_off_trace_fields")
# the meshes of the mesh lanes, by world size (1: the card's mesh of one)
MESH_SPECS = {
    1: {"mesh": "dp=1", "fsdp": "dp=1,fsdp=1", "pp": "pp=1,dp=1",
        "moe": "ep=1,dp=1"},
    4: {"mesh": "dp=4", "fsdp": "dp=2,fsdp=2", "pp": "pp=2,dp=2",
        "moe": "ep=4,dp=1"},
    8: {"mesh": "dp=8", "fsdp": "dp=4,fsdp=2", "pp": "pp=2,dp=2,fsdp=2",
        "moe": "ep=4,dp=2"},
}
MESH_LANES = ("mesh", "fsdp", "pp", "moe")
NAMESPACES = ("train_step", "hybrid_forward", "serving", "serving_decode",
              "serving_spec", "sharded_step")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
def _host_syncs() -> int:
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ndarray import host_sync_count

    return int(host_sync_count()) + int(engine.sync_count())


def _dispatches(exclude: str) -> int:
    from mxnet_tpu_torch import program_store as ps

    return sum(ps.stats(n)["dispatches"] for n in NAMESPACES
               if n != exclude)


def evictions() -> int:
    from mxnet_tpu_torch import program_store as ps

    return sum(ps.stats(n)["evictions"] for n in NAMESPACES)


class _Window:
    """The counters of one measured window: step launches, eager
    invokes (operator dispatches outside every program's body), group
    launches, captures, host syncs, deferred reads, reshards and
    replicated batches."""

    def __init__(self):
        self.inside = 0

    @contextlib.contextmanager
    def counting(self):
        from mxnet_tpu_torch import program_store as ps
        from mxnet_tpu_torch.ndarray import invoke_count

        run = ps.Program._run
        win = self

        def counted(prog):
            n0 = invoke_count()
            try:
                return run(prog)
            finally:
                win.inside += invoke_count() - n0

        ps.Program._run = counted
        try:
            yield self
        finally:
            ps.Program._run = run

    def read(self) -> dict:
        from mxnet_tpu_torch import cached_step as cs
        from mxnet_tpu_torch.ndarray import invoke_count
        from mxnet_tpu_torch.parallel import spmd

        return {"launches": cs.dispatch_count(), "traces": cs.trace_count(),
                "invokes": invoke_count() - self.inside,
                "groups": _dispatches("train_step"),
                "syncs": _host_syncs(),
                "deferred": cs.deferred_read_count(),
                "reshards": spmd.reshard_count(),
                "replicated": spmd.replicated_batch_count()}


def _per_step(a: dict, b: dict, n: int) -> dict:
    return {
        "compiled_launches_per_step": (b["launches"] - a["launches"]) / n,
        "eager_invokes_per_step": (b["invokes"] - a["invokes"]) / n,
        "group_launches_per_step": (b["groups"] - a["groups"]) / n,
        "retraces_after_warm": b["traces"] - a["traces"],
        "host_syncs_per_step": (b["syncs"] - a["syncs"]) / n,
        "deferred_reads_per_step": (b["deferred"] - a["deferred"]) / n,
        "reshards_after_warm": b["reshards"] - a["reshards"],
        "replicated_batches": b["replicated"] - a["replicated"],
    }


@contextlib.contextmanager
def knobs(**values):
    """Set knobs inside the scope (None: unset), refreshing the cached
    ones."""
    from mxnet_tpu_torch import config

    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
        config.refresh(k)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
            config.refresh(k)


def _ctx(device: str):
    import mxnet_tpu_torch as mx

    return mx.cpu() if device == "cpu" else mx.gpu(0)


def _fence(loss) -> None:
    """Wait for the last step, outside the window (not counted)."""
    (loss[0] if isinstance(loss, (list, tuple)) else loss).detach().cpu()


# ---------------------------------------------------------------------------
# the train-step lanes
# ---------------------------------------------------------------------------
def build(device: str, seed: int = 0, rows: int = 6,
          kvstore: str = "device"):
    """The reference's gate MLP (:158): Dense(16, relu) over Dense(4), 8
    inputs, seeded normal weights x 0.1, hybridized, SGD momentum 0.9 at
    lr 0.1; its mean-square loss and a seeded batch of ``rows``."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = nn.Dense(16, in_units=8, activation="relu")
            self.d2 = nn.Dense(4, in_units=16)

        def forward(self, x):
            return self.d2(self.d1(x))

    net = Net()
    net.initialize(mx.init.Xavier(), ctx=_ctx(device))
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.tensor(rng.randn(*p.shape) * 0.1,
                                dtype=torch.float32))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore=kvstore)
    dev = net.collect_params()["d1.weight"].data().device
    data = torch.tensor(rng.randn(rows, 8), dtype=torch.float32, device=dev)
    label = torch.tensor(rng.randn(rows, 4), dtype=torch.float32,
                         device=dev)
    return net, trainer, _mse, data, label


def _mse(n, x, y):
    return ((n(x) - y) ** 2).mean()


def measure_compiled(device: str = "cuda", compiled: bool = True,
                     with_amp: bool = False) -> dict:
    """The compiled step (or, ``compiled=False``, the eager tape) over
    STEPS steps after one warm step; ``with_amp`` under a loss scaler."""
    from mxnet_tpu_torch import amp, autograd

    net, trainer, loss_fn, data, label = build(device)
    if with_amp:
        trainer._amp_loss_scaler = amp.LossScaler(init_scale=8.0)
    step = trainer.compile_step(net, loss_fn)

    def one_step():
        if compiled:
            return step(data, label, batch_size=6)
        with autograd.record():
            loss = loss_fn(net, data, label)
        autograd.backward(loss)
        trainer.step(6)
        return loss

    _fence(one_step())                    # warm: the eager run, capture
    win = _Window()
    with win.counting():
        a = win.read()
        for _ in range(STEPS):
            loss = one_step()
        b = win.read()
    _fence(loss)
    out = {"mode": ("compiled" if compiled else "eager")
           + ("+amp" if with_amp else ""), "device": device,
           "used_compiled": compiled and step.last_step_compiled,
           **_per_step(a, b, STEPS)}
    out["dispatches_per_step"] = (out["eager_invokes_per_step"]
                                  + out["compiled_launches_per_step"]
                                  + out["group_launches_per_step"])
    out["live_programs"] = len(step._programs) if compiled else 0
    return out


def measure_amp(device: str = "cuda") -> dict:
    return measure_compiled(device, with_amp=True)


def measure_eager(device: str = "cuda") -> dict:
    return measure_compiled(device, compiled=False)


def compiled_failures(row: dict) -> list:
    failures = []
    if not row["used_compiled"]:
        failures.append("compiled mode ran the eager tape")
    for key, budget in BUDGET.items():
        if row[key] > budget:
            failures.append(f"{key} = {row[key]} exceeds budget {budget}")
    if row["live_programs"] - 1 > STORE_BUDGET["live_train_programs_over"]:
        failures.append(
            f"the train step holds {row['live_programs']} live programs "
            "for one constant-shape signature (expected 1)")
    return failures


def amp_failures(row: dict) -> list:
    failures = []
    if not row["used_compiled"]:
        failures.append("compiled AMP mode ran the eager tape")
    for key, budget in AMP_BUDGET.items():
        if row[key] > budget:
            failures.append(f"AMP {key} = {row[key]} exceeds budget "
                            f"{budget}")
    if row["host_syncs_per_step"] > row["deferred_reads_per_step"]:
        failures.append(
            "the AMP step makes a blocking host sync beyond the deferred "
            f"flag read ({row['host_syncs_per_step']} syncs against "
            f"{row['deferred_reads_per_step']} deferred reads)")
    return failures


def measure_sentinel(device: str = "cuda") -> dict:
    """A Sentinel at cadence 2 on the compiled step: a warm call, then 5
    (the last a digest step, so the flushed fold is the live state's)."""
    from mxnet_tpu_torch import sentinel, telemetry

    net, trainer, loss_fn, data, label = build(device, seed=7)
    step = trainer.compile_step(net, loss_fn)
    snt = sentinel.Sentinel(step=step, every=2)
    _fence(step(data, label, batch_size=6))
    base = telemetry.snapshot()
    win = _Window()
    with win.counting():
        a = win.read()
        for _ in range(STEPS):
            loss = step(data, label, batch_size=6)
        b = win.read()
    used = step.last_step_compiled
    snt.flush()
    _fence(loss)
    snap = telemetry.snapshot()
    host_fold = sentinel.tree_digest(step.digest_leaves())
    per = _per_step(a, b, STEPS)
    return {
        "mode": "sentinel", "device": device, "used_compiled": used,
        "compiled_launches_per_step": per["compiled_launches_per_step"],
        "eager_invokes_per_step": per["eager_invokes_per_step"],
        "retraces_after_warm": per["retraces_after_warm"],
        "digest_reads": snap["sentinel.digests"] - base["sentinel.digests"],
        "host_syncs": b["syncs"] - a["syncs"],
        "replica_divergence": snap["sentinel.replica_divergence"]
        - base["sentinel.replica_divergence"],
        "fold": snt.last_fold, "host_fold": host_fold,
        "fold_matches_host": snt.last_fold == host_fold,
    }


def sentinel_failures(row: dict) -> list:
    failures = []
    if not row["used_compiled"]:
        failures.append("the sentinel step ran the eager tape")
    for key, budget in SENTINEL_BUDGET.items():
        if row[key] > budget:
            failures.append(f"sentinel {key} = {row[key]} exceeds budget "
                            f"{budget}")
    if row["digest_reads"] != 3:
        failures.append(f"the sentinel read {row['digest_reads']} digests "
                        "over 5 steps at cadence 2 (expected 3)")
    if row["host_syncs"] > row["digest_reads"]:
        failures.append(
            f"the sentinel step makes host syncs beyond its digest reads "
            f"({row['host_syncs']} against {row['digest_reads']})")
    if not row["fold_matches_host"]:
        failures.append(f"the in-program digest {row['fold']} is not the "
                        f"host's recomputation {row['host_fold']}")
    return failures


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def measure_serving(device: str = "cuda") -> dict:
    """Warm every bucket a stream of 1..16 rows hits, then 24 requests of
    random length."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch import serving

    net, _tr, _lf, _d, _l = build(device, seed=1)
    policy = serving.BucketPolicy()
    eng = serving.ServingEngine(net, max_delay_us=200, policy=policy)
    try:
        buckets = set()
        for n in range(1, INFER_MAXLEN + 1):
            b = policy.bucket(n)
            if b is not None and b not in buckets:
                buckets.add(b)
                eng.infer(torch.zeros((b, 8)))
        rng = onp.random.RandomState(7)
        t0, d0 = serving.trace_count(), serving.dispatch_count()
        b0 = eng.stats()["batches"]
        for ln in rng.randint(1, INFER_MAXLEN + 1, size=INFER_REQUESTS):
            out = eng.infer(torch.tensor(rng.randn(int(ln), 8),
                                         dtype=torch.float32))
            if out.shape[0] != int(ln):
                raise AssertionError(f"{tuple(out.shape)} for {ln} rows")
        batches = eng.stats()["batches"] - b0
        return {
            "mode": "serving", "device": device,
            "bucket_refused": eng.bucket_refused,
            "requests": INFER_REQUESTS, "batches": batches,
            "launches_per_batch":
                (serving.dispatch_count() - d0) / max(batches, 1),
            "retraces_after_warm": serving.trace_count() - t0,
            "programs_over_buckets": max(0, len(eng._programs)
                                         - len(buckets)),
            "programs": len(eng._programs), "buckets": len(buckets),
        }
    finally:
        eng.close()


def serving_failures(row: dict) -> list:
    failures = []
    if row["bucket_refused"] is not None:
        failures.append(f"serving refused bucketing: "
                        f"{row['bucket_refused']}")
    for key, budget in INFER_BUDGET.items():
        if row[key] > budget:
            failures.append(f"serving {key} = {row[key]} exceeds budget "
                            f"{budget}")
    return failures


def measure_decode(device: str = "cuda") -> dict:
    """A join/retire storm: 8 concurrent requests of staggered prompts and
    budgets, so that rows join mid-stream and retire early."""
    import numpy as onp

    from mxnet_tpu_torch import engine as _engine
    from mxnet_tpu_torch import serving_decode as sd

    model = sd.TinyCausalLM(vocab=37, d_model=16, n_layers=2, n_heads=2,
                            max_seq=32)
    params = model.init_params(3, device=device)
    pool = sd.PagePool(pages=48, page=4)
    eng = sd.GenerativeEngine(model, params=params, pool=pool, max_rows=4,
                              name="budget", device=device)
    try:
        grid = eng.warmup(max_len=16)
        t0, d0 = sd.trace_count(), sd.dispatch_count()
        rng = onp.random.RandomState(11)
        prompts = [rng.randint(0, 37, size=rng.randint(1, 13)).tolist()
                   for _ in range(8)]
        budgets = [3, 9, 5, 2, 7, 4, 8, 6]
        errs = []

        def fire(i):
            try:
                out = eng.generate(prompts[i], max_new_tokens=budgets[i])
                if len(out) != budgets[i]:
                    errs.append(f"request {i}: {len(out)} tokens")
            except BaseException as e:
                errs.append(repr(e))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            errs.append("a storm thread hung")
        _engine.waitall()
        st = eng.stats()
        disp = sd.dispatch_count() - d0
        return {
            "mode": "decode", "device": device, "errors": errs,
            "warmup_programs": grid, "programs": st["programs"],
            "programs_over_grid": max(0, st["programs"] - grid),
            "retraces_after_warm": sd.trace_count() - t0,
            "dispatches": disp, "decode_steps": st["decode_steps"],
            "prefills": st["prefills"],
            "extra_dispatches": disp - st["decode_steps"] - st["prefills"],
            "rows_per_decode": round(st.get("rows_per_decode", 0.0), 2),
            "leaked_pages": pool.in_use(), "shed": st["shed"],
        }
    finally:
        eng.close()


def decode_failures(row: dict) -> list:
    failures = []
    if row["errors"]:
        failures.append(f"decode storm errors: {row['errors']}")
    if row["shed"]:
        failures.append(f"the decode storm shed {row['shed']} request(s); "
                        "the pool is sized for the whole storm")
    for key, budget in DECODE_BUDGET.items():
        if row[key] > budget:
            failures.append(f"decode {key} = {row[key]} exceeds budget "
                            f"{budget}")
    return failures


# ---------------------------------------------------------------------------
# the mesh lanes
# ---------------------------------------------------------------------------
def _mesh_row(mode, spec, step, a, b) -> dict:
    from mxnet_tpu_torch.parallel import mesh as _mesh

    mesh = step.mesh
    return {"mode": mode, "spec": spec, "used_compiled":
            step.last_step_compiled, "mesh_active": mesh is not None,
            "mesh_devices": mesh.size if mesh is not None else 0,
            "n_devices": _mesh.world_size(), **_per_step(a, b, STEPS)}


def _steady(step, call, n=STEPS):
    """Warm ``call`` once, then count n calls."""
    _fence(call())
    win = _Window()
    with win.counting():
        a = win.read()
        for _ in range(n):
            loss = call()
        b = win.read()
    _fence(loss)
    return a, b


def _accum(step, call) -> dict:
    """An accum_steps=2 window: warm one window, then 3 windows."""
    from mxnet_tpu_torch import cached_step as cs

    for _ in range(2):
        loss = call()
    _fence(loss)
    d0, t0 = cs.dispatch_count(), cs.trace_count()
    for _ in range(6):
        loss = call()
    _fence(loss)
    per_window = (cs.dispatch_count() - d0) / 3
    return {"accum_used_compiled": step.last_step_compiled,
            "accum_dispatches_per_window": per_window,
            "accum_extra_dispatches": per_window - 3.0,
            "accum_retraces_after_warm": cs.trace_count() - t0}


def measure_mesh(device: str = "cuda", spec: str = "dp=1") -> dict:
    """``kvstore='tpu'`` on ``spec``: 2 rows a rank."""
    from mxnet_tpu_torch.parallel import mesh as _mesh

    rows = 2 * _mesh.world_size()
    with knobs(MXNET_SPMD_MESH=spec):
        net, trainer, loss_fn, data, label = build(device, seed=2,
                                                   rows=rows, kvstore="tpu")
        step = trainer.compile_step(net, loss_fn)
        a, b = _steady(step, lambda: step(data, label, batch_size=rows))
        return _mesh_row("mesh", spec, step, a, b)


def measure_fsdp(device: str = "cuda", spec: str = "dp=1,fsdp=1") -> dict:
    """Parameters and optimizer state over ``fsdp``, the batch over
    ``dp``; then an accum_steps=2 window on the same mesh."""
    from mxnet_tpu_torch.parallel import spmd

    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        net, trainer, loss_fn, data, label = build(device, seed=3, rows=8,
                                                   kvstore="tpu")
        step = trainer.compile_step(net, loss_fn)
        a, b = _steady(step, lambda: step(data, label, batch_size=8))
        row = _mesh_row("fsdp", spec, step, a, b)
        total = sum(t.numel() * t.element_size()
                    for t in step.full_params().values())
        per_dev = spmd.param_bytes_per_device()
        row["param_bytes_per_device"] = per_dev
        row["param_bytes_frac"] = per_dev / total if total else 1.0
        net2, tr2, loss2, d2, l2 = build(device, seed=4, rows=8,
                                         kvstore="tpu")
        astep = tr2.compile_step(net2, loss2, accum_steps=2)
        row.update(_accum(astep, lambda: astep(d2, l2, batch_size=8)))
        return row


def _pipeline_block(device, seed):
    import numpy as onp
    import torch

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import pipeline as pipe_mod
    from mxnet_tpu_torch.parallel import spmd

    mesh = spmd.resolve_mesh()
    n = int(mesh.shape["pp"])            # one stage a pp group
    rng = onp.random.RandomState(seed)
    ws = [torch.tensor(rng.randn(8, 8) * 0.3, dtype=torch.float32,
                       device=mesh.device) for _ in range(n)]
    pipe = pipe_mod.HeteroPipeline(
        [lambda p, x: torch.tanh(x @ p["w"])] * n, [{"w": w} for w in ws],
        mesh, num_microbatches=2,
        example_x=torch.zeros(4, 8, device=mesh.device))
    blk = pipe_mod.PipelineBlock(pipe)
    trainer = gluon.Trainer(blk.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9},
                            kvstore="tpu")
    data = torch.tensor(rng.randn(4, 8), dtype=torch.float32,
                        device=mesh.device)
    return blk, trainer, data


def _sumsq(n, x):
    return (n(x) ** 2).sum()


def measure_pp(device: str = "cuda", spec: str = "pp=1,dp=1") -> dict:
    """A PipelineBlock of one tanh stage a pp group (GPipe, 2
    micro-batches); then an accum_steps=2 window on the same mesh."""
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        blk, trainer, data = _pipeline_block(device, 11)
        step = trainer.compile_step(blk, _sumsq)
        a, b = _steady(step, lambda: step(data, batch_size=4))
        row = _mesh_row("pp", spec, step, a, b)
        pp_spec = tuple(step._specs[id(blk.pp_stages)])
        row["stage_spec"] = [str(s) for s in pp_spec]
        row["stage_block"] = list(blk.pp_stages.data().shape)
        row["stage_sharded"] = bool(pp_spec and pp_spec[0] == "pp"
                                    and row["stage_block"][0] == 1)
        blk2, tr2, d2 = _pipeline_block(device, 12)
        astep = tr2.compile_step(blk2, _sumsq, accum_steps=2)
        row.update(_accum(astep, lambda: astep(d2, batch_size=4)))
        return row


def measure_moe(device: str = "cuda", spec: str = "ep=1,dp=1") -> dict:
    """An MoEBlock (4 experts, top 2) with the aux head folded in."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import moe as moe_mod

    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        net = moe_mod.MoEBlock(units=8, hidden=16, num_experts=4, k=2)
        net.initialize(ctx=_ctx(device))
        rng = onp.random.RandomState(13)
        for _name, p in sorted(net.collect_params().items()):
            p.set_data(torch.tensor(rng.randn(*p.shape) * 0.2,
                                    dtype=torch.float32))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9},
                                kvstore="tpu")
        dev = net.collect_params()["gate.weight"].data().device
        data = torch.tensor(rng.randn(4, 6, 8), dtype=torch.float32,
                            device=dev)
        step = trainer.compile_step(net, _sumsq)
        a, b = _steady(step, lambda: step(data, batch_size=4))
        row = _mesh_row("moe", spec, step, a, b)
        ew = net.collect_params()["expert.ffn_1.weight"].data()
        row["expert_block"] = list(ew.shape)
        row["expert_sharded"] = int(ew.shape[0]) == 1
        return row


def _mesh_lane_failures(row: dict, budget: dict) -> list:
    mode = row["mode"]
    failures = []
    if not row["used_compiled"]:
        failures.append(f"{mode} mode ran the eager tape")
    if not row["mesh_active"]:
        failures.append(f"{mode}: kvstore='tpu' resolved no mesh for "
                        f"{row['spec']}")
    for key, b in budget.items():
        if row.get(key, 0) > b:
            failures.append(f"{mode} {key} = {row[key]} exceeds budget {b}")
    if "accum_used_compiled" in row and not row["accum_used_compiled"]:
        failures.append(f"{mode} accumulation ran the eager tape")
    return failures


def placement_checked(row: dict) -> bool:
    """The placement checks need more than one rank."""
    return row["n_devices"] > 1


def mesh_failures(row: dict) -> list:
    failures = _mesh_lane_failures(row, MESH_BUDGET)
    if placement_checked(row) and row["mesh_devices"] != row["n_devices"]:
        failures.append(f"the mesh spans {row['mesh_devices']} of "
                        f"{row['n_devices']} ranks")
    return failures


def fsdp_failures(row: dict) -> list:
    failures = _mesh_lane_failures(row, FSDP_BUDGET)
    if placement_checked(row) and row["param_bytes_frac"] > 0.75:
        failures.append(
            f"fsdp: parameter bytes a rank are {row['param_bytes_frac']:.2f}"
            "x the whole (expected about 1/fsdp)")
    return failures


def pp_failures(row: dict) -> list:
    failures = _mesh_lane_failures(row, PP_BUDGET)
    if placement_checked(row) and not row["stage_sharded"]:
        failures.append(f"pp: the stage buffer is not one stage a pp group "
                        f"(spec {row['stage_spec']}, block "
                        f"{row['stage_block']})")
    return failures


def moe_failures(row: dict) -> list:
    failures = _mesh_lane_failures(row, MOE_BUDGET)
    if placement_checked(row) and not row["expert_sharded"]:
        failures.append(f"moe: the expert weights are not one expert an ep "
                        f"group (block {row['expert_block']})")
    return failures


def measure_mesh_lanes(device: str, specs: dict) -> dict:
    """Every mesh lane on this process's world, by ``specs``."""
    out = {}
    for lane in MESH_LANES:
        out[lane] = LANES[lane][0](device, specs[lane])
    return out


# ---------------------------------------------------------------------------
# the router and spec lanes
# ---------------------------------------------------------------------------
def measure_router(device: str = "cuda") -> dict:
    """The same sequential request stream through a bare GenerativeEngine
    and through a ReplicaRouter over that one replica (hedging off,
    breaker closed)."""
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
    with knobs(MXNET_TELEMETRY_TRACE="0"):
        routed_off = run(True)
    return {
        "mode": "router", "device": device, "requests": len(prompts),
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


def router_failures(router: dict) -> list:
    failures = []
    for key, budget in ROUTER_BUDGET.items():
        if router[key] > budget:
            failures.append(f"router {key} = {router[key]} exceeds budget "
                            f"{budget} (zero-overhead-off broken)")
    if not router["outputs_equal"]:
        failures.append(
            "router-wrapped token streams differ from the bare engine's")
    if router["leaked_pages"]:
        failures.append(
            f"router lane leaked {router['leaked_pages']} KV pages")
    if not router["traced_off_outputs_equal"]:
        failures.append("router token streams under MXNET_TELEMETRY_TRACE=0 "
                        "differ from the bare engine's")
    for key in TRACED_OFF:
        if router[key] != 0:
            failures.append(f"router {key} = {router[key]} with tracing "
                            "disabled (must be 0: zero overhead when off)")
    return failures


def measure_spec(device: str = "cuda") -> dict:
    """A high-agreement draft drives a mixed greedy / sampled join-retire
    storm; then the off leg against a draft-free engine."""
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
    with knobs(MXNET_SPEC_DECODE="1"):
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
            "mode": "spec", "device": device, "errors": errs,
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

    with knobs(MXNET_SPEC_DECODE="0"):
        bare = run_off(False)
        offd = run_off(True)
    row["greedy_off_extra_dispatches"] = (offd["dispatches"]
                                          - bare["dispatches"])
    row["greedy_off_extra_retraces"] = offd["retraces"] - bare["retraces"]
    row["greedy_off_outputs_equal"] = offd["outs"] == bare["outs"]
    row["leaked_pages"] += bare["leaked_pages"] + offd["leaked_pages"]
    return row


def spec_failures(spec: dict) -> list:
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
    return failures


def store_failures(evictions_after_warm: int) -> list:
    if evictions_after_warm > STORE_BUDGET["evictions_after_warm"]:
        return [f"the program store evicted {evictions_after_warm} "
                "programs in the steady-state runs"]
    return []


# lane -> (measure(device[, spec]), failures(row))
LANES = {
    "compiled": (measure_compiled, compiled_failures),
    "amp": (measure_amp, amp_failures),
    "sentinel": (measure_sentinel, sentinel_failures),
    "serving": (measure_serving, serving_failures),
    "decode": (measure_decode, decode_failures),
    "mesh": (measure_mesh, mesh_failures),
    "fsdp": (measure_fsdp, fsdp_failures),
    "pp": (measure_pp, pp_failures),
    "moe": (measure_moe, moe_failures),
    "router": (measure_router, router_failures),
    "spec": (measure_spec, spec_failures),
}


# ---------------------------------------------------------------------------
# the gloo world of the mesh lanes on the CPU
# ---------------------------------------------------------------------------
def _world_rank(rank, world, store, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        rows = measure_mesh_lanes("cpu", MESH_SPECS[world])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f, default=str)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_mesh_world(world: int, deadline: float = 300.0) -> list:
    """The mesh lanes on every rank of a gloo world of ``world`` spawned
    processes; each rank's rows, in rank order."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_dispatch_world_") as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_world_rank,
                             args=(r, world, store, d))
                 for r in range(world)]
        for p in procs:
            p.start()
        import time

        end = time.monotonic() + deadline
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung:
            raise RuntimeError(f"the world of {world} outlived its "
                               f"{deadline} s deadline")
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"the ranks exited with {codes}")
        rows = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                rows.append(json.load(f))
        return rows


def _line(row: dict) -> str:
    return f"torch_check_dispatch_budget: {json.dumps(row, default=str)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=4, choices=(4, 8),
                    help="gloo world of the mesh lanes with --device cpu")
    ap.add_argument("--lanes", default=",".join(LANES),
                    help="comma-separated lanes (default: all)")
    a = ap.parse_args(argv)
    lanes = [l for l in a.lanes.split(",") if l]
    unknown = sorted(set(lanes) - set(LANES))
    if unknown:
        ap.error(f"unknown lanes {unknown}; known: {sorted(LANES)}")
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_check_dispatch_budget: no CUDA device (pass "
                  "--device cpu)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx = _ctx(a.device) if a.device == "cpu" else contextlib.nullcontext()
    failures = []
    with ctx:
        ev0 = evictions()
        mesh_rows = None
        if a.device == "cpu" and set(lanes) & set(MESH_LANES):
            mesh_rows = run_mesh_world(a.world)
        for lane in lanes:
            measure, lane_failures = LANES[lane]
            if lane in MESH_LANES:
                rows = [r[lane] for r in mesh_rows] if mesh_rows else \
                    [measure(a.device, MESH_SPECS[1][lane])]
            else:
                rows = [measure(a.device)]
            for rank, row in enumerate(rows):
                if lane in MESH_LANES and not placement_checked(row):
                    row["placement"] = "skipped: a mesh of one rank"
                if rank == 0:
                    print(_line(dict(row, ranks=len(rows))))
                failures += [f"{lane}: {f}" + (f" (rank {rank})" if rank
                                               else "")
                             for f in lane_failures(row)]
            if lane == "compiled":
                print(_line(measure_eager(a.device)))
        ev = evictions() - ev0
        print(_line({"mode": "store", "evictions_after_warm": ev,
                     "second_process": "not ported: no persistent program "
                                       "cache"}))
        failures += store_failures(ev)
    if failures:
        print("torch_check_dispatch_budget: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"torch_check_dispatch_budget: lanes {', '.join(lanes)} inside "
          "their budgets")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
