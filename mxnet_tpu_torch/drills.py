"""Deterministic end-to-end preemption, recovery and availability drills.

Counterpart of ``mxnet_tpu/drills.py``: every scenario kills, wedges or
poisons real processes running the port's compiled train step, its
checkpoints, its sentinel, its generative engines and its replica router,
and measures what recovery costs. Each drill is a scripted subprocess run,
fully deterministic: children send their own SIGTERM / SIGKILL at a
scripted step, batches derive from the step index, and greedy decode is
token-exact, so a drill either reproduces bit for bit or fails loudly.

The recovery matrix (:data:`SCENARIOS`,
``tools/torch_check_recovery_budget.py``):

- ``sigterm_drain``: SIGTERM mid-run under the compiled ``TrainStep`` with
  the prefetcher and the asynchronous checkpoint writer: the child drains,
  force-saves the last completed step and exits 83; the restarted child
  resumes with 0 steps replayed and a loss trajectory bitwise the
  uninterrupted reference's.
- ``sigkill_between_saves``: SIGKILL between periodic saves: the restart
  restores the newest complete checkpoint and replays the gap
  deterministically, with no temp file left.
- ``topology_change``: a checkpoint of a world of 4 restored into a world
  of 2 (``restore(like=)``): bit-exact re-placement, two resumes bitwise
  equal, the trajectory within ``TOPO_RTOL`` of the world-of-4 reference.
- ``corrupt_latest``: one payload byte of the newest checkpoint flipped:
  restore degrades to the previous complete step
  (``checkpoint.digest_mismatches``) and the replay lands bitwise.
- ``decode_drain``: SIGTERM mid-stream under ``GenerativeEngine``: live rows
  finish token-exact, queued requests shed typed ``draining``, 0 KV pages
  leak, and a second process serves the shed requests token-exact.
- ``bitflip_param``: one bit of ONE rank's replica of a parameter flipped
  mid-run: the sentinel's cross-rank digest vote names that rank, rollback
  restores the last verified checkpoint, the trajectory is bitwise the
  reference's, and a restart leaves the quarantined rank out of the mesh.
- ``loss_spike``: a poisoned batch (targets x 1e6): the sentinel's window
  trips before the tainted state is saved, rollback replays the save gap,
  the merged trajectory is bitwise the reference's.

The availability matrix (:data:`ROUTER_SCENARIOS`,
``tools/torch_check_availability_budget.py``), over a 2-replica
``serving_router.ReplicaRouter``: ``router_kill`` (replica 0's program
dispatch starts raising mid-decode; then a preemption notice still drains
the router to exit 83), ``router_wedge`` (replica 0's program dispatch
hangs; the heartbeat wedge timeout evicts it), ``router_flap`` (a burst of
transient errors opens the breaker; the half-open probe re-admits it),
``router_deadline_storm`` (infeasible budgets shed typed ``deadline`` in
bounded time, feasible ones deliver), ``router_prefix_storm`` (one shared
system prompt converges the fleet on the warm replica, which is then
killed), ``router_scale_storm`` (a ``FleetSupervisor`` grows the fleet 1 ->
3 with ``replica`` child processes and shrinks it back, each scale-down a
graceful preemption that exits 83), ``router_host_loss`` (a remote
replica's process SIGKILLed mid-storm) and ``spec_draft_poison`` (both
replicas speculate with a high-agreement draft whose draft-round program
then raises: each engine's spec round turns speculation off and decodes
plainly in place, with no failover, no drop and the same tokens). Every
cell holds 0 dropped requests, every delivery token-exact against
``eager_generate``, 0 leaked KV pages and a clean ``PagePool.audit()``.

Differences by design:

- The reference kills or wedges a replica by swapping its compiled
  programs; the port replaces the engine's program dispatch on the host
  (``GenerativeEngine._call``), so nothing ever sleeps or raises inside a
  capture. A wedge blocks until the drill releases it before its final
  drain (an operator killing the wedged replica).
- There is no persistent program cache (a CUDA graph lives in one
  process). Where the reference gates ``fresh_compiles == 0`` on a warm
  ``MXNET_PROGRAM_CACHE_DIR``, the port's children report
  ``warmup_captures`` (what a joiner or a restart captures before it
  serves or steps) and ``captures_after_warmup``, and the gates hold
  ``captures_after_warmup == 0``. ``join_to_first_served_s`` therefore
  includes process start, CUDA initialization and the warm-up captures.
- The reference's multi-device child is one process over virtual devices;
  a mesh of the port is a ``torch.distributed`` world, so a train child of
  N devices is a world of N processes (``--world``/``--rank``, a
  ``file://`` store, a deadline on the join). Each rank sends the scripted
  SIGTERM or SIGKILL to itself at the same step; a world whose rank dies
  is torn down by the orchestrator, never left in a collective until the
  backend's timeout. A graceful drain saves the step after the signal's
  (the cooperative drain of ``parallel/elastic.py``), so the child signals
  at the end of step ``sigterm_at - 1``, and the restore point is
  ``sigterm_at`` as in the reference. The bit flip hits one rank's replica
  and the vote names that rank (``quarantine.json`` holds it as a rank).
- On a machine with one GPU, ``topology_change`` and ``bitflip_param`` run
  as gloo worlds on the CPU (their reports say ``"device": "cpu"``); the
  other train drills run as a world of one on the card.

``run_drill(name, root, device=)`` runs one scenario (the children share
``root``'s memoized reference runs) and returns a report with the
reference's keys. Children: ``python -m mxnet_tpu_torch.drills
train|decode|router|replica ... --device cuda|cpu``; ``python -m
mxnet_tpu_torch.drills run [scenario ...] --device cpu`` orchestrates.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

__all__ = ["SCENARIOS", "ROUTER_SCENARIOS", "run_drill", "main",
           "N_STEPS", "SAVE_EVERY", "ROWS"]

SCENARIOS = ("sigterm_drain", "sigkill_between_saves", "topology_change",
             "corrupt_latest", "decode_drain", "bitflip_param",
             "loss_spike")
# the serving-availability matrix; kept out of SCENARIOS so the recovery
# gate's matrix is unchanged
ROUTER_SCENARIOS = ("router_kill", "router_wedge", "router_flap",
                    "router_deadline_storm", "router_prefix_storm",
                    "router_scale_storm", "router_host_loss",
                    "spec_draft_poison")

# the scripted workload every train drill shares
N_STEPS = 24
SAVE_EVERY = 4
ROWS = 16
HALF = N_STEPS // 2
# cross-world tolerance: a world of 4 and a world of 2 reduce their
# gradients in different orders (same-world comparisons are bitwise)
TOPO_RTOL = 1e-4
# the worlds of the multi-device drills (the reference's device counts)
TOPO_WORLDS = (4, 2)
BITFLIP_WORLD = 4
# the drills that need a world of several ranks run on the CPU (gloo)
CPU_WORLD_DRILLS = ("topology_change", "bitflip_param")
# the serving children's model (the reference's drill widths)
DRILL_LM = dict(vocab=50, d_model=16, n_layers=1, n_heads=2, max_seq=96)
WORLD_DEADLINE_S = 300.0

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# shared child workload pieces (the parent orchestrator stays import-light)
# ---------------------------------------------------------------------------

def _host_batch(i: int):
    import numpy as onp

    rng = onp.random.RandomState(10_000 + int(i))
    return (rng.randn(ROWS, 8).astype(onp.float32),
            rng.randn(ROWS, 4).astype(onp.float32))


def _drill_net(seed: int = 0, device: str = "cpu"):
    """The reference's drill net (Dense 8 -> 16 relu -> 4), its parameters
    drawn from ``RandomState(seed)`` in sorted-name order, hybridized."""
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

    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    net = Net()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.from_numpy(
            (rng.randn(*p.shape) * 0.1).astype(onp.float32)).to(device))
    net.hybridize()
    return net


def _drill_loss(net, x, y):
    return ((net(x) - y) ** 2).mean()


def _params_sha(named) -> str:
    """sha256 over ``(name, bytes)`` of a ``{name: tensor}`` map, sorted."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(named):
        h.update(k.encode())
        h.update(named[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _flip_param_bit(net) -> None:
    """Silent-corruption injection: flip ONE mantissa bit of this rank's
    replica of the first parameter, in place (what a mis-executing device
    or a memory upset produces on one replica)."""
    import torch

    _name, p = sorted(net.collect_params().items())[0]
    t = p._check() if hasattr(p, "_check") else p.data()
    with torch.no_grad():
        bits = t.view(torch.int32).view(-1)
        bits[3] ^= (1 << 20)


def _init_world(a) -> None:
    """Join the drill's ``torch.distributed`` world (a world of several
    ranks only: a world of one is the one device, no process group)."""
    if a.world <= 1:
        return
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    backend = "nccl" if a.device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{a.store}",
                            rank=a.rank, world_size=a.world)


def _cuda_setup(device: str) -> None:
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda without a CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# child: train drill
# ---------------------------------------------------------------------------

def _cmd_train(a) -> int:
    t_proc0 = time.monotonic()
    import torch

    _cuda_setup(a.device)
    _init_world(a)
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import (cached_step, engine, gluon, preemption,
                                 telemetry)
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.elastic import (CheckpointManager,
                                                  run_elastic)

    lead = a.rank == 0
    net = _drill_net(seed=0, device=a.device)
    trainer = gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9}, kvstore="tpu")
    step = trainer.compile_step(net, _drill_loss)
    snt = None
    if a.sentinel_every:
        # constructed BEFORE the mesh resolves: a quarantine persisted by a
        # prior incarnation leaves its suspects out of this world's mesh
        from mxnet_tpu_torch import sentinel as _sentinel

        snt = _sentinel.Sentinel(step=step, directory=a.ckpt,
                                 every=a.sentinel_every)
    rank_res = {"label": a.label, "rank": a.rank, "pid": os.getpid(),
                "excluded": False}

    def _write_rank() -> None:
        with open(os.path.join(a.dir, f"result-{a.label}-r{a.rank}.json"),
                  "w") as f:
            json.dump(rank_res, f, default=str)

    try:
        mesh = step.mesh
    except MXNetError as e:
        # this rank is quarantined: it took its part in making the mesh of
        # the admitted ranks and leaves
        rank_res.update(excluded=True, error=str(e))
        _write_rank()
        return 0
    # files numbered by the ranks of the mesh the state lives on
    ckpt = CheckpointManager(a.ckpt, keep=20, async_save=True, mesh=mesh)
    live = trainer.state_tree(net)
    losses_f = (open(os.path.join(a.dir, f"losses-{a.label}.txt"), "a",
                     buffering=1) if lead else None)
    world = a.world

    # one-shot scripted events: after a rollback the replay regenerates the
    # SAME step indices, and a re-fired poison or flip would make the drill
    # diverge forever instead of proving bit-exact recovery
    fired = {"poison": False, "flip": False}

    def _drill_batch(j: int):
        x, y = _host_batch(j)
        if a.poison_at is not None and j == a.poison_at \
                and not fired["poison"]:
            fired["poison"] = True
            y = (y * 1e6).astype(y.dtype)
        return torch.from_numpy(x), torch.from_numpy(y)

    # depth-k prefetcher staging batches onto the device; restarted from
    # the restored index after every restore (the input pipeline is part
    # of what restore-and-replay rebuilds)
    pf = {"it": None, "next": -1}

    def _get_batch(i: int):
        if pf["it"] is None or pf["next"] != i:
            if hasattr(pf["it"], "close"):
                pf["it"].close()
            pf["it"] = iter(engine.prefetch(
                (_drill_batch(j) for j in range(i, a.stop_at)), depth=2,
                device=a.device))
            pf["next"] = i
        pf["next"] = i + 1
        return next(pf["it"])

    marks = {"t_first": None, "warm": None, "n": 0}
    captures0 = cached_step.trace_count()
    restored_at = [None]
    restored_sha = [None]
    flipped = [None]
    warm_after = max(1, a.sentinel_every or 1)

    def _global_loss(loss) -> float:
        val = loss.detach().reshape(-1)[:1].to(torch.float32).clone()
        if world > 1:
            import torch.distributed as dist

            group = getattr(mesh, "world_group", None)
            dist.all_reduce(val, group=group)
            val /= dist.get_world_size(group)
        return float(val.cpu()[0])

    def step_fn(state, i):
        if a.sigkill_at is not None and i == a.sigkill_at:
            # let the queued asynchronous saves land first so the restore
            # point is deterministic; the kill still falls BETWEEN save
            # boundaries (every rank kills itself at this step, before any
            # collective of it)
            ckpt.wait()
            os.kill(os.getpid(), signal.SIGKILL)     # no grace, no drain
        if a.bitflip_at is not None and i == a.bitflip_at \
                and not fired["flip"]:
            fired["flip"] = True
            if a.rank == a.bitflip_dev % max(world, 1):
                _flip_param_bit(net)
                flipped[0] = a.rank
        x, y = _get_batch(i)
        loss = step(x, y, batch_size=ROWS)
        lval = _global_loss(loss)
        if lead:
            losses_f.write(f"{i} {lval.hex()}\n")
        marks["n"] += 1
        if marks["t_first"] is None:
            marks["t_first"] = time.monotonic()
        if marks["n"] == warm_after:
            marks["warm"] = cached_step.trace_count()
        if a.sigterm_at is not None and i + 1 == a.sigterm_at \
                and restored_at[0] is None:
            # a real preemption notice through the installed handler; the
            # cooperative drain saves step sigterm_at at the boundary
            os.kill(os.getpid(), signal.SIGTERM)
        if a.delay:
            time.sleep(a.delay)
        return state

    def on_restore(tree, s):
        restored_at[0] = s
        restored_sha[0] = _params_sha(tree["params"])
        trainer.load_state_tree(tree, net)
        pf["next"] = -1                 # restart the input pipeline
        return live

    preempted: Optional[int] = None
    steps_run = restarts = None
    try:
        _out, steps_run, restarts = run_elastic(
            step_fn, live, range(a.stop_at), ckpt,
            save_every=a.save_every, max_restarts=a.max_restarts,
            on_restore=on_restore, anomaly_fn=snt, preemption=a.preempt)
    except preemption.Preempted as e:
        preempted = int(e.code)
    engine.waitall()
    snap = telemetry.snapshot()
    telemetry.flush()
    captures = cached_step.trace_count() - captures0
    warm = marks["warm"] if marks["warm"] is not None \
        else cached_step.trace_count()
    rank_res.update(flipped=flipped[0], preempted_code=preempted)
    _write_rank()
    if lead:
        res = {
            "label": a.label, "pid": os.getpid(), "device": a.device,
            "world": world,
            "preempted_code": preempted,
            "steps_run": steps_run, "restarts": restarts,
            "restored_at": restored_at[0],
            "restored_params_sha": restored_sha[0],
            "params_sha": _params_sha(live["params"]),
            "warmup_captures": warm - captures0,
            "captures_after_warmup": captures - (warm - captures0),
            "recovery_s": snap.get("elastic.recovery_s"),
            "steps_replayed": snap.get("elastic.steps_replayed"),
            "drain_s": snap.get("preemption.drain_s"),
            "digest_mismatches": snap.get("checkpoint.digest_mismatches"),
            "wall_s": time.monotonic() - t_proc0,
            "first_step_s": (marks["t_first"] - t_proc0
                             if marks["t_first"] is not None else None),
            "mesh_ranks": (list(getattr(mesh, "ranks", None)
                                or range(mesh.size))
                           if mesh is not None else None),
            "sentinel_digests": snap.get("sentinel.digests"),
            "replica_divergence": snap.get("sentinel.replica_divergence"),
            "rollbacks": snap.get("sentinel.rollbacks"),
            "last_rollback": snt.last_rollback if snt is not None else None,
            "quarantine": (snt.quarantine.entries()
                           if snt is not None else None),
            "corruption_events": telemetry.events(kind="corruption"),
            "telemetry": snap,
        }
        with open(os.path.join(a.dir, f"result-{a.label}.json"), "w") as f:
            json.dump(res, f, default=str)
    ckpt.close()
    return preempted or 0


# ---------------------------------------------------------------------------
# child: decode drill
# ---------------------------------------------------------------------------

def _decode_prompt(r: int) -> List[int]:
    return [1 + (r * 7 + j) % 49 for j in range(5 + r % 3)]


def _drill_engine(sd, model, params, name, device, **kw):
    eng = sd.GenerativeEngine(model, params=params,
                              pool=sd.PagePool(pages=64, page=8),
                              max_rows=2, name=name, device=device, **kw)
    return eng


def _cmd_decode(a) -> int:
    import threading

    _cuda_setup(a.device)
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import engine, preemption, telemetry
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch.faults import ShedError

    model = sd.TinyCausalLM(**DRILL_LM)
    params = model.init_params(0, device=a.device)
    eng = _drill_engine(sd, model, params, "drill", a.device)
    warmed = eng.warmup(max_len=8)
    t_warm = sd.trace_count()
    if a.preempt:
        preemption.install()
    req_ids = [int(r) for r in a.requests.split(",") if r != ""]
    delivered: Dict[int, List[int]] = {}
    shed: Dict[int, Optional[str]] = {}
    trigger = {"fired": False}
    lock = threading.Lock()

    go = threading.Event()

    def worker(r: int):
        go.wait()
        try:
            toks = eng.generate(_decode_prompt(r), max_new_tokens=a.max_new)
            with lock:
                delivered[r] = [int(t) for t in toks]
        except ShedError as e:
            with lock:
                shed[r] = getattr(e, "kind", None)
        except BaseException as e:          # a drill failure, reported
            with lock:
                shed[r] = f"error:{e!r}"
        with lock:
            fire = (a.self_sigterm and not trigger["fired"]
                    and len(delivered) >= 1)
            trigger["fired"] = trigger["fired"] or fire
        if fire:
            # deterministic mid-stream preemption: the FIRST delivery
            # proves decode is rolling, other rows are live and the queue
            # is not empty
            os.kill(os.getpid(), signal.SIGTERM)

    threads = [threading.Thread(target=worker, args=(r,)) for r in req_ids]
    for t in threads:
        t.start()
    preempted: Optional[int] = None
    try:
        # the requests start only here, inside the handler's scope: on a
        # fast device the first delivery (and so the notice) can come
        # before the main thread has started every worker
        go.set()
        for t in threads:
            while t.is_alive():
                t.join(timeout=0.05)     # interruptible by the handler
    except preemption.Preempted as e:
        preempted = int(e.code)
        for t in threads:
            t.join(timeout=30.0)        # the drain already completed them
    engine.waitall()
    # token-exact against the eager oracle on a deterministic subset
    verify = sorted(delivered)[:2]
    token_exact = all(
        delivered[r] == sd.eager_generate(model, params, _decode_prompt(r),
                                          a.max_new)
        for r in verify)
    snap = telemetry.snapshot()
    telemetry.flush()
    res = {
        "label": a.label, "device": a.device,
        "preempted_code": preempted,
        "delivered": {str(r): t for r, t in delivered.items()},
        "shed": {str(r): k for r, k in shed.items()},
        "token_exact": token_exact,
        "pool_in_use": eng.pool_in_use(),
        "pool_audit": eng.pool_audit(),
        "warmup_captures": warmed,
        "captures_after_warmup": sd.trace_count() - t_warm,
        "drain_s": snap.get("preemption.drain_s"),
        "telemetry": snap,
    }
    with open(os.path.join(a.dir, f"result-{a.label}.json"), "w") as f:
        json.dump(res, f, default=str)
    return preempted or 0


# ---------------------------------------------------------------------------
# child: router chaos drill (the serving-availability matrix)
# ---------------------------------------------------------------------------

def _token_exact(sd, model, params, records, prompt_of, max_new) -> bool:
    """Every delivered record's tokens against ``eager_generate`` of its
    prompt (one oracle run a distinct prompt); a mismatch keeps the
    oracle's tokens in its record."""
    exact = True
    oracle: Dict[str, List[int]] = {}
    for rid, rec in sorted(records.items()):
        if rec["status"] != "delivered":
            continue
        key = str(prompt_of(rid))
        if key not in oracle:
            oracle[key] = sd.eager_generate(model, params, prompt_of(rid),
                                            max_new)
        if rec["tokens"] != oracle[key]:
            exact = False
            rec["oracle"] = oracle[key]
    return exact


def _router_prompt(r: int) -> List[int]:
    return [1 + (r * 5 + j) % 47 for j in range(4 + r % 4)]


# the prefix-storm system prompt: 3 full page-blocks (page=8) every storm
# request shares
_STORM_SYS = [2 + (j * 11) % 43 for j in range(24)]


def _storm_prompt(r: int) -> List[int]:
    # every 3rd request is byte-identical (full hit); the rest diverge
    # after the shared system prompt (partial hit + copy-on-write fork)
    if r % 3 == 0:
        return list(_STORM_SYS)
    return _STORM_SYS + [5 + (r * 7 + j) % 41 for j in range(2 + r % 3)]


class _Wedge:
    """A replica's program dispatch that hangs until the drill releases it
    (then raises, as a killed replica would): a host-side wedge, never a
    sleep inside a capture."""

    def __init__(self):
        import threading

        self.release = threading.Event()

    def __call__(self, *args, **kw):
        self.release.wait(timeout=120.0)
        raise RuntimeError("wedged dispatch released")


def _kill_dispatch(eng, why: str) -> None:
    """Replace ``eng``'s program dispatch (plain and speculative) with one
    that raises: from the host, exactly what an engine whose device
    context died mid-decode looks like."""
    def boom(*args, **kw):
        raise RuntimeError(why)

    eng._call = boom
    eng._spec_call = boom


def _poison_draft(engines) -> None:
    """Make every engine's draft-round program raise, in each sampling
    form: the next spec round's dispatch fails, the engine turns
    speculation off and decodes that step and the rest plainly, with no
    failover and no drop."""
    from mxnet_tpu_torch import serving_decode as sd

    def poisoned(*args, **kw):
        raise RuntimeError("draft model poisoned mid-round")

    for e in engines:
        for form in sd.FORMS:
            e._spec_programs.insert(("draft_round", e._spec_kmax(), form),
                                    poisoned)


def _cmd_router(a) -> int:
    if a.mode in ("scale_storm", "host_loss"):
        return _cmd_router_fleet(a)
    import threading

    _cuda_setup(a.device)
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import engine, preemption, telemetry
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch.faults import ShedError
    from mxnet_tpu_torch.serving_router import ReplicaRouter

    spec_kw: Dict[str, Any] = {}
    if a.mode == "spec_draft_poison":
        # a HIGH-agreement pair, so the steady phase demonstrably engages
        # speculation before the draft is poisoned (the knob is uncached)
        os.environ["MXNET_SPEC_DECODE"] = "1"
        model, params, draft, dparams = sd.high_agreement_pair(
            vocab=50, d_model=16, target_layers=2, draft_layers=1,
            n_heads=2, max_seq=96, device=a.device)
        spec_kw = dict(draft=draft, draft_params=dparams, spec_k=4)
    else:
        model = sd.TinyCausalLM(**DRILL_LM)
        params = model.init_params(0, device=a.device)
    engines = [_drill_engine(sd, model, params, f"rep{i}", a.device,
                             **spec_kw) for i in range(2)]
    warmed = [e.warmup(max_len=8) for e in engines]
    t_warm = sd.trace_count() + sd.spec_trace_count()
    router = ReplicaRouter(
        engines, name="drill", breaker_errs=2, breaker_cooldown_s=0.5,
        wedge_s=(1.5 if a.mode == "wedge" else 30.0), hedge_pctl=0)
    if a.preempt:
        preemption.install()
    prompt_of = (_storm_prompt if a.mode == "prefix_storm"
                 else _router_prompt)

    records: Dict[int, Dict[str, Any]] = {}
    lock = threading.Lock()

    def fire(rid: int, deadline_us: Optional[int] = None) -> None:
        t0 = time.monotonic()
        rec: Dict[str, Any] = {
            "budget_s": deadline_us / 1e6 if deadline_us else None}
        try:
            toks = router.generate(prompt_of(rid), max_new_tokens=a.max_new,
                                   deadline_us=deadline_us)
            rec.update(status="delivered", tokens=[int(t) for t in toks])
        except ShedError as e:
            rec.update(status="shed", kind=getattr(e, "kind", None))
        except BaseException as e:   # a drill failure, reported
            rec.update(status="error", error=repr(e))
        rec["elapsed_s"] = time.monotonic() - t0
        with lock:
            records[rid] = rec

    # -- phase A: steady state (sequential; also warms the cost table) --
    for rid in range(a.steady):
        fire(rid)
    steady_lat = sorted(records[r]["elapsed_s"] for r in range(a.steady)
                        if records[r]["status"] == "delivered")
    steady_p99_s = (steady_lat[min(len(steady_lat) - 1,
                                   int(len(steady_lat) * 0.99))]
                    if steady_lat else None)
    spec_before = ([e.stats()["spec_rounds"] for e in engines]
                   if spec_kw else None)

    # -- chaos injection -------------------------------------------------
    orig_gen = engines[0].generate
    flap_calls = {"n": 0}
    wedge = _Wedge()

    def apply_chaos() -> None:
        if a.mode in ("kill", "prefix_storm"):
            _kill_dispatch(engines[0], "replica 0 killed mid-decode")
        elif a.mode == "wedge":
            engines[0]._call = wedge
        elif a.mode == "flap":
            def flaky(*args, **kw):
                flap_calls["n"] += 1
                if flap_calls["n"] <= 4:
                    raise faults.TransientFault(f"flap {flap_calls['n']}")
                return orig_gen(*args, **kw)
            engines[0].generate = flaky
        elif a.mode == "spec_draft_poison":
            _poison_draft(engines)

    # -- phase B: chaos under concurrent load ---------------------------
    base = a.steady
    chaos_ids = list(range(base, base + a.requests))
    if a.mode == "deadline_storm":
        # alternating infeasible (3 ms: the cost table prices a
        # max_new-token request far above it) and feasible budgets
        budgets = {rid: (3_000 if i % 2 == 0 else 30_000_000)
                   for i, rid in enumerate(chaos_ids)}
    else:
        budgets = {rid: None for rid in chaos_ids}
    if a.mode in ("wedge", "flap", "spec_draft_poison"):
        # armed before the storm starts, so that the first chaos dispatch
        # already meets it
        apply_chaos()
    threads = [threading.Thread(target=fire, args=(rid, budgets[rid]))
               for rid in chaos_ids]
    for t in threads:
        t.start()
    if a.mode in ("kill", "prefix_storm"):
        # strike while replica 0 is actively decoding chaos rows (bounded
        # poll); in the prefix storm replica 0 is also the affinity target
        d0 = engines[0]._stats["decode_steps"]
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if engines[0]._stats["decode_steps"] > d0 and \
                    len(engines[0]._live) > 0:
                break
            time.sleep(0.001)
        apply_chaos()
    for t in threads:
        t.join(timeout=180.0)

    # -- flap: measure breaker re-admission (probe budget) --------------
    re_admit_s = None
    if a.mode == "flap":
        t0 = time.monotonic()
        deadline = t0 + 10.0
        while time.monotonic() < deadline:
            if router.breaker_state(0) == "closed":
                re_admit_s = time.monotonic() - t0
                break
            fire(10_000 + int((time.monotonic() - t0) * 1000))
            time.sleep(0.05)

    # -- kill: the preemption leg; the router must still drain ---------
    preempted: Optional[int] = None
    drain_ids: List[int] = []
    if a.preempt:
        drain_ids = list(range(20_000, 20_000 + 4))
        sig = {"fired": False}
        go = threading.Event()

        def drain_worker(rid: int) -> None:
            go.wait()
            fire(rid)
            with lock:
                fire_now = not sig["fired"] and any(
                    records.get(r, {}).get("status") == "delivered"
                    for r in drain_ids if r in records)
                sig["fired"] = sig["fired"] or fire_now
            if fire_now:
                os.kill(os.getpid(), signal.SIGTERM)

        dthreads = [threading.Thread(target=drain_worker, args=(rid,))
                    for rid in drain_ids]
        for t in dthreads:
            t.start()
        try:
            go.set()                  # inside the handler's scope
            for t in dthreads:
                while t.is_alive():
                    t.join(timeout=0.05)
        except preemption.Preempted as e:
            preempted = int(e.code)
            for t in dthreads:
                t.join(timeout=30.0)
    # the wedged replica is released (an operator's kill) before the drain
    wedge.release.set()
    engine.waitall()

    token_exact = _token_exact(sd, model, params, records, prompt_of,
                               a.max_new)

    st = router.stats()
    pool_audit = [m for e in engines for m in e.pool_audit()]
    snap = telemetry.snapshot()
    hit_blocks = int(snap.get("prefix.hit_blocks", 0))
    miss_blocks = int(snap.get("prefix.miss_blocks", 0))
    telemetry.flush()
    res = {
        "label": a.label, "mode": a.mode, "pid": os.getpid(),
        "device": a.device,
        "preempted_code": preempted,
        "steady_ids": list(range(a.steady)),
        "chaos_ids": chaos_ids,
        "drain_ids": drain_ids,
        "records": {str(k): v for k, v in records.items()},
        "token_exact": token_exact,
        "steady_p99_s": steady_p99_s,
        "re_admit_s": re_admit_s,
        "leaked_pages": sum(e.pool_in_use() for e in engines),
        "pool_audit": pool_audit,
        "warmup_captures": sum(warmed),
        "captures_after_warmup": (sd.trace_count() + sd.spec_trace_count()
                                  - t_warm),
        "prefix_hit_blocks": hit_blocks,
        "prefix_miss_blocks": miss_blocks,
        "prefix_cow_forks": int(snap.get("prefix.cow_forks", 0)),
        "prefix_hit_rate": hit_blocks / max(hit_blocks + miss_blocks, 1),
        "router": {k: v for k, v in st.items() if k != "replicas"},
        "breakers": [r["breaker"] for r in st["replicas"]],
        "spec": [{k: e.stats()[k]
                  for k in ("spec_rounds", "spec_proposed",
                            "spec_accepted", "spec_fallbacks",
                            "spec_disabled")}
                 for e in engines] if spec_kw else None,
        "spec_rounds_before_poison": spec_before,
        "drain_s": snap.get("preemption.drain_s"),
        "telemetry": snap,
    }
    with open(os.path.join(a.dir, f"result-{a.label}.json"), "w") as f:
        json.dump(res, f, default=str)
    return preempted or 0


# ---------------------------------------------------------------------------
# child: one replica in its own process (the elastic fleet's unit)
# ---------------------------------------------------------------------------

def _cmd_replica(a) -> int:
    """Warm a ``GenerativeEngine`` (its captures), serve it over
    ``serving_remote.ReplicaServer``, and wait for retirement: a graceful
    preemption (the router's ``preempt`` op -> SIGTERM -> typed draining
    sheds -> waitall -> result JSON -> exit 83) or a SIGKILL (the host-loss
    cell: no goodbye at all)."""
    _cuda_setup(a.device)
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import engine, preemption, telemetry
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch.serving_remote import ReplicaServer

    model = sd.TinyCausalLM(**DRILL_LM)
    params = model.init_params(0, device=a.device)
    eng = _drill_engine(sd, model, params, a.label, a.device)
    warmed = eng.warmup(max_len=8)
    t_warm = sd.trace_count()
    preemption.install()
    srv = ReplicaServer(eng, name=a.label).start()
    # the port file is the join handshake, written AFTER warm-up: the
    # supervisor's join clock prices the whole boot
    tmp = os.path.join(a.dir, f"port-{a.label}.tmp")
    with open(tmp, "w") as f:
        f.write(f"{srv.port}\n")
    os.replace(tmp, os.path.join(a.dir, f"port-{a.label}.txt"))
    t0 = time.monotonic()
    preempted: Optional[int] = None
    try:
        while time.monotonic() - t0 < a.ttl:   # orphan guard
            time.sleep(0.1)
    except preemption.Preempted as e:
        preempted = int(e.code)
    engine.waitall()
    snap = telemetry.snapshot()
    telemetry.flush()
    res = {
        "label": a.label, "pid": os.getpid(), "device": a.device,
        "preempted_code": preempted,
        "warmup_captures": warmed,
        "captures_after_warmup": sd.trace_count() - t_warm,
        "leaked_pages": eng.pool_in_use(),
        "pool_audit": list(eng.pool_audit()),
        "served": {k: v for k, v in eng.stats().items()
                   if isinstance(v, (int, float))},
        "drain_s": snap.get("preemption.drain_s"),
        "telemetry": snap,
    }
    with open(os.path.join(a.dir, f"result-{a.label}.json"), "w") as f:
        json.dump(res, f, default=str)
    srv.close()
    return preempted or 0


def _spawn_replica(scen_dir: str, label: str, device: str,
                   boot_timeout: float = 120.0):
    """Launch a ``replica`` child and wait for its port handshake. Returns
    ``(popen, port)``; the caller owns the process. The environment is
    inherited (the fleet shares ``MXNET_TELEMETRY_DIR``)."""
    port_path = os.path.join(scen_dir, f"port-{label}.txt")
    if os.path.exists(port_path):
        os.remove(port_path)
    log = open(os.path.join(scen_dir, f"replica-{label}.log"), "w")
    popen = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.drills", "replica",
         "--dir", scen_dir, "--label", label, "--device", device],
        stdout=log, stderr=subprocess.STDOUT, cwd=_REPO)
    deadline = time.monotonic() + boot_timeout
    while time.monotonic() < deadline:
        if os.path.exists(port_path):
            with open(port_path) as f:
                return popen, int(f.read().strip())
        if popen.poll() is not None:
            raise RuntimeError(f"replica {label} died during boot "
                               f"rc={popen.returncode}")
        time.sleep(0.05)
    popen.kill()
    popen.wait()
    raise RuntimeError(f"replica {label} never published its port")


def _cmd_router_fleet(a) -> int:
    """The elastic-fleet cells.

    ``scale_storm``: a ``FleetSupervisor`` over a 1-replica router under
    bursty load grows the fleet 1 -> 3 by spawning ``replica`` children
    (JOINING -> warm -> SERVING), one remote is gracefully preempted WHILE
    serving (typed draining sheds hand queued rows back over the wire),
    and the subsiding burst shrinks the fleet back to 1, each scale-down a
    scheduled graceful preemption (drain -> SIGTERM -> exit 83).

    ``host_loss``: a 2-replica router (local + remote) has the remote's
    process SIGKILLed mid-storm: every open call fails at once, failover
    redelivers token-exactly on the survivor, the breaker opens, and
    ``kill_to_recovered_s`` is measured for the gate."""
    import threading

    _cuda_setup(a.device)
    import mxnet_tpu_torch as mx  # noqa: F401
    from mxnet_tpu_torch import engine, telemetry
    from mxnet_tpu_torch import serving_decode as sd
    from mxnet_tpu_torch.faults import ShedError
    from mxnet_tpu_torch.serving_remote import RemoteReplica
    from mxnet_tpu_torch.serving_router import (FleetSupervisor,
                                                ReplicaRouter,
                                                REPLICA_SERVING)

    model = sd.TinyCausalLM(**DRILL_LM)
    params = model.init_params(0, device=a.device)
    local = _drill_engine(sd, model, params, "rep0", a.device)
    warmed = local.warmup(max_len=8)
    t_warm = sd.trace_count()

    def prompt_of(rid: int) -> List[int]:
        # bounded distinct prompts: the eager oracle replays each UNIQUE
        # prompt once
        return _router_prompt(rid % 29)

    records: Dict[int, Dict[str, Any]] = {}
    lock = threading.Lock()
    holder: Dict[str, Any] = {}

    def fire(rid: int) -> None:
        t0 = time.monotonic()
        rec: Dict[str, Any] = {}
        try:
            toks = holder["router"].generate(prompt_of(rid),
                                             max_new_tokens=a.max_new)
            rec.update(status="delivered", tokens=[int(t) for t in toks])
        except ShedError as e:
            rec.update(status="shed", kind=getattr(e, "kind", None))
        except BaseException as e:   # a drill failure, reported
            rec.update(status="error", error=repr(e))
        rec["elapsed_s"] = time.monotonic() - t0
        rec["done_at"] = time.monotonic()
        with lock:
            records[rid] = rec

    extra: Dict[str, Any] = {}
    procs: List[Dict[str, Any]] = []

    if a.mode == "host_loss":
        popen, port = _spawn_replica(a.dir, "r1", a.device)
        procs.append({"label": "r1", "popen": popen})
        remote = RemoteReplica("127.0.0.1", port, name="r1")
        router = ReplicaRouter([local, remote], name="drill",
                               breaker_errs=2, breaker_cooldown_s=0.5,
                               hedge_pctl=0)
        holder["router"] = router
        for rid in range(a.steady):
            fire(rid)
        base = a.steady
        chaos_ids = list(range(base, base + max(a.requests, 10)))
        threads = [threading.Thread(target=fire, args=(rid,))
                   for rid in chaos_ids]
        for t in threads:
            t.start()
        # strike while the remote is actively serving: the router's own
        # in-flight ledger for replica 1, no wire round trip
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if router._replicas[1].in_flight > 0:
                break
            time.sleep(0.002)
        os.kill(popen.pid, signal.SIGKILL)
        t_kill = time.monotonic()
        popen.wait(timeout=30)
        for t in threads:
            t.join(timeout=180.0)
        # recovery = the first delivery COMPLETED after the kill
        with lock:
            done_after = sorted(
                v["done_at"] - t_kill for v in records.values()
                if v["status"] == "delivered" and v["done_at"] > t_kill)
        extra["kill_to_recovered_s"] = (done_after[0] if done_after
                                        else None)
        # open the corpse's breaker deterministically with concurrent
        # fires (a lone sequential request always picks the idle local
        # replica)
        t0p = time.monotonic()
        rid = 30_000
        while (router.breaker_state(1) == "closed"
               and time.monotonic() - t0p < 15.0):
            burst = [threading.Thread(target=fire, args=(rid + k,))
                     for k in range(4)]
            rid += 4
            for t in burst:
                t.start()
            for t in burst:
                t.join(timeout=60.0)
        chaos_ids = sorted(r for r in records if r >= base)
        remote.close()
        extra["remote_rc"] = popen.returncode

    else:   # scale_storm
        router = ReplicaRouter([local], name="drill", breaker_errs=2,
                               breaker_cooldown_s=0.5, hedge_pctl=0)
        holder["router"] = router
        plock = threading.Lock()

        def spawn():
            with plock:
                ent: Dict[str, Any] = {
                    "label": f"r{len(procs) + 1}",
                    "t_spawn": time.monotonic(),
                    "first_served_s": None, "exit_code": None}
                procs.append(ent)
            popen, port = _spawn_replica(a.dir, ent["label"], a.device)
            ent["popen"] = popen
            rr = RemoteReplica("127.0.0.1", port, name=ent["label"])
            ent["rr"] = rr
            return rr

        def retire(eng_, index: int) -> None:
            ent = next((e for e in procs if e.get("rr") is eng_), None)
            try:
                eng_.preempt()
            except BaseException:
                pass        # already gone (the preempt-under-load leg)
            if ent is not None and ent.get("popen") is not None:
                try:
                    ent["exit_code"] = ent["popen"].wait(timeout=60)
                except subprocess.TimeoutExpired:
                    ent["popen"].kill()
                    ent["exit_code"] = -9
            eng_.close()

        sup = FleetSupervisor(router, spawn, retire=retire, enabled=True,
                              min_replicas=1, max_replicas=3,
                              cooldown_s=0.3, interval_s=0.05,
                              up_queue=0.75, down_queue=0.05,
                              pool_high=0.95,
                              warmup_kwargs={"max_len": 8})
        sup.start()
        for rid in range(a.steady):
            fire(rid)
        base = a.steady
        # -- the burst: keep ~12 requests in flight until the fleet
        # reaches 3 SERVING replicas and each joiner took traffic -------
        threads: List[threading.Thread] = []
        next_rid = base
        storm_deadline = time.monotonic() + 240.0
        while time.monotonic() < storm_deadline:
            threads = [t for t in threads if t.is_alive()]
            while len(threads) < 12:
                t = threading.Thread(target=fire, args=(next_rid,))
                next_rid += 1
                t.start()
                threads.append(t)
            for r in list(router._replicas):
                if r.index == 0 or r.state != REPLICA_SERVING:
                    continue
                ent = next((e for e in procs
                            if e.get("rr") is r.engine), None)
                if (ent is not None and ent["first_served_s"] is None
                        and r.in_flight > 0):
                    ent["first_served_s"] = round(
                        time.monotonic() - ent["t_spawn"], 3)
            if (router.fleet_stats()["scale_ups"] >= 2
                    and all(e["first_served_s"] is not None
                            for e in procs if e.get("rr"))):
                break
            time.sleep(0.01)
        # -- graceful preemption UNDER LOAD: SIGTERM the youngest remote
        # while rows are queued on it; the queued rows come back as typed
        # draining sheds over the wire and fail over token-exact
        victims = [e for e in procs if e.get("rr") is not None]
        queued_at_preempt = 0
        if victims:
            ent = victims[-1]
            vr = next((r for r in list(router._replicas)
                       if r.engine is ent["rr"]), None)
            deadline = time.monotonic() + 10.0
            while (vr is not None and time.monotonic() < deadline
                   and vr.in_flight < 3):
                time.sleep(0.002)
            queued_at_preempt = vr.in_flight if vr is not None else 0
            try:
                ent["rr"].preempt()
                ent["exit_code"] = ent["popen"].wait(timeout=60)
            except BaseException as e:
                extra["preempt_error"] = repr(e)
        extra["queued_at_preempt"] = queued_at_preempt
        for t in threads:
            t.join(timeout=300.0)
        chaos_ids = list(range(base, next_rid))
        # -- the burst subsided: the supervisor shrinks back to 1 --------
        down_deadline = time.monotonic() + 120.0
        while time.monotonic() < down_deadline:
            if (router.serving_replicas() == 1
                    and all(e.get("exit_code") is not None
                            for e in procs if e.get("popen"))):
                break
            time.sleep(0.05)
        sup.stop()
        for e in procs:
            if e.get("popen") is not None and e["popen"].poll() is None:
                e["popen"].kill()
                e["popen"].wait()
            e.pop("rr", None)
            e.pop("popen", None)
            e.pop("t_spawn", None)

    engine.waitall()

    token_exact = _token_exact(sd, model, params, records, prompt_of,
                               a.max_new)

    st = router.stats()
    remotes = []
    for e in procs:
        rres = _read_result(a.dir, e["label"]) or {}
        remotes.append({
            "label": e["label"],
            "exit_code": e.get("exit_code"),
            "first_served_s": e.get("first_served_s"),
            "preempted_code": rres.get("preempted_code"),
            "warmup_captures": rres.get("warmup_captures"),
            "captures_after_warmup": rres.get("captures_after_warmup"),
            "leaked_pages": rres.get("leaked_pages"),
            "pool_audit": rres.get("pool_audit"),
            "shed_draining": (rres.get("served") or {}).get(
                "shed_draining"),
        })
    telemetry.flush()
    res = {
        "label": a.label, "mode": a.mode, "pid": os.getpid(),
        "device": a.device,
        "preempted_code": None,
        "steady_ids": list(range(a.steady)),
        "chaos_ids": chaos_ids,
        "drain_ids": [],
        "records": {str(k): v for k, v in records.items()},
        "token_exact": token_exact,
        "steady_p99_s": None,
        "leaked_pages": local.pool_in_use(),
        "pool_audit": list(local.pool_audit()),
        "warmup_captures": warmed,
        "captures_after_warmup": sd.trace_count() - t_warm,
        "router": {k: v for k, v in st.items() if k != "replicas"},
        "replica_states": [r["state"] for r in st["replicas"]],
        "breakers": [r["breaker"] for r in st["replicas"]],
        "remotes": remotes,
        "telemetry": telemetry.snapshot(),
        **extra,
    }
    with open(os.path.join(a.dir, f"result-{a.label}.json"), "w") as f:
        json.dump(res, f, default=str)
    return 0


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def _drill_telemetry_dir(root: str) -> str:
    """Where this drill's children flush their flight-recorder shards: an
    outer ``MXNET_TELEMETRY_DIR`` wins, else a per-root directory the
    parent merges."""
    return os.environ.get("MXNET_TELEMETRY_DIR") \
        or os.path.join(root, "telemetry")


def _child_env(root: str) -> Dict[str, str]:
    env = dict(os.environ)
    env["MXNET_PREEMPTION_GRACE_S"] = "60"
    env["MXNET_ENGINE_PREFETCH"] = "2"
    env["MXNET_RETRY_BACKOFF"] = "0.01"
    env["MXNET_ELASTIC_BACKOFF"] = "0"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MXNET_FAULT_PLAN", "MXNET_ENGINE_TYPE", "MXNET_SPEC_DECODE"):
        env.pop(k, None)
    # children are fleet members: each flushes an atomic per-process
    # telemetry shard that the parent folds back with telemetry.merge()
    env["MXNET_TELEMETRY_DIR"] = _drill_telemetry_dir(root)
    return env


class _Done:
    """A finished child (or world): ``returncode`` (rank 0's), ``stderr``
    (every rank's tail) and ``codes`` (each rank's)."""

    def __init__(self, returncode, stderr, codes):
        self.returncode = returncode
        self.stderr = stderr
        self.codes = codes


def _run_child(argv: List[str], env: Dict[str, str],
               timeout: float = 300.0) -> _Done:
    try:
        p = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.drills"] + argv,
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=_REPO)
    except subprocess.TimeoutExpired as e:
        return _Done(None, f"timed out after {timeout} s: "
                           f"{(e.stderr or b'')[-1500:]!r}", [None])
    return _Done(p.returncode, p.stderr, [p.returncode])


def _run_world(argv: List[str], world: int, store: str,
               env: Dict[str, str],
               deadline: float = WORLD_DEADLINE_S) -> _Done:
    """Run ``argv`` as every rank of a world of ``world`` processes over a
    ``file://`` store. A rank that dies abnormally (a signal or an error)
    brings the rest down after a short grace, so that no rank waits in a
    collective until the backend's timeout; a world that outlives
    ``deadline`` is killed."""
    if os.path.exists(store):
        os.remove(store)
    env = dict(env, OMP_NUM_THREADS="1")
    logs = [os.path.join(os.path.dirname(store),
                         f"{os.path.basename(store)}-r{r}.log")
            for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.drills"] + argv
                + ["--world", str(world), "--rank", str(r),
                   "--store", store],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_REPO))
    end = time.monotonic() + deadline
    grace_end = None
    while time.monotonic() < end:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if grace_end is None and any(c is not None and c not in (0, 83)
                                     for c in codes):
            grace_end = time.monotonic() + 10.0
        if grace_end is not None and time.monotonic() > grace_end:
            break
        time.sleep(0.02)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    tails = []
    for r, path in enumerate(logs):
        with open(path) as f:
            tails.append(f"[rank {r}] " + f.read()[-1500:])
    codes = [p.returncode for p in procs]
    return _Done(codes[0], "\n".join(tails), codes)


def _train_child(root: str, scen_dir: str, label: str, world: int,
                 device: str, stop_at: int = N_STEPS,
                 sigterm_at: Optional[int] = None,
                 sigkill_at: Optional[int] = None, delay: float = 0.0,
                 preempt: bool = False, ckpt_name: str = "ckpt",
                 sentinel_every: int = 0,
                 bitflip_at: Optional[int] = None, bitflip_dev: int = 0,
                 poison_at: Optional[int] = None,
                 timeout: float = 300.0) -> _Done:
    os.makedirs(scen_dir, exist_ok=True)
    argv = ["train", "--dir", scen_dir,
            "--ckpt", os.path.join(scen_dir, ckpt_name),
            "--label", label, "--stop-at", str(stop_at),
            "--save-every", str(SAVE_EVERY), "--delay", str(delay),
            "--device", device]
    if sigterm_at is not None:
        argv += ["--sigterm-at", str(sigterm_at)]
    if sigkill_at is not None:
        argv += ["--sigkill-at", str(sigkill_at)]
    if preempt:
        argv += ["--preempt"]
    if sentinel_every:
        argv += ["--sentinel-every", str(sentinel_every)]
    if bitflip_at is not None:
        argv += ["--bitflip-at", str(bitflip_at),
                 "--bitflip-dev", str(bitflip_dev)]
    if poison_at is not None:
        argv += ["--poison-at", str(poison_at)]
    env = _child_env(root)
    if world > 1:
        return _run_world(argv, world,
                          os.path.join(scen_dir, f"store-{label}"), env,
                          deadline=timeout)
    return _run_child(argv, env, timeout=timeout)


def _read_losses(scen_dir: str, label: str) -> Dict[int, str]:
    path = os.path.join(scen_dir, f"losses-{label}.txt")
    out: Dict[int, str] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out[int(parts[0])] = parts[1]    # a later replay wins
    return out


def _read_result(scen_dir: str, label: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(scen_dir, f"result-{label}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _tmp_litter(ckpt_dir: str) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [f for f in os.listdir(ckpt_dir) if f.endswith(".tmp")]


def _ensure_reference(root: str, failures: List[str], world: int,
                      device: str) -> Dict[int, str]:
    """The memoized uninterrupted reference run of a world of ``world``
    on ``device``, shared by every train scenario under ``root``."""
    scen_dir = os.path.join(root, f"ref{world}-{device}")
    if _read_result(scen_dir, "ref") is None:
        r = _train_child(root, scen_dir, "ref", world, device)
        if r.returncode != 0:
            failures.append(
                f"reference run failed rc={r.returncode}: "
                f"{r.stderr[-1500:]}")
            return {}
    losses = _read_losses(scen_dir, "ref")
    if len(losses) != N_STEPS:
        failures.append(
            f"reference run produced {len(losses)}/{N_STEPS} loss lines")
    return losses


def _check_resumed_trajectory(failures: List[str], ref: Dict[int, str],
                              first: Dict[int, str],
                              resumed: Dict[int, str],
                              restored_at: int, what: str) -> int:
    """Merged first-run + resumed losses must equal the reference bit for
    bit, and the replayed overlap must equal the first run's: recovery
    neither loses, doubles, nor perturbs a step."""
    checked = 0
    for i in range(N_STEPS):
        want = ref.get(i)
        got = resumed.get(i) if i >= restored_at else first.get(i)
        if want is None or got is None:
            failures.append(f"{what}: step {i} missing a loss line")
            continue
        if want != got:
            failures.append(
                f"{what}: step {i} loss {got} != reference {want}")
        checked += 1
    for i, v in resumed.items():
        if i in first and first[i] != v:
            failures.append(
                f"{what}: replayed step {i} diverged from the first run "
                f"({v} != {first[i]})")
    return checked


def _drill_device(name: str, device: str) -> str:
    return "cpu" if name in CPU_WORLD_DRILLS else device


def run_drill(name: str, root: str, verbose: bool = False,
              device: str = "cuda") -> Dict[str, Any]:
    """Run one scenario under ``root`` (shared reference runs) and return
    its report: ``ok``, ``failures``, and the measured budget
    (``recovery_s`` / ``recovery_wall_s`` / ``steps_replayed`` /
    ``drain_s`` / ``warmup_captures`` / ``captures_after_warmup``, and for
    the router cells ``dropped`` / ``leaked_pages`` / ``steady_p99_s`` /
    ``chaos_p99_s`` / ...). ``device`` is where the children run
    (``topology_change`` and ``bitflip_param`` always run as gloo worlds
    on the CPU)."""
    if name not in SCENARIOS and name not in ROUTER_SCENARIOS:
        raise ValueError(f"unknown drill {name!r} (one of "
                         f"{SCENARIOS + ROUTER_SCENARIOS})")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_drill(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the drills on the CPU")
    os.makedirs(root, exist_ok=True)
    failures: List[str] = []
    dev = _drill_device(name, device)
    report: Dict[str, Any] = {"scenario": name, "root": root, "device": dev}
    t0 = time.monotonic()
    if name in ROUTER_SCENARIOS:
        _drill_router(root, failures, report, dev,
                      mode=(name[len("router_"):]
                            if name.startswith("router_") else name))
    elif name == "decode_drain":
        _drill_decode(root, failures, report, dev)
    else:
        world = {"topology_change": TOPO_WORLDS[0],
                 "bitflip_param": BITFLIP_WORLD}.get(name, 1)
        ref = _ensure_reference(root, failures, world, dev)
        if not failures:
            {"sigterm_drain": _drill_sigterm,
             "sigkill_between_saves": _drill_sigkill,
             "topology_change": _drill_topology,
             "corrupt_latest": _drill_corrupt,
             "bitflip_param": _drill_bitflip,
             "loss_spike": _drill_loss_spike}[name](root, ref, failures,
                                                    report, dev)
    report["ok"] = not failures
    report["failures"] = failures
    report["drill_wall_s"] = round(time.monotonic() - t0, 3)
    if verbose:
        print(json.dumps(report, indent=2, default=str))
    return report


def _resume_budget(report: Dict[str, Any], res: Dict[str, Any]) -> None:
    report.update({
        "recovery_s": res.get("recovery_s"),
        "recovery_wall_s": res.get("first_step_s"),
        "steps_replayed": res.get("steps_replayed"),
        "restored_at": res.get("restored_at"),
        "warmup_captures": res.get("warmup_captures"),
        "captures_after_warmup": res.get("captures_after_warmup"),
        "resume_telemetry": res.get("telemetry"),
    })


def _no_captures_after_warmup(failures, res, what) -> None:
    n = res.get("captures_after_warmup")
    if n != 0:
        failures.append(
            f"{what} captured {n} program(s) after its warm-up (wanted 0: "
            "a restore or a rollback replays the captured step)")


def _drill_sigterm(root: str, ref: Dict[int, str], failures: List[str],
                   report: Dict[str, Any], device: str) -> None:
    scen = os.path.join(root, "sigterm")
    kill_at = 9                       # mid-run, not on a save boundary
    c1 = _train_child(root, scen, "c1", 1, device, sigterm_at=kill_at,
                      preempt=True)
    res1 = _read_result(scen, "c1") or {}
    want_code = res1.get("preempted_code") or 83
    if c1.returncode != want_code:
        failures.append(
            f"sigterm child exited {c1.returncode}, wanted the "
            f"distinguished code {want_code}: {c1.stderr[-1500:]}")
    report["drain_s"] = res1.get("drain_s")
    report["exit_code_c1"] = c1.returncode
    if res1.get("drain_s") is None or res1.get("drain_s") <= 0:
        failures.append("sigterm drain recorded no preemption.drain_s")
    c2 = _train_child(root, scen, "c2", 1, device)
    if c2.returncode != 0:
        failures.append(f"sigterm resume failed rc={c2.returncode}: "
                        f"{c2.stderr[-1500:]}")
        return
    res2 = _read_result(scen, "c2") or {}
    _resume_budget(report, res2)
    first = _read_losses(scen, "c1")
    # the graceful drain checkpointed the LAST COMPLETED step: 0 replay
    restored = res2.get("restored_at") or 0
    replay = max(0, (max(first) + 1 if first else 0) - restored)
    report["steps_replayed"] = replay
    if res2.get("restored_at") != kill_at:
        failures.append(
            f"sigterm resume restored step {res2.get('restored_at')}, "
            f"wanted the drained step {kill_at}")
    if replay != 0:
        failures.append(
            f"graceful drain must replay 0 steps, resume replayed {replay}")
    _no_captures_after_warmup(failures, res2, "sigterm resume")
    _check_resumed_trajectory(
        failures, ref, first, _read_losses(scen, "c2"), restored, "sigterm")
    report["leaked_tmp"] = _tmp_litter(os.path.join(scen, "ckpt"))
    if report["leaked_tmp"]:
        failures.append(f"sigterm left temp litter {report['leaked_tmp']}")


def _drill_sigkill(root: str, ref: Dict[int, str], failures: List[str],
                   report: Dict[str, Any], device: str) -> None:
    scen = os.path.join(root, "sigkill")
    kill_at = 10                     # 2 past the last periodic save (8)
    c1 = _train_child(root, scen, "c1", 1, device, sigkill_at=kill_at)
    if c1.returncode != -signal.SIGKILL:
        failures.append(
            f"sigkill child exited {c1.returncode}, wanted "
            f"{-signal.SIGKILL}")
    report["exit_code_c1"] = c1.returncode
    c2 = _train_child(root, scen, "c2", 1, device)
    if c2.returncode != 0:
        failures.append(f"sigkill resume failed rc={c2.returncode}: "
                        f"{c2.stderr[-1500:]}")
        return
    res2 = _read_result(scen, "c2") or {}
    _resume_budget(report, res2)
    first = _read_losses(scen, "c1")
    restored = res2.get("restored_at") or 0
    replay = max(0, (max(first) + 1 if first else 0) - restored)
    report["steps_replayed"] = replay
    expect_restore = kill_at - (kill_at % SAVE_EVERY)
    if res2.get("restored_at") != expect_restore:
        failures.append(
            f"sigkill resume restored step {res2.get('restored_at')}, "
            f"wanted the last complete save {expect_restore}")
    if replay != kill_at - expect_restore:
        failures.append(
            f"sigkill resume replayed {replay} steps, wanted "
            f"{kill_at - expect_restore} (the save gap)")
    _no_captures_after_warmup(failures, res2, "sigkill resume")
    _check_resumed_trajectory(
        failures, ref, first, _read_losses(scen, "c2"), restored, "sigkill")
    report["leaked_tmp"] = _tmp_litter(os.path.join(scen, "ckpt"))
    if report["leaked_tmp"]:
        failures.append(f"sigkill left temp litter {report['leaked_tmp']}")


def _drill_topology(root: str, ref: Dict[int, str], failures: List[str],
                    report: Dict[str, Any], device: str) -> None:
    import shutil

    scen = os.path.join(root, "topology")
    big, small = TOPO_WORLDS
    c1 = _train_child(root, scen, "c1", big, device, stop_at=HALF)
    if c1.returncode != 0:
        failures.append(f"topology world-of-{big} leg failed "
                        f"rc={c1.returncode}: {c1.stderr[-1500:]}")
        return
    res1 = _read_result(scen, "c1") or {}
    losses = {}
    for label in ("c2", "c2b"):       # the pair: determinism
        # each resume gets its OWN copy of the world-of-4 checkpoints (a
        # shared directory would let c2's later saves turn c2b's restore
        # into a no-op)
        ckpt_name = f"ckpt-{label}"
        dst = os.path.join(scen, ckpt_name)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(os.path.join(scen, "ckpt"), dst)
        r = _train_child(root, scen, label, small, device,
                         ckpt_name=ckpt_name)
        if r.returncode != 0:
            failures.append(
                f"topology world-of-{small} resume {label} failed "
                f"rc={r.returncode}: {r.stderr[-1500:]}")
            return
        losses[label] = _read_losses(scen, label)
    res2 = _read_result(scen, "c2") or {}
    res2b = _read_result(scen, "c2b") or {}
    _resume_budget(report, res2b)
    if res2.get("restored_at") != HALF:
        failures.append(
            f"topology resume restored step {res2.get('restored_at')}, "
            f"wanted {HALF}")
    # bit-exact re-placement: the digest over the params RESTORED into the
    # world of 2 equals the world of 4's final params
    if res2.get("restored_params_sha") != res1.get("params_sha"):
        failures.append(
            f"topology restore(like=) into the world of {small} did not "
            f"reproduce the world of {big}'s params bit-exactly "
            f"({res2.get('restored_params_sha')} != "
            f"{res1.get('params_sha')})")
    if res2.get("params_sha") != res2b.get("params_sha"):
        failures.append("topology determinism pair diverged in final "
                        "params (recovery is not deterministic)")
    if losses["c2"] != losses["c2b"]:
        failures.append("topology determinism pair diverged in losses")
    for i in range(HALF, N_STEPS):
        w = ref.get(i)
        g = losses["c2"].get(i)
        if w is None or g is None:
            failures.append(f"topology: step {i} missing a loss line")
            continue
        wf, gf = float.fromhex(w), float.fromhex(g)
        if abs(wf - gf) > TOPO_RTOL * max(1.0, abs(wf)):
            failures.append(
                f"topology: step {i} loss {gf} drifted past rtol "
                f"{TOPO_RTOL} from the world-of-{big} reference {wf}")
    _no_captures_after_warmup(failures, res2b, "topology resume")
    report["params_sha_c1"] = res1.get("params_sha")


def _drill_corrupt(root: str, ref: Dict[int, str], failures: List[str],
                   report: Dict[str, Any], device: str) -> None:
    scen = os.path.join(root, "corrupt")
    c1 = _train_child(root, scen, "c1", 1, device, stop_at=HALF)
    if c1.returncode != 0:
        failures.append(f"corrupt setup leg failed rc={c1.returncode}: "
                        f"{c1.stderr[-1500:]}")
        return
    # flip one payload byte of the NEWEST checkpoint; its sha256 sidecar
    # now disagrees even though the pickle may still load
    ckpt_dir = os.path.join(scen, "ckpt")
    target = os.path.join(ckpt_dir, f"ckpt-{HALF}.pkl")
    with open(target, "r+b") as f:
        f.seek(-7, os.SEEK_END)
        b = f.read(1)
        f.seek(-7, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    c2 = _train_child(root, scen, "c2", 1, device)
    if c2.returncode != 0:
        failures.append(f"corrupt resume failed rc={c2.returncode}: "
                        f"{c2.stderr[-1500:]}")
        return
    res2 = _read_result(scen, "c2") or {}
    _resume_budget(report, res2)
    first = _read_losses(scen, "c1")
    restored = res2.get("restored_at") or 0
    report["steps_replayed"] = max(
        0, (max(first) + 1 if first else 0) - restored)
    expect = HALF - SAVE_EVERY
    if res2.get("restored_at") != expect:
        failures.append(
            f"corrupt resume restored step {res2.get('restored_at')}, "
            f"wanted degradation to the previous complete step {expect}")
    if not res2.get("digest_mismatches"):
        failures.append("corrupt resume counted no "
                        "checkpoint.digest_mismatches")
    _no_captures_after_warmup(failures, res2, "corrupt resume")
    _check_resumed_trajectory(
        failures, ref, first, _read_losses(scen, "c2"), restored, "corrupt")


def _merged_losses_vs_reference(failures: List[str], ref: Dict[int, str],
                                merged: Dict[int, str], what: str) -> None:
    """An in-process rollback drill writes BOTH the tainted and the
    replayed loss lines to one file; last-line-wins merging must equal the
    uninterrupted reference bit for bit (rollback healed the run)."""
    for i in range(N_STEPS):
        want, got = ref.get(i), merged.get(i)
        if want is None or got is None:
            failures.append(f"{what}: step {i} missing a loss line")
        elif want != got:
            failures.append(
                f"{what}: post-rollback step {i} loss {got} != reference "
                f"{want}")


def _drill_bitflip(root: str, ref: Dict[int, str], failures: List[str],
                   report: Dict[str, Any], device: str) -> None:
    """Silent corruption end to end: one flipped bit on one rank's replica
    -> the vote names the rank -> rollback -> bitwise resume -> a restart
    leaves the quarantined rank out of the mesh."""
    scen = os.path.join(root, "bitflip")
    flip_at, flip_dev = 13, 2          # mid save-window, rank 2
    c1 = _train_child(root, scen, "c1", BITFLIP_WORLD, device,
                      sentinel_every=SAVE_EVERY,
                      bitflip_at=flip_at, bitflip_dev=flip_dev)
    if c1.returncode != 0:
        failures.append(f"bitflip child failed rc={c1.returncode}: "
                        f"{c1.stderr[-1500:]}")
        return
    res1 = _read_result(scen, "c1") or {}
    victim_res = _read_result(scen, f"c1-r{flip_dev % BITFLIP_WORLD}") \
        or {}
    _resume_budget(report, res1)       # the in-process rollback budget
    report["steps_replayed"] = res1.get("steps_replayed")
    victim = victim_res.get("flipped")
    report["flipped_device"] = victim
    report["quarantine"] = res1.get("quarantine")
    if victim != flip_dev % BITFLIP_WORLD:
        failures.append(f"bitflip landed on rank {victim}, wanted "
                        f"{flip_dev % BITFLIP_WORLD}")
    if res1.get("restarts") != 1:
        failures.append(
            f"bitflip run took {res1.get('restarts')} restarts, wanted "
            "exactly 1 (the sentinel rollback)")
    if not res1.get("replica_divergence"):
        failures.append("bitflip vote counted no "
                        "sentinel.replica_divergence")
    if not res1.get("rollbacks"):
        failures.append("bitflip counted no sentinel.rollbacks")
    named = {e.get("rank") for e in res1.get("corruption_events") or []
             if e.get("name") == "sentinel"}
    if victim not in named:
        failures.append(
            f"bitflip corruption events named ranks {sorted(named)}, "
            f"not the corrupted rank {victim}")
    q = res1.get("quarantine") or []
    if victim not in [e["id"] for e in q if e["kind"] == "rank"]:
        failures.append(
            f"bitflip quarantine {q} does not hold rank {victim}")
    restored = res1.get("restored_at")
    detected = (restored or 0) + (res1.get("steps_replayed") or 0)
    if restored != flip_at - (flip_at % SAVE_EVERY):
        failures.append(
            f"bitflip restored step {restored}, wanted the last verified "
            f"save {flip_at - (flip_at % SAVE_EVERY)}")
    if not (0 < detected - flip_at <= SAVE_EVERY):
        failures.append(
            f"bitflip detected at step {detected}, flip at {flip_at}: "
            f"outside one sentinel cadence ({SAVE_EVERY})")
    _merged_losses_vs_reference(
        failures, ref, _read_losses(scen, "c1"), "bitflip")
    _no_captures_after_warmup(failures, res1, "bitflip rollback")
    # restart: the persisted quarantine leaves the suspect out of the mesh
    # (the quarantined rank takes its part in making the mesh and leaves);
    # a few extra steps on the smaller mesh
    c2 = _train_child(root, scen, "c2", BITFLIP_WORLD, device,
                      sentinel_every=SAVE_EVERY, stop_at=N_STEPS + 6)
    res2 = _read_result(scen, "c2") or {}
    if c2.codes != [0] * BITFLIP_WORLD:
        failures.append(f"bitflip quarantined restart failed "
                        f"codes={c2.codes}: {c2.stderr[-2500:]}")
        return
    mesh2 = res2.get("mesh_ranks")
    excluded = [r for r in range(BITFLIP_WORLD)
                if (_read_result(scen, f"c2-r{r}") or {}).get("excluded")]
    report["restart_mesh_devices"] = mesh2
    report["restart_excluded"] = excluded
    if mesh2 is None or len(mesh2) != BITFLIP_WORLD - 1 \
            or excluded != [victim]:
        failures.append(
            f"bitflip restart resolved a mesh of {mesh2} with ranks "
            f"{excluded} excluded; wanted {BITFLIP_WORLD - 1} ranks "
            f"without the quarantined rank {victim}")
    if res2.get("restored_at") != N_STEPS:
        failures.append(
            f"bitflip restart restored step {res2.get('restored_at')}, "
            f"wanted {N_STEPS} (resume onto the quarantined mesh)")
    if res2.get("steps_run") != N_STEPS + 6:
        failures.append(
            f"bitflip restart ran {res2.get('steps_run')} steps, wanted "
            f"{N_STEPS + 6}")


def _drill_loss_spike(root: str, ref: Dict[int, str],
                      failures: List[str], report: Dict[str, Any],
                      device: str) -> None:
    """A scripted poisoned batch: the z-score window trips at the next
    checkpoint boundary (the tainted state is never saved), rollback
    replays exactly the save-interval gap, the merged trajectory is
    bitwise the reference's."""
    scen = os.path.join(root, "spike")
    poison_at = 13
    c1 = _train_child(root, scen, "c1", 1, device,
                      sentinel_every=SAVE_EVERY, poison_at=poison_at)
    if c1.returncode != 0:
        failures.append(f"loss_spike child failed rc={c1.returncode}: "
                        f"{c1.stderr[-1500:]}")
        return
    res1 = _read_result(scen, "c1") or {}
    _resume_budget(report, res1)
    report["steps_replayed"] = res1.get("steps_replayed")
    report["last_rollback"] = res1.get("last_rollback")
    if res1.get("restarts") != 1:
        failures.append(
            f"loss_spike took {res1.get('restarts')} restarts, wanted "
            "exactly 1 (the windowed rollback)")
    if not res1.get("rollbacks"):
        failures.append("loss_spike counted no sentinel.rollbacks")
    if res1.get("replica_divergence"):
        failures.append(
            "loss_spike counted replica divergence: a poisoned batch "
            "perturbs every replica identically; the vote must stay "
            "unanimous")
    reason = (res1.get("last_rollback") or {}).get("reason")
    if reason not in ("grad_norm_anomaly", "loss_anomaly"):
        failures.append(
            f"loss_spike rollback reason {reason!r}, wanted the windowed "
            "z-score detector")
    expect_restore = poison_at - (poison_at % SAVE_EVERY)
    if res1.get("restored_at") != expect_restore:
        failures.append(
            f"loss_spike restored step {res1.get('restored_at')}, wanted "
            f"the last pre-poison save {expect_restore}")
    if res1.get("steps_replayed") != SAVE_EVERY:
        failures.append(
            f"loss_spike replayed {res1.get('steps_replayed')} steps, "
            f"wanted exactly the save-window gap {SAVE_EVERY}")
    _merged_losses_vs_reference(
        failures, ref, _read_losses(scen, "c1"), "loss_spike")
    _no_captures_after_warmup(failures, res1, "loss_spike rollback")


def _drill_decode(root: str, failures: List[str],
                  report: Dict[str, Any], device: str) -> None:
    scen = os.path.join(root, "decode")
    os.makedirs(scen, exist_ok=True)
    req_ids = list(range(8))
    argv = ["decode", "--dir", scen, "--label", "c1", "--preempt",
            "--self-sigterm", "--max-new", "12", "--device", device,
            "--requests", ",".join(map(str, req_ids))]
    c1 = _run_child(argv, _child_env(root))
    res1 = _read_result(scen, "c1") or {}
    code = res1.get("preempted_code") or 83
    report["exit_code_c1"] = c1.returncode
    if not res1:
        failures.append(f"decode child (exit {c1.returncode}) wrote no "
                        f"result: {c1.stderr[-1500:]}")
        return
    report["drain_s"] = res1.get("drain_s")
    report["warmup_captures"] = res1.get("warmup_captures")
    report["captures_after_warmup"] = res1.get("captures_after_warmup")
    if c1.returncode != code:
        failures.append(
            f"decode child exited {c1.returncode}, wanted the "
            f"distinguished code {code}: {c1.stderr[-1500:]}")
        return
    delivered = {int(k): v for k, v in (res1.get("delivered") or {}).items()}
    shed = {int(k): v for k, v in (res1.get("shed") or {}).items()}
    if set(delivered) | set(shed) != set(req_ids):
        failures.append(
            f"decode drain lost requests: delivered {sorted(delivered)} + "
            f"shed {sorted(shed)} != {req_ids}")
    if not delivered:
        failures.append("decode drain delivered nothing before the notice "
                        "(self-trigger broken)")
    if not shed:
        failures.append("decode drain shed nothing: the queue was empty at "
                        "the notice (drill not mid-stream)")
    bad_kinds = {r: k for r, k in shed.items() if k != "draining"}
    if bad_kinds:
        failures.append(f"decode sheds were not typed 'draining': "
                        f"{bad_kinds}")
    if not res1.get("token_exact"):
        failures.append("decode in-flight completions were not token-exact "
                        "against the eager oracle")
    if res1.get("pool_in_use") != 0 or res1.get("pool_audit"):
        failures.append(
            f"decode drain leaked {res1.get('pool_in_use')} KV pages "
            f"(audit {res1.get('pool_audit')})")
    _no_captures_after_warmup(failures, res1, "decode child")
    report["leaked_pages"] = res1.get("pool_in_use")
    # restart: the shed requests re-queue on a fresh process, token-exact
    if shed:
        argv = ["decode", "--dir", scen, "--label", "c2",
                "--max-new", "12", "--device", device,
                "--requests", ",".join(str(r) for r in sorted(shed))]
        c2 = _run_child(argv, _child_env(root))
        res2 = _read_result(scen, "c2") or {}
        if c2.returncode != 0:
            failures.append(f"decode re-queue leg failed "
                            f"rc={c2.returncode}: {c2.stderr[-1500:]}")
            return
        redone = {int(k) for k in (res2.get("delivered") or {})}
        if redone != set(shed):
            failures.append(
                f"decode re-queue delivered {sorted(redone)} != shed "
                f"{sorted(shed)}")
        if not res2.get("token_exact"):
            failures.append("decode re-queued requests were not "
                            "token-exact")
        if res2.get("pool_in_use") != 0:
            failures.append("decode re-queue leg leaked pages")


def _check_child_shard(root: str, failures: List[str],
                       report: Dict[str, Any], res: Dict[str, Any],
                       what: str, counters: Dict[str, Any]) -> None:
    """Fold the drill's telemetry shards (``telemetry.merge``) and hold the
    named counters of the child's OWN shard to the totals the child
    reported in its result: the cross-process aggregation path against
    ground truth the parent already holds."""
    from . import telemetry as _tel

    tel_dir = _drill_telemetry_dir(root)
    if not os.path.isdir(tel_dir):
        failures.append(f"{what}: no telemetry shard dir at {tel_dir}")
        return
    merged = _tel.merge(tel_dir)
    report["telemetry_shards"] = len(merged["shards"])
    pid = res.get("pid")
    proc = next((p for p in merged["processes"] if p["pid"] == pid), None)
    if proc is None:
        failures.append(
            f"{what}: no telemetry shard for child pid {pid} "
            f"(shards: {merged['shards']})")
        return
    shard = _tel._read_shard(os.path.join(tel_dir, proc["shard"]))
    snap = (shard["snapshot"] or {}).get("counters", {})
    for name, want in counters.items():
        got = snap.get(name)
        if want is not None and got != want:
            failures.append(
                f"{what}: merged shard counter {name}={got} != "
                f"child-observed {want}")
    for name, want in counters.items():
        fleet = merged["counters"].get(name)
        if want is not None and fleet is not None and fleet < want:
            failures.append(
                f"{what}: fleet-merged {name}={fleet} < child's {want}")


def _router_prefix(res: Dict[str, Any]) -> str:
    """The child's router counter prefix (``serving.router<k>``)."""
    for k in (res.get("telemetry") or {}):
        if k.startswith("serving.router") and k.endswith(".failovers"):
            return k[:-len(".failovers")]
    return "serving.router0"


def _drill_router(root: str, failures: List[str],
                  report: Dict[str, Any], device: str, mode: str) -> None:
    """One cell of the serving chaos matrix. The availability contract
    every cell shares: 0 dropped requests (every submission ends
    delivered or typed-shed), every delivery token-exact against the eager
    oracle, 0 leaked KV pages, a clean page-pool audit at drain, and 0
    captures after the warm-up."""
    scen = os.path.join(root, f"router-{mode}")
    os.makedirs(scen, exist_ok=True)
    argv = ["router", "--dir", scen, "--label", "c1", "--mode", mode,
            "--steady", "12", "--requests", "8", "--max-new", "10",
            "--device", device]
    if mode in ("kill", "prefix_storm"):
        argv += ["--preempt"]
    # the fleet cells spawn replica processes: a longer leash
    timeout = 600.0 if mode in ("scale_storm", "host_loss") else 300.0
    c1 = _run_child(argv, _child_env(root), timeout=timeout)
    res = _read_result(scen, "c1") or {}
    report["exit_code_c1"] = c1.returncode
    if not res:
        failures.append(f"router[{mode}] child (exit {c1.returncode}) "
                        f"wrote no result: {c1.stderr[-1500:]}")
        return
    want_code = ((res.get("preempted_code") or 83)
                 if mode in ("kill", "prefix_storm") else 0)
    if c1.returncode != want_code:
        failures.append(
            f"router[{mode}] child exited {c1.returncode}, wanted "
            f"{want_code}: {c1.stderr[-1500:]}")
        return
    records = {int(k): v for k, v in (res.get("records") or {}).items()}
    submitted = (len(res.get("steady_ids") or [])
                 + len(res.get("chaos_ids") or [])
                 + len(res.get("drain_ids") or []))
    errors = {r: v for r, v in records.items() if v["status"] == "error"}
    if errors:
        failures.append(
            f"router[{mode}] requests errored instead of "
            f"delivering/shedding: {errors}")
    known = sum(1 for v in records.values()
                if v["status"] in ("delivered", "shed"))
    if len(records) < submitted:
        failures.append(
            f"router[{mode}] dropped requests: {len(records)} outcomes for "
            f"{submitted} submissions")
    report["dropped"] = max(0, submitted - known)
    report["delivered"] = sum(1 for v in records.values()
                              if v["status"] == "delivered")
    if not res.get("token_exact"):
        failures.append(
            f"router[{mode}] delivered responses were not token-exact "
            "against the eager oracle (failover/hedge broke greedy "
            "idempotence)")
    if res.get("leaked_pages"):
        failures.append(
            f"router[{mode}] leaked {res['leaked_pages']} KV pages")
    report["leaked_pages"] = res.get("leaked_pages")
    if res.get("pool_audit"):
        failures.append(
            f"router[{mode}] page-pool refcount audit failed at drain: "
            f"{res['pool_audit']}")
    report["warmup_captures"] = res.get("warmup_captures")
    report["captures_after_warmup"] = res.get("captures_after_warmup")
    # the prefix storm's suffix prefills (``prefill_chunk``) are captured
    # at their first use: warm-up captures no chunk programs, as the
    # reference's warm-up compiles none
    if res.get("captures_after_warmup") and mode != "prefix_storm":
        failures.append(
            f"router[{mode}] captured {res['captures_after_warmup']} "
            "program(s) after warm-up (wanted 0)")
    rt = res.get("router") or {}
    prefix = _router_prefix(res)
    _check_child_shard(root, failures, report, res, what=f"router[{mode}]",
                       counters={
                           f"{prefix}.failovers": rt.get("failovers"),
                           f"{prefix}.sheds": rt.get("sheds"),
                           f"{prefix}.delivered": rt.get("delivered"),
                       })
    chaos = [records[r] for r in (res.get("chaos_ids") or [])
             if r in records]
    chaos_lat = sorted(v["elapsed_s"] for v in chaos
                       if v["status"] == "delivered")
    report["steady_p99_s"] = res.get("steady_p99_s")
    report["chaos_p99_s"] = (
        chaos_lat[min(len(chaos_lat) - 1, int(len(chaos_lat) * 0.99))]
        if chaos_lat else None)
    report["failovers"] = rt.get("failovers")
    report["hedges"] = rt.get("hedges")
    report["breaker_opens"] = rt.get("breaker_opens")
    report["breaker_closes"] = rt.get("breaker_closes")
    report["re_admit_s"] = res.get("re_admit_s")
    report["drain_s"] = res.get("drain_s")

    if mode in ("kill", "prefix_storm"):
        if not rt.get("failovers"):
            failures.append(f"router[{mode}] counted no failovers: the dead "
                            "replica's requests were not re-routed")
        if not rt.get("breaker_opens"):
            failures.append(f"router[{mode}] never opened the dead "
                            "replica's breaker")
        drain_recs = [records[r] for r in (res.get("drain_ids") or [])
                      if r in records]
        bad = [v for v in drain_recs
               if v["status"] == "shed" and v.get("kind") != "draining"]
        if bad:
            failures.append(
                f"router[{mode}] drain-phase sheds were not typed "
                f"'draining': {bad}")
        if res.get("drain_s") is None:
            failures.append(f"router[{mode}] preemption drain recorded no "
                            "preemption.drain_s: waitall did not drain the "
                            "router")
        if mode == "prefix_storm":
            if not res.get("prefix_hit_blocks"):
                failures.append(
                    "router[prefix_storm] counted 0 prefix.hit_blocks: the "
                    "shared system prompt never hit the content-addressed "
                    "cache (affinity or publish broken)")
            report["prefix_hit_blocks"] = res.get("prefix_hit_blocks")
            report["prefix_miss_blocks"] = res.get("prefix_miss_blocks")
            report["prefix_hit_rate"] = res.get("prefix_hit_rate")
            report["prefix_cow_forks"] = res.get("prefix_cow_forks")
    elif mode == "wedge":
        if not rt.get("wedged"):
            failures.append("router[wedge] never declared the wedged "
                            "dispatch (heartbeat eviction broken)")
        if not rt.get("failovers"):
            failures.append("router[wedge] counted no failovers")
    elif mode == "flap":
        if not rt.get("breaker_opens"):
            failures.append("router[flap] flap burst never opened the "
                            "breaker")
        if not rt.get("breaker_closes"):
            failures.append("router[flap] breaker never closed again "
                            "(half-open probe re-admission broken)")
        if res.get("re_admit_s") is None:
            failures.append("router[flap] re-admission never observed")
    elif mode == "scale_storm":
        fleet = rt.get("fleet") or {}
        remotes = res.get("remotes") or []
        report["fleet"] = fleet
        report["remotes"] = remotes
        report["join_to_first_served_s"] = max(
            (r["first_served_s"] for r in remotes
             if r.get("first_served_s") is not None), default=None)
        if fleet.get("scale_ups", 0) < 2:
            failures.append(
                f"router[scale_storm] autoscaler counted "
                f"{fleet.get('scale_ups')} scale_ups, wanted >=2 (the "
                "fleet never reached 3 replicas)")
        if fleet.get("scale_downs", 0) < 2:
            failures.append(
                f"router[scale_storm] autoscaler counted "
                f"{fleet.get('scale_downs')} scale_downs, wanted >=2 (the "
                "fleet never shrank back)")
        if fleet.get("drains", 0) < 2:
            failures.append(
                "router[scale_storm] scale-down skipped the graceful drain "
                f"({fleet.get('drains')} drains for "
                f"{fleet.get('scale_downs')} scale_downs)")
        states = res.get("replica_states") or []
        if sum(1 for s in states if s == "serving") != 1:
            failures.append(
                f"router[scale_storm] fleet did not settle back to 1 "
                f"SERVING replica: {states}")
        for r in remotes:
            if r.get("exit_code") != 83:
                failures.append(
                    f"router[scale_storm] remote {r.get('label')} exited "
                    f"{r.get('exit_code')}, wanted the distinguished "
                    "preemption code 83")
            if r.get("captures_after_warmup"):
                failures.append(
                    f"router[scale_storm] remote {r.get('label')} captured "
                    f"{r['captures_after_warmup']} program(s) after its "
                    "warm-up (wanted 0)")
            if r.get("leaked_pages"):
                failures.append(
                    f"router[scale_storm] remote {r.get('label')} leaked "
                    f"{r['leaked_pages']} KV pages")
            if r.get("pool_audit"):
                failures.append(
                    f"router[scale_storm] remote {r.get('label')} pool "
                    f"audit failed: {r['pool_audit']}")
            if r.get("first_served_s") is None:
                failures.append(
                    f"router[scale_storm] remote {r.get('label')} joined "
                    "but never served a request")
        if res.get("queued_at_preempt", 0) > 2:
            sheds = sum(int(r.get("shed_draining") or 0) for r in remotes)
            if not sheds:
                failures.append(
                    "router[scale_storm] preempt-under-load had "
                    f"{res['queued_at_preempt']} rows queued on the victim "
                    "but no typed draining shed came back over the wire "
                    "(the handback path never ran)")
    elif mode == "host_loss":
        report["kill_to_recovered_s"] = res.get("kill_to_recovered_s")
        if not rt.get("failovers"):
            failures.append(
                "router[host_loss] counted no failovers: the killed host's "
                "requests were not re-routed")
        if res.get("kill_to_recovered_s") is None:
            failures.append(
                "router[host_loss] never delivered a request after the "
                "SIGKILL (the fleet did not recover)")
        if not rt.get("breaker_opens"):
            failures.append(
                "router[host_loss] never opened the dead host's breaker")
    elif mode == "spec_draft_poison":
        # a poisoned draft costs ZERO availability: the engines turn
        # speculation off in their spec round and decode plainly in
        # place; the shared contract above (0 dropped, token-exact, clean
        # audit) already holds, so the cell's own checks are about the
        # disable machinery itself
        spec = res.get("spec") or []
        report["spec"] = spec
        report["spec_autodisabled"] = int(
            (res.get("telemetry") or {}).get("spec.autodisabled", 0))
        if not any(res.get("spec_rounds_before_poison") or []):
            failures.append(
                "router[spec_draft_poison] steady phase never engaged "
                "speculation (0 spec rounds before the poison: the cell "
                "exercised nothing)")
        if not all(s.get("spec_disabled") for s in spec):
            failures.append(
                "router[spec_draft_poison] a poisoned replica did not "
                f"turn speculation off: {spec}")
        if report["spec_autodisabled"] < 1:
            failures.append(
                "router[spec_draft_poison] no spec.autodisabled event was "
                "counted despite the poisoned draft")
    elif mode == "deadline_storm":
        for r, v in sorted(records.items()):
            b = v.get("budget_s")
            if b is None:
                continue
            if b < 0.01:                      # the infeasible budgets
                if v["status"] != "shed" or v.get("kind") != "deadline":
                    failures.append(
                        f"router[deadline_storm] request {r} with a "
                        f"{b * 1e6:.0f}us budget ended "
                        f"{v['status']}:{v.get('kind')} (wanted a typed "
                        "'deadline' shed)")
                if v["elapsed_s"] > b + 1.0:
                    failures.append(
                        f"router[deadline_storm] request {r} consumed "
                        f"{v['elapsed_s']:.3f}s against a {b:.3f}s budget "
                        "(+1s slack): the deadline did not bound the wait")
            elif v["status"] != "delivered":
                failures.append(
                    f"router[deadline_storm] feasible request {r} ended "
                    f"{v['status']}:{v.get('kind')}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="mxnet_tpu_torch.drills",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    t = sub.add_parser("train", help="train-drill child (one rank)")
    t.add_argument("--dir", required=True)
    t.add_argument("--ckpt", required=True)
    t.add_argument("--label", default="c1")
    t.add_argument("--stop-at", type=int, default=N_STEPS, dest="stop_at")
    t.add_argument("--save-every", type=int, default=SAVE_EVERY,
                   dest="save_every")
    t.add_argument("--max-restarts", type=int, default=3,
                   dest="max_restarts")
    t.add_argument("--delay", type=float, default=0.0)
    t.add_argument("--sigterm-at", type=int, default=None,
                   dest="sigterm_at")
    t.add_argument("--sigkill-at", type=int, default=None,
                   dest="sigkill_at")
    t.add_argument("--preempt", action="store_true")
    t.add_argument("--sentinel-every", type=int, default=0,
                   dest="sentinel_every")
    t.add_argument("--bitflip-at", type=int, default=None,
                   dest="bitflip_at")
    t.add_argument("--bitflip-dev", type=int, default=0,
                   dest="bitflip_dev")
    t.add_argument("--poison-at", type=int, default=None, dest="poison_at")
    t.add_argument("--world", type=int, default=1)
    t.add_argument("--rank", type=int, default=0)
    t.add_argument("--store", default=None)
    device_arg(t)

    d = sub.add_parser("decode", help="decode-drill child")
    d.add_argument("--dir", required=True)
    d.add_argument("--label", default="c1")
    d.add_argument("--requests", default="0,1,2,3")
    d.add_argument("--max-new", type=int, default=32, dest="max_new")
    d.add_argument("--preempt", action="store_true")
    d.add_argument("--self-sigterm", action="store_true",
                   dest="self_sigterm")
    device_arg(d)

    ro = sub.add_parser("router", help="router-chaos-drill child")
    ro.add_argument("--dir", required=True)
    ro.add_argument("--label", default="c1")
    ro.add_argument("--mode", default="kill",
                    choices=("kill", "wedge", "flap", "deadline_storm",
                             "prefix_storm", "scale_storm", "host_loss",
                             "spec_draft_poison"))
    ro.add_argument("--steady", type=int, default=12)
    ro.add_argument("--requests", type=int, default=8)
    ro.add_argument("--max-new", type=int, default=10, dest="max_new")
    ro.add_argument("--preempt", action="store_true")
    device_arg(ro)

    rp = sub.add_parser("replica", help="replica child of the fleet")
    rp.add_argument("--dir", required=True)
    rp.add_argument("--label", default="r1")
    rp.add_argument("--ttl", type=float, default=600.0)
    device_arg(rp)

    r = sub.add_parser("run", help="orchestrate scenarios")
    r.add_argument("scenarios", nargs="*", default=list(SCENARIOS))
    r.add_argument("--root", default=None)
    r.add_argument("--json", action="store_true")
    device_arg(r)

    a = p.parse_args(argv)
    if a.cmd == "train":
        return _cmd_train(a)
    if a.cmd == "decode":
        return _cmd_decode(a)
    if a.cmd == "router":
        return _cmd_router(a)
    if a.cmd == "replica":
        return _cmd_replica(a)
    import tempfile

    root = a.root or tempfile.mkdtemp(prefix="mxnet-drills-")
    reports = [run_drill(s, root, verbose=not a.json, device=a.device)
               for s in (a.scenarios or SCENARIOS)]
    if a.json:
        print(json.dumps(reports, default=str))
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
