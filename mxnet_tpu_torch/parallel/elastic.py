"""Fault tolerance: asynchronous checkpoints, failure detection, elastic
resume (counterpart of ``mxnet_tpu/parallel/elastic.py``, whole).

- :class:`CheckpointManager`: atomic, retained, optionally asynchronous
  checkpoints of a tree (dicts, lists, tuples of tensors, numpy arrays and
  Python values; the port's own files, ``ckpt-<step>.pkl``, one per rank
  as ``ckpt-<step>-h<rank>.pkl`` in a world of several ranks), written to
  a temp file and ``os.replace``d, with a sha256 sidecar
  (:class:`DigestMismatch`), a ``.meta`` file recording the saving
  world's size, ``keep`` retention, and removal of temp files left by
  dead writers. An asynchronous save takes a copy-on-write snapshot on
  the device: every CUDA leaf is cloned on the caller's current stream
  (ordered after the step that wrote it and before any later step or
  replay overwrites it) and an event is recorded; the writer thread waits
  for that event and copies the clones to the host on a stream of its
  own, then pickles and writes. The train loop pays one device copy.
  ``snapshot_stats`` counts the asynchronous and synchronous snapshots.
  A tensor placed as this rank's block on a mesh of several ranks
  (``_spmd_placement``) is saved as its block with its place in the
  global tensor; :meth:`CheckpointManager.restore` assembles the global
  tensors from every saving rank's file and, with ``like=``, takes each
  placed leaf's block on ``like``'s mesh, which may differ from the
  saving one.
- :class:`HeartbeatMonitor`: liveness over a beat table (a shared
  directory of mtime files, or in memory).
- :func:`run_elastic`: the step loop with periodic checkpoints, restore
  and resume on failure, anomaly rollback (``anomaly_fn``, with its
  ``every`` cadence and ``flush`` before each save), ``on_restore``,
  backoff, and ``preemption=True``.

One divergence by design, from in-place state: the port's compiled steps
update parameters in place, so a state tree holds live tensors, and a
preemption signal that lands inside a step cannot know whether that step
has already written them. Inside ``run_elastic(preemption=True)`` the
signal handler therefore only sets the draining flag
(``preemption.cooperative``); the loop notices it at the next step
boundary, drains (``engine.waitall()`` waits for the step in flight),
force-saves the last completed step blocking, and exits with
``preemption.Preempted``. Nothing is replayed on this path.
"""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
import queue
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as onp
import torch

from .. import config as _config
from .. import engine as _engine
from .. import faults as _faults
from .. import preemption as _preemption
from .. import telemetry as _telemetry
from .._pytree import tree_flatten, tree_unflatten

__all__ = ["CheckpointManager", "HeartbeatMonitor", "run_elastic",
           "AnomalyDetected", "DigestMismatch", "nonfinite_anomaly"]

_LOG = logging.getLogger("mxnet_tpu_torch.elastic")

_RECOVERY_S = _telemetry.counter(
    "elastic.recovery_s",
    "seconds the most recent run_elastic checkpoint restore took (the "
    "degradation walk, the load and the placement through restore(like=))",
    kind="time")
_STEPS_REPLAYED = _telemetry.counter(
    "elastic.steps_replayed",
    "train steps run again after restores (the failed step's index minus "
    "the restored step; a graceful preemption drain replays 0)")
_RESTORES = _telemetry.counter(
    "elastic.restores", "successful run_elastic checkpoint restores "
    "(startup resumes and in-process recoveries)")
_DIGEST_MISMATCHES = _telemetry.counter(
    "checkpoint.digest_mismatches",
    "checkpoint payloads whose sha256 disagreed with their sidecar; the "
    "step degrades whole to the previous complete one")


class AnomalyDetected(RuntimeError):
    """A step produced a state the anomaly detector rejected; run_elastic
    rolls back to the last checkpoint under the same ``max_restarts``
    budget."""


class DigestMismatch(ValueError):
    """A checkpoint payload's sha256 disagrees with its ``.sha256``
    sidecar. Automatic restore degrades to the previous complete step; an
    explicit ``step=`` raises this."""


_RESTORE_ERRORS = (pickle.UnpicklingError, EOFError, OSError, ValueError,
                   IndexError, KeyError, _faults.FaultInjected)


def _world() -> tuple:
    """(this process's rank, the world's size)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# -- placed blocks -----------------------------------------------------------

def _block_place(t: torch.Tensor):
    """(mesh, spec) of a tensor placed as this rank's block on a mesh of
    several ranks, else None."""
    placed = getattr(t, "_spmd_placement", None)
    if placed is None:
        return None
    from . import spmd as _spmd

    mesh = _spmd.mesh_of(placed[0])
    if mesh is None or mesh.size <= 1:
        return None
    return mesh, placed[1]


def _block_index(shape, spec, mesh) -> tuple:
    """(the global shape, this rank's block as (start, stop) per dim) of a
    block of ``shape`` under ``spec`` on ``mesh`` (``local_block``'s
    chunking: the dim's axes split it in order)."""
    from .collectives import _spec_dims

    gshape, index = [], []
    for d, axes in enumerate(_spec_dims(spec, len(shape))):
        n_all = 1
        for a in axes:
            n_all *= mesh.shape[a]
        full = shape[d] * n_all
        start, size = 0, full
        for a in axes:
            n = mesh.shape[a]
            if n > 1:
                size //= n
                start += mesh.coordinate(a) * size
        gshape.append(full)
        index.append((start, start + size))
    return tuple(gshape), tuple(index)


# -- snapshots ---------------------------------------------------------------

def _tree_cow(tree):
    """The copy-on-write device snapshot: every CUDA leaf cloned on the
    current stream (ordered before any later overwrite of the live
    tensor), numpy leaves copied; returns (leaves, structure, the event
    the clones end with or None)."""
    leaves, struct = tree_flatten(tree)
    out, event = [], None
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            c = leaf.detach().clone()
            place = _block_place(leaf)
            out.append((c, place))
            if c.device.type == "cuda":
                event = event or torch.cuda.Event()
        elif isinstance(leaf, onp.ndarray):
            out.append((leaf.copy(), None))
        else:
            out.append((leaf, None))
    if event is not None:
        event.record(torch.cuda.current_stream())
    return out, struct, event


def _to_host(leaves) -> list:
    """Host payloads of snapshot leaves: ``("full", None, value)`` or
    ``("block", (global shape, index), tensor)``."""
    out = []
    for value, place in leaves:
        if isinstance(value, torch.Tensor):
            host = value.detach().to("cpu", copy=True)
            if place is not None:
                mesh, spec = place
                out.append(("block", _block_index(tuple(value.shape), spec,
                                                  mesh), host))
            else:
                out.append(("full", None, host))
        elif isinstance(value, onp.ndarray):
            out.append(("full", None, onp.array(value, copy=True)))
        else:
            out.append(("full", None, value))
    return out


class CheckpointManager:
    """Atomic, retained, optionally asynchronous checkpoints (see the module
    docstring). Layout: ``<directory>/ckpt-<step>.pkl`` (with a
    ``-h<rank>`` suffix in a world of several ranks), its ``.sha256``, and
    ``ckpt-<step>.meta``."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._clean_stale_tmp()
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        self._stream = None
        # "async": device snapshot read to the host by the writer thread;
        # "sync": host copy on the caller's thread
        self.snapshot_stats = {"async": 0, "sync": 0}
        if async_save:
            self._worker = threading.Thread(target=self._writer, daemon=True,
                                            name="mxnet-checkpoint")
            self._worker.start()
        _engine.register_drainable(self)

    def _clean_stale_tmp(self) -> None:
        """Remove temp files left by dead writers (``<path>.<pid>.tmp``);
        a live pid's are left alone."""
        for f in os.listdir(self.directory):
            m = re.match(r".*\.(\d+)\.tmp$", f)
            if not m or int(m.group(1)) == os.getpid():
                continue
            try:
                os.kill(int(m.group(1)), 0)
            except ProcessLookupError:
                try:
                    os.remove(os.path.join(self.directory, f))
                    _LOG.warning("removed stale checkpoint temp file %s "
                                 "(writer pid %s is dead)", f, m.group(1))
                except OSError:
                    pass
            except OSError:
                pass                      # alive, or not ours: keep

    # -- paths ----------------------------------------------------------
    def _suffix(self) -> str:
        rank, world = _world()
        return f"-h{rank}" if world > 1 else ""

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}{self._suffix()}.pkl")

    def all_steps(self) -> List[int]:
        """Steps with a file from any rank (partial ones included)."""
        pat = re.compile(r"ckpt-(\d+)(?:-h\d+)?\.pkl$")
        steps = set()
        for f in os.listdir(self.directory):
            m = pat.match(f)
            if m:
                steps.add(int(m.group(1)))
        return sorted(steps)

    def _present_hosts(self, step: int) -> set:
        pat = re.compile(rf"ckpt-{step}(?:-h(\d+))?\.pkl$")
        hosts = set()
        for f in os.listdir(self.directory):
            m = pat.match(f)
            if m:
                hosts.add(int(m.group(1) or 0))
        return hosts

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.meta")

    def _saved_world(self, step: int) -> int:
        try:
            with open(self._meta_path(step)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return _world()[1]

    def complete_steps(self) -> List[int]:
        """Steps whose files exist for every rank of the world that saved
        them (the only safe restore points)."""
        return [s for s in self.all_steps()
                if len(self._present_hosts(s)) >= self._saved_world(s)]

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        """Snapshot the tree and write it, asynchronously by default: the
        caller's thread only enqueues the device clones (see the module
        docstring); ``block=True`` or ``NaiveEngine`` copies to the host
        on the caller's thread (and ``block=True`` writes there too)."""
        if self._closed:
            raise RuntimeError(
                "CheckpointManager is closed; save() would be silently "
                "dropped (no writer thread remains)")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"previous async checkpoint failed: {err}")
        snap, struct, event = _tree_cow(tree)
        if self.async_save and not block and not _engine.is_naive():
            self.snapshot_stats["async"] += 1
            self._q.put(("cow", step, (snap, struct, event)))
            return
        self.snapshot_stats["sync"] += 1
        payload = (struct, _to_host(snap))
        if self.async_save and not block:
            self._q.put(("host", step, payload))
        else:
            self._write(step, payload)

    def _host_copy(self, snap, event):
        """The writer's device-to-host copy of the clones, on its own
        stream after the clones' event."""
        if event is None:
            return _to_host(snap)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            out = _to_host(snap)
        return out

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            kind, step, data = item
            try:
                if kind == "cow":
                    _faults.inject("checkpoint.async")
                    snap, struct, event = data
                    data = (struct, self._host_copy(snap, event))
                    del snap
                self._write(step, data)
            except BaseException as e:  # surfaced at the next save()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step: int, payload) -> None:
        """One checkpoint under the shared retry policy (site
        ``checkpoint.write``)."""
        _faults.retry_call(self._write_once, step, payload,
                           site="checkpoint.write")

    def _write_once(self, step: int, payload) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        dtmp = f"{path}.sha256.{os.getpid()}.tmp"
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            # the digest sidecar is replaced BEFORE the payload: a crash
            # between the two pairs a new digest with the old payload, and
            # the restore degrades the step whole
            with open(dtmp, "w") as f:
                f.write(hashlib.sha256(data).hexdigest())
            os.replace(dtmp, f"{path}.sha256")
            os.replace(tmp, path)
        except BaseException:
            for t in (tmp, dtmp):
                try:
                    os.remove(t)
                except OSError:
                    pass
            raise
        meta_tmp = f"{self._meta_path(step)}.{os.getpid()}.tmp"
        with open(meta_tmp, "w") as f:
            f.write(str(_world()[1]))
        os.replace(meta_tmp, self._meta_path(step))
        self._gc()

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        # keep the last ``keep`` complete steps and anything newer
        protected = set(self.complete_steps()[-self.keep:])
        newest = max(protected) if protected else -1
        for s in self.all_steps():
            if s in protected or s > newest:
                continue
            for f in os.listdir(self.directory):
                if re.match(rf"ckpt-{s}(?:-h\d+)?\.pkl(?:\.sha256)?$", f) \
                        or f == f"ckpt-{s}.meta":
                    try:
                        os.remove(os.path.join(self.directory, f))
                    except OSError:
                        pass

    def wait(self) -> None:
        """Block until the queued saves are on disk."""
        if self.async_save:
            self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err}")

    def drain(self) -> None:
        """``engine.waitall()`` hook: flush the queued saves; a failure
        absorbed by the writer surfaces here."""
        if self._closed:
            return
        self.wait()

    # -- restore --------------------------------------------------------
    def _step_files(self, step: int) -> List[str]:
        """The files of ``step`` from ranks inside the world that saved
        it."""
        pat = re.compile(rf"ckpt-{step}(?:-h(\d+))?\.pkl$")
        world = self._saved_world(step)
        out = []
        for f in os.listdir(self.directory):
            m = pat.match(f)
            if m and int(m.group(1) or 0) < world:
                out.append(os.path.join(self.directory, f))
        return sorted(out)

    def restore(self, step: Optional[int] = None, like: Any = None):
        """Load a checkpoint (the latest complete one by default); returns
        ``(tree, step)``. With ``like`` (a tree of the same structure),
        each tensor leaf lands on its ``like`` leaf's device, and a leaf
        placed as a block on a mesh of several ranks becomes this rank's
        block of the same spec on ``like``'s mesh. Without ``step``, a
        corrupt newest step degrades whole to the previous complete one;
        an explicit ``step`` raises."""
        if step is not None:
            return self._restore_step(step, like), step
        candidates = self.complete_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Optional[BaseException] = None
        for s in reversed(candidates):
            try:
                return self._restore_step(s, like), s
            except _RESTORE_ERRORS as e:
                last_err = e
                _faults.record_event("checkpoint.restore", "degrade",
                                     error=e, step=s)
                _LOG.warning(
                    "checkpoint step %d unrestorable (%r); degrading to "
                    "the previous complete step", s, e)
        raise RuntimeError(
            f"no restorable checkpoint in {self.directory}: every "
            f"complete step {candidates} failed to load "
            f"(last error: {last_err!r})") from last_err

    def _load_verified(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        dpath = f"{path}.sha256"
        if os.path.exists(dpath):
            with open(dpath) as f:
                want = f.read().strip()
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                _DIGEST_MISMATCHES.inc()
                _faults.record_event(
                    "checkpoint.restore", "digest_mismatch",
                    file=os.path.basename(path))
                raise DigestMismatch(
                    f"checkpoint {path} content digest mismatch "
                    f"(sha256 {got[:12]}… != recorded {want[:12]}…)")
        return pickle.loads(data)

    def _restore_step(self, step: int, like: Any = None):
        _faults.inject("checkpoint.restore")
        paths = self._step_files(step)
        if not paths:
            raise FileNotFoundError(
                f"no files for step {step} in {self.directory}")
        own = self._path(step)
        primary = own if own in paths else paths[0]
        struct, host = self._load_verified(primary)
        if any(kind == "block" for kind, _i, _v in host):
            # every saving rank's blocks, assembled into the global tensors
            merged = [None if kind != "block" else [(i, v)]
                      for kind, i, v in host]
            for p in paths:
                if p == primary:
                    continue
                _s, other = self._load_verified(p)
                for m, theirs in zip(merged, other):
                    if m is not None and theirs[0] == "block":
                        m.append((theirs[1], theirs[2]))
            host = [(kind, None, _assemble(m)) if kind == "block"
                    else (kind, i, v)
                    for (kind, i, v), m in zip(host, merged)]
        like_leaves = (tree_flatten(like)[0] if like is not None
                       else [None] * len(host))
        if like is not None and len(like_leaves) != len(host):
            raise ValueError(
                f"checkpoint step {step} holds {len(host)} leaves but like= "
                f"carries {len(like_leaves)}: the live state tree's "
                "structure differs from the saved one")
        leaves = [_place_like(v, ref) for (_k, _i, v), ref
                  in zip(host, like_leaves)]
        return tree_unflatten(struct, leaves)

    def close(self):
        self._closed = True
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=30)
            self._worker = None


def _assemble(blocks) -> torch.Tensor:
    """The global tensor from (``(global shape, index)``, block) pairs."""
    (gshape, _idx), first = blocks[0]
    out = torch.zeros(gshape, dtype=first.dtype)
    for (_g, index), block in blocks:
        out[tuple(slice(a, b) for a, b in index)] = block
    return out


def _place_like(value, ref):
    """A restored leaf where ``ref`` (a live leaf) says: on its device, as
    this rank's block of its placement when it has one."""
    if not isinstance(value, torch.Tensor) or not isinstance(ref,
                                                             torch.Tensor):
        return value
    place = _block_place(ref)
    if place is not None:
        from .collectives import local_block

        mesh, spec = place
        out = local_block(value, spec, mesh).to(ref.device).clone()
        out._spmd_placement = ref._spmd_placement
        return out
    return value.to(ref.device)


class HeartbeatMonitor:
    """Liveness over a beat table: each member stamps a beat, and a member
    whose newest beat is older than ``timeout`` is dead. With
    ``directory`` the beats are mtime files (``<dir>/rank-<r>.hb``,
    touched every ``interval`` by :meth:`start`'s thread); without it an
    in-memory ``{key: monotonic}`` table stamped per event."""

    def __init__(self, directory: Optional[str] = None, rank=0,
                 interval: float = 2.0, timeout: float = 10.0):
        self.directory = directory
        self.rank = rank
        self.interval = interval
        self.timeout = timeout
        self._beats: Dict[Any, float] = {}
        self._beats_lock = threading.Lock()
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _path(self, rank) -> str:
        return os.path.join(self.directory, f"rank-{rank}.hb")

    def beat(self, rank=None) -> None:
        rank = self.rank if rank is None else rank
        if self.directory is None:
            with self._beats_lock:
                self._beats[rank] = time.monotonic()
            return
        path = self._path(rank)
        with open(path, "a"):
            os.utime(path, None)

    def start(self) -> "HeartbeatMonitor":
        self.beat()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxnet-heartbeat")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def ranks(self) -> List:
        if self.directory is None:
            with self._beats_lock:
                return sorted(self._beats, key=str)
        out = []
        for f in os.listdir(self.directory):
            m = re.match(r"rank-(\d+)\.hb$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def age(self, rank=None, now: Optional[float] = None) -> Optional[float]:
        """Seconds since ``rank``'s newest beat (None: it never beat)."""
        rank = self.rank if rank is None else rank
        if self.directory is None:
            with self._beats_lock:
                t = self._beats.get(rank)
            if t is None:
                return None
            return (time.monotonic() if now is None else now) - t
        try:
            t = os.path.getmtime(self._path(rank))
        except OSError:
            return None
        return (time.time() if now is None else now) - t

    def dead_ranks(self, now: Optional[float] = None) -> List:
        dead = []
        for r in self.ranks():
            a = self.age(r, now=now)
            if a is None or a > self.timeout:
                dead.append(r)
        return dead


def nonfinite_anomaly(*keys: str, every: int = 1) -> Callable[[Any], bool]:
    """Anomaly detector for :func:`run_elastic`: flags a state whose
    ``state[key]`` holds a non-finite value. Each evaluation reads the
    leaves on the host, so ``every`` (the cadence run_elastic honours)
    above 1 keeps the other steps free of host reads."""
    def _check(state) -> bool:
        for k in keys:
            v = state[k]
            if isinstance(v, torch.Tensor):
                if not bool(torch.isfinite(v.detach()).all()):
                    return True
            elif not bool(onp.all(onp.isfinite(onp.asarray(v)))):
                return True
        return False
    _check.every = int(every)
    return _check


def _restore_counted(ckpt: CheckpointManager, state: Any):
    """One restore, retried under the shared policy (site
    ``elastic.restore``), timed into ``elastic.recovery_s`` and counted in
    ``elastic.restores``."""
    t0 = time.monotonic()
    restored, step = _faults.retry_call(ckpt.restore, like=state,
                                        site="elastic.restore")
    _RECOVERY_S.set(time.monotonic() - t0)
    _RESTORES.inc()
    return restored, step


def run_elastic(step_fn: Callable, state: Any, inputs: Iterable,
                ckpt: CheckpointManager, save_every: int = 10,
                max_restarts: int = 3, on_restart: Optional[Callable] = None,
                restart_backoff: Optional[float] = None,
                anomaly_fn: Optional[Callable[[Any], bool]] = None,
                on_restore: Optional[Callable[[Any, int], Any]] = None,
                preemption: bool = False,
                kvstore: Any = None):
    """Run ``state = step_fn(state, batch)`` over ``inputs`` with a
    checkpoint every ``save_every`` steps; on an exception restore the
    latest checkpoint, skip the consumed steps and continue (up to
    ``max_restarts``). ``inputs`` with ``len`` and indexing is used in
    place; an iterator is listed once. Returns ``(state, steps_run,
    restarts)``.

    - ``restart_backoff`` (default ``MXNET_ELASTIC_BACKOFF``): delay
      ``min(backoff * 2**(restart-1), MXNET_RETRY_BACKOFF_MAX)`` before
      each restore.
    - ``anomaly_fn(state) -> bool`` (``nonfinite_anomaly``, a
      ``sentinel.Sentinel``): True after a step raises
      :class:`AnomalyDetected` and rolls back under the same budget; its
      ``every`` attribute sets the cadence, its ``flush()`` runs before
      every save and its verdict raises the same way.
    - ``on_restore(state, step)`` runs after every restore (the startup
      resume too): push the restored tree into the live objects (a
      non-None return replaces the loop's state).
    - ``preemption=True`` installs the SIGTERM/SIGINT handler; while this
      loop runs the handler only flags the drain (see the module
      docstring), and a drain hook force-saves the last completed step;
      the loop drains at the next boundary and raises
      ``preemption.Preempted``.
    - ``kvstore``: with ``MXNET_BARRIER_TIMEOUT`` > 0 and a store that
      takes ``attach_heartbeat``, a :class:`HeartbeatMonitor` under
      ``<ckpt.directory>/heartbeats`` is started and attached.
    - each iteration passes the ``elastic.step`` injection site and each
      restore ``elastic.restore``; restores are timed into
      ``elastic.recovery_s`` and counted, replays into
      ``elastic.steps_replayed``, restarts emit ``restart`` events.
    """
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    if restart_backoff is None:
        restart_backoff = _config.get("MXNET_ELASTIC_BACKOFF")
    if not (hasattr(inputs, "__len__") and hasattr(inputs, "__getitem__")):
        inputs = list(inputs)
    n = len(inputs)
    hb: Optional[HeartbeatMonitor] = None
    if kvstore is not None and hasattr(kvstore, "attach_heartbeat") \
            and getattr(kvstore, "_heartbeat", None) is None \
            and _config.get("MXNET_BARRIER_TIMEOUT") > 0:
        hb = HeartbeatMonitor(os.path.join(ckpt.directory, "heartbeats"),
                              rank=_world()[0]).start()
        kvstore.attach_heartbeat(hb)
    if preemption:
        _preemption.install()
    # the loop's cell the drain hook reads: (the last completed step, its
    # state)
    loop = {"state": state, "i": 0}
    anomaly_every = max(1, int(getattr(anomaly_fn, "every", 1) or 1))
    anomaly_flush = getattr(anomaly_fn, "flush", None)
    hook = None
    coop = None
    if preemption or _preemption.installed():
        def _final_save():
            ckpt.save(loop["i"], loop["state"], block=True)
        hook = _preemption.on_drain(_final_save)
        coop = _preemption.cooperative()
        coop.__enter__()
    try:
        start = 0
        if ckpt.latest_step() is not None:
            state, start = _restore_counted(ckpt, state)
            _telemetry.event("restart", "elastic", step=start,
                             phase="startup_restore")
            if on_restore is not None:
                ns = on_restore(state, start)
                if ns is not None:
                    state = ns
        else:
            # the step-0 anchor: a crash before the first periodic save
            # restores the pristine state
            ckpt.save(0, state, block=True)
        restarts = 0
        i = start
        loop["state"], loop["i"] = state, i
        while i < n:
            if _preemption.draining():
                break
            try:
                _faults.inject("elastic.step")
                new_state = step_fn(state, inputs[i])
                if anomaly_fn is not None \
                        and (i + 1) % anomaly_every == 0 \
                        and anomaly_fn(new_state):
                    raise AnomalyDetected(
                        f"anomaly detected in the state after step {i}")
                state = new_state
                i += 1
                loop["state"], loop["i"] = state, i
                if i % save_every == 0 or i == n:
                    if anomaly_flush is not None and anomaly_flush():
                        raise AnomalyDetected(
                            f"sentinel verdict before the save at step "
                            f"{i}; the tainted state was NOT "
                            "checkpointed")
                    ckpt.save(i, state)
            except Exception as e:
                restarts += 1
                _faults.record_event("elastic.restart", "restart", error=e,
                                     step=i, restart=restarts)
                if restarts > max_restarts:
                    ckpt.wait()
                    raise
                _LOG.warning("elastic restart %d/%d at step %d: %r",
                             restarts, max_restarts, i, e)
                if on_restart is not None:
                    on_restart(restarts)
                ckpt.wait()
                if restart_backoff > 0:
                    _faults._sleep(min(
                        restart_backoff * (2 ** (restarts - 1)),
                        _config.get("MXNET_RETRY_BACKOFF_MAX")))
                prev_i = i
                state, i = _restore_counted(ckpt, state)
                _STEPS_REPLAYED.inc(max(0, prev_i - i))
                _telemetry.event("restart", "elastic", step=i,
                                 restart=restarts,
                                 replay=max(0, prev_i - i))
                if on_restore is not None:
                    ns = on_restore(state, i)
                    if ns is not None:
                        state = ns
                loop["state"], loop["i"] = state, i
        if _preemption.draining() and i < n:
            # the drain at a step boundary: the queues drain (the step in
            # flight ends), the hook force-saves step i blocking, and the
            # loop exits with the distinguished code
            if hook is not None:
                _preemption.finish_cooperative_drain()
            else:
                _engine.waitall()
                ckpt.save(i, state, block=True)
                ckpt.wait()
                _telemetry.event("drain", "elastic", step=i)
                raise _preemption.Preempted(_preemption.exit_code())
        ckpt.wait()
        return state, i, restarts
    finally:
        if coop is not None:
            coop.__exit__(None, None, None)
        if hook is not None:
            _preemption.remove_drain_hook(hook)
        if hb is not None:
            hb.stop()
