"""Training-integrity sentinel: in-program state digests, a cross-rank
vote, anomaly windows with rollback, and the suspect quarantine.

Counterpart of ``mxnet_tpu/sentinel.py``, whole:

1. **The digest.** :func:`fold_leaves` is a position-weighted fold of
   every element's bits, in exact integer arithmetic mod 2^32, so it is
   bit-deterministic, independent of reduction order, and moves on any
   single-bit change. Each leaf's bits come from ``view(torch.int32)`` of
   its fp32 values (bf16 and fp16 widened to fp32 first, which is exact,
   as the reference does at :147-152; fp64 narrowed to fp32, as the
   reference's ``jnp.asarray`` narrows it), of its integers, or of its
   booleans as 0 / 1; the products and sums are taken in int64 and
   reduced mod 2^32 (a product of two 32-bit words is split into 16-bit
   halves so that no int64 product overflows). The value is the
   reference's uint32, bit for bit, on the same numpy leaves
   (:func:`tree_digest`). The fold is plain torch: the reference computes
   it in plain ``jnp`` too, outside any kernel.
2. **In the step.** ``cached_step.TrainStep.attach_sentinel`` gives the
   step a digest form of its program, captured beside the plain form: on
   every ``every``-th dispatch the step runs the digest form, which does
   the same update and also emits :func:`program_digest` (the fold over
   the post-update parameters and optimizer state, the fp32 parameter
   sum, the fp32 gradient norm): still one dispatch, no capture after the
   warm-up, no host read. The step hands the digest to :meth:`Sentinel.
   offer` unread; ``offer`` copies it into pinned host memory behind an
   event and consumes the PREVIOUS pending digest, whose copy finished a
   cadence ago, so the read is lagged (``sentinel.late_reads`` counts a
   read that had to wait for its copy).
3. **The vote.** Where the step's parameters are replicated on every
   rank of a ``torch.distributed`` world, every rank's digest must be
   equal; a read gathers them (``all_gather_object``) and a minority rank
   is named in a ``corruption`` event and counted in
   ``sentinel.replica_divergence``. Where they are split (fsdp, ep, pp),
   each rank folds its own blocks and the vote is off (:attr:`Sentinel.
   vote`).
4. **Windows and rollback.** :class:`Window` is an EMA + z-score detector
   (``MXNET_SENTINEL_ZMAX``) over the gradient norm and any loss the loop
   feeds (:meth:`Sentinel.observe_loss`). A tripped window or a divergent
   vote makes the sentinel, used as ``run_elastic(anomaly_fn=...)``,
   return True (fault site ``sentinel.rollback``); ``run_elastic`` calls
   :meth:`Sentinel.flush` before every save, so a tainted state is never
   checkpointed.
5. **Quarantine.** A divergent rank (after ``MXNET_SENTINEL_STRIKES``
   strikes) or a rank a heartbeat monitor suspects lands in the persisted
   :class:`Quarantine` (``<dir>/quarantine.json``, atomic replace, site
   ``sentinel.quarantine``), which ``parallel.mesh`` consults when it
   maps ranks to devices.

:func:`tree_digest` gathers a block placed on a mesh of several ranks
whole before folding it (a collective every rank calls), so a digest
cannot tell a sharded state from a replicated one.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as onp
import torch

from . import config as _config
from . import engine as _engine
from . import faults as _faults
from . import telemetry as _telemetry
from ._pytree import tree_leaves

__all__ = ["fold_leaves", "tree_digest", "program_digest", "Window",
           "Quarantine", "Sentinel", "install_quarantine",
           "active_quarantine", "quarantine_ranks"]

_LOG = logging.getLogger("mxnet_tpu_torch.sentinel")

_DIGESTS = _telemetry.counter(
    "sentinel.digests",
    "in-program state digests read on the host (the lagged read consumes "
    "the PREVIOUS sentinel dispatch's digest, or the pending one at a "
    "checkpoint boundary)")
_LATE = _telemetry.counter(
    "sentinel.late_reads",
    "digest reads whose device-to-host copy had not finished when read "
    "(the read waited for it)")
_DIVERGENCE = _telemetry.counter(
    "sentinel.replica_divergence",
    "sentinel reads whose per-rank digests disagreed: replicated "
    "parameters no longer bit-identical across the world")
_ROLLBACKS = _telemetry.counter(
    "sentinel.rollbacks",
    "sentinel verdicts that triggered the run_elastic rollback path "
    "(divergent vote or windowed anomaly), fault site sentinel.rollback")


def _quarantined_entries() -> int:
    q = active_quarantine()
    return len(q.entries()) if q is not None else 0


_telemetry.gauge_fn(
    "sentinel.quarantined", _quarantined_entries,
    "entries (suspect devices and ranks) in the active quarantine list")


# ---------------------------------------------------------------------------
# digest arithmetic (runs inside the step's digest form)
# ---------------------------------------------------------------------------
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_ELEM_WEIGHT = 2654435761
_MASK = 0xFFFFFFFF


def _mulmod(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` and ``b`` in [0, 2^32): the low
    half of ``a`` times ``b`` and the high half's low 16 bits of product,
    each below 2^48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK


def _as_tensor(x) -> torch.Tensor:
    """A leaf as the tensor the reference's ``jnp.asarray`` would fold:
    numpy and Python values with 64-bit types narrowed to 32 bits."""
    from .ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = onp.asarray(x)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    elif arr.dtype.kind in "iu" and arr.dtype.itemsize == 8:
        arr = arr.astype(onp.int64)
    elif arr.dtype.kind == "u":
        arr = arr.astype(onp.int64)
    return torch.from_numpy(onp.ascontiguousarray(arr))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Every element's 32-bit word as int64 in [0, 2^32), flattened."""
    if x.is_floating_point():
        if x.dtype != torch.float32:
            x = x.float()
        return x.contiguous().view(torch.int32).reshape(-1).long() & _MASK
    return x.reshape(-1).long() & _MASK


def _fold_leaf(x) -> torch.Tensor:
    """Position-weighted fold of one array mod 2^32, as an int64 0-dim
    tensor on its device."""
    bits = _bits(_as_tensor(x))
    n = bits.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=bits.device)
    idx = torch.arange(n, dtype=torch.int64, device=bits.device)
    wgt = (_mulmod(idx, _ELEM_WEIGHT) + 97) & _MASK
    return _mulmod(bits, wgt).sum() & _MASK


# elements a pass of :func:`_leaf_folds` folds at once: its int64
# temporaries (about 40 bytes an element) stay under about 160 MB, so a
# captured digest form's memory does not grow with the model
_FOLD_CHUNK = 1 << 22


def _leaf_folds(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every leaf's :func:`_fold_leaf`, computed a few passes for all of
    them: the leaves of one dtype are taken as one stream of elements, in
    chunks of at most :data:`_FOLD_CHUNK`, each element weighted by its
    index within its leaf, and each leaf's part of a chunk summed as the
    difference of a running sum at its ends (exact in int64: each term is
    below 2^32, so a sum of fewer than 2^31 of them cannot overflow); a
    leaf that spans chunks adds its parts mod 2^32. The per-leaf kernels
    of :func:`_fold_leaf` would be about 25 a leaf."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    groups: Dict[Any, List[int]] = {}
    for i, x in enumerate(leaves):
        if x.numel() == 0:
            out[i] = torch.zeros((), dtype=torch.int64, device=x.device)
        else:
            key = (x.device, x.dtype)
            groups.setdefault(key, []).append(i)
    for (device, _dtype), idx in groups.items():
        for chunk in _chunks(leaves, idx):
            flat = torch.cat([leaves[i].reshape(-1)[a:b]
                              for i, a, b in chunk])
            bits = _bits(flat)
            local = torch.cat([torch.arange(a, b, dtype=torch.int64,
                                            device=device)
                               for _i, a, b in chunk])
            wgt = (_mulmod(local, _ELEM_WEIGHT) + 97) & _MASK
            run = torch.cumsum(_mulmod(bits, wgt), 0)
            ends = torch.stack([run[int(e) - 1] for e in
                                onp.cumsum([b - a for _i, a, b in chunk])])
            sums = (ends - torch.cat([ends.new_zeros(1), ends[:-1]])) & _MASK
            for j, (i, _a, _b) in enumerate(chunk):
                out[i] = sums[j] if out[i] is None \
                    else (out[i] + sums[j]) & _MASK
    return out


def _chunks(leaves, idx):
    """The leaves ``idx`` as one stream cut into chunks of at most
    :data:`_FOLD_CHUNK` elements: lists of (leaf, start, stop)."""
    chunk, room = [], _FOLD_CHUNK
    for i in idx:
        a, n = 0, leaves[i].numel()
        while a < n:
            b = min(n, a + room)
            chunk.append((i, a, b))
            room -= b - a
            a = b
            if room == 0:
                yield chunk
                chunk, room = [], _FOLD_CHUNK
    if chunk:
        yield chunk


def _times_prime(a: torch.Tensor) -> torch.Tensor:
    """``a * _FNV_PRIME mod 2^32`` as ``(a << 24) + 403 a`` (the prime is
    2^24 + 403), both terms below 2^56."""
    return ((a << 24) + a * 403) & _MASK


def fold_leaves(leaves: Sequence[Any]) -> torch.Tensor:
    """One digest of ``leaves``: FNV-style multiply-xor across leaves
    (order-dependent, so two swapped leaves change it), each leaf's
    weighted fold within. An int64 0-dim tensor holding the uint32."""
    leaves = [_as_tensor(x) for x in leaves]
    device = leaves[0].device if leaves else torch.device("cpu")
    acc = torch.full((), _FNV_OFFSET, dtype=torch.int64, device=device)
    for f in _leaf_folds(leaves):
        acc = _times_prime(acc) ^ f.to(device)
    return acc


def _whole(x):
    """A block placed on a mesh of several ranks gathered whole (every
    rank calls); any other leaf as it is."""
    placed = getattr(x, "_spmd_placement", None)
    if placed is None or not isinstance(x, torch.Tensor):
        return x
    from .parallel import collectives as _coll
    from .parallel import spmd as _spmd

    mesh = _spmd.mesh_of(placed[0])
    if mesh is None or mesh.size <= 1:
        return x
    return _coll.global_from_blocks(x.detach(), placed[1], mesh)


def tree_digest(tree: Any) -> int:
    """The fingerprint of a tree (dicts, lists, tuples; ``None`` skipped)
    computed on the host's call: the same fold the step's digest form
    emits, so an in-program digest can be checked against a recompute,
    and two processes holding bit-identical state get the same integer.
    Equal to the reference's ``tree_digest`` on the same numpy leaves."""
    leaves = [_whole(x) for x in tree_leaves(tree) if x is not None]
    return int(fold_leaves(leaves))


def program_digest(new_w, state_leaves, grads):
    """The digest form's outputs: (the fold over the post-update
    parameters and optimizer state, their fp32 sum, the fp32 global
    gradient norm), as device scalars."""
    leaves = list(new_w) + [x for x in state_leaves if x is not None]
    fold = fold_leaves(leaves)
    dev = fold.device
    psum = torch.zeros((), dtype=torch.float32, device=dev)
    for w in new_w:
        psum = psum + w.float().sum()
    g2 = torch.zeros((), dtype=torch.float32, device=dev)
    for g in grads:
        g2 = g2 + g.float().square().sum()
    return fold, psum, torch.sqrt(g2)


# ---------------------------------------------------------------------------
# windowed anomaly detection
# ---------------------------------------------------------------------------

class Window:
    """EMA + z-score anomaly window over one scalar series.

    ``update(v)`` returns True when ``v`` is non-finite or, once
    ``min_count`` clean values seeded the window, when ``|v - ema| > zmax
    * std``. Anomalous values are not absorbed into the window."""

    def __init__(self, zmax: Optional[float] = None, decay: float = 0.2,
                 min_count: int = 3):
        self.zmax = float(_config.get("MXNET_SENTINEL_ZMAX")
                          if zmax is None else zmax)
        self.decay = float(decay)
        self.min_count = int(min_count)
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, v: float) -> bool:
        v = float(v)
        if not math.isfinite(v):
            return True
        if self.count >= self.min_count:
            std = math.sqrt(self.var) + 1e-12 + 1e-9 * abs(self.mean)
            if abs(v - self.mean) > self.zmax * std:
                return True
        if self.count == 0:
            self.mean = v
        a = self.decay
        d = v - self.mean
        self.mean += a * d
        self.var = (1.0 - a) * (self.var + a * d * d)
        self.count += 1
        return False


# ---------------------------------------------------------------------------
# quarantine (the persisted suspect list)
# ---------------------------------------------------------------------------

class Quarantine:
    """Persisted list of suspect devices and ranks: entries ``{"kind":
    "device" | "rank", "id": int, "reason": str}`` in a JSON file
    (atomic replace, fault site ``sentinel.quarantine``)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._entries: List[Dict[str, Any]] = []
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                self._entries = [e for e in data
                                 if isinstance(e, dict) and "kind" in e]
            except (OSError, ValueError) as e:
                _LOG.warning("unreadable quarantine list %s (%r); "
                             "starting empty", path, e)

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def device_ids(self) -> List[int]:
        return sorted({e["id"] for e in self.entries()
                       if e["kind"] == "device"})

    def ranks(self) -> List[int]:
        return sorted({e["id"] for e in self.entries()
                       if e["kind"] == "rank"})

    def _add(self, kind: str, ident: int, reason: str) -> bool:
        with self._lock:
            for e in self._entries:
                if e["kind"] == kind and e["id"] == ident:
                    return False
            self._entries.append(
                {"kind": kind, "id": int(ident), "reason": reason})
        self._persist()
        _LOG.warning("quarantined %s %d (%s)", kind, ident, reason)
        return True

    def add_device(self, device_id: int, reason: str = "") -> bool:
        return self._add("device", device_id, reason)

    def add_rank(self, rank: int, reason: str = "") -> bool:
        return self._add("rank", rank, reason)

    def suspects_device(self, device) -> bool:
        """True when ``device`` (anything with ``.id`` and
        ``.process_index``, or a ``torch.device``) is excluded: by device
        index, or as the device of a quarantined rank."""
        ident = getattr(device, "id", None)
        if ident is None:
            ident = getattr(device, "index", None) or 0
        proc = getattr(device, "process_index", None)
        with self._lock:
            for e in self._entries:
                if e["kind"] == "device" and e["id"] == ident:
                    return True
                if e["kind"] == "rank" and proc is not None \
                        and e["id"] == proc:
                    return True
        return False

    def filter_devices(self, devices: Sequence) -> List:
        """The devices minus every suspect."""
        return [d for d in devices if not self.suspects_device(d)]

    def _persist(self) -> None:
        if self.path is None:
            return
        _faults.retry_call(self._persist_once, site="sentinel.quarantine")

    def _persist_once(self) -> None:
        with self._lock:
            data = json.dumps(self._entries)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        try:
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise


_ACTIVE: List[Optional[Quarantine]] = [None]


def install_quarantine(q: Optional[Quarantine]) -> Optional[Quarantine]:
    """Install (or, with None, clear) the process-wide quarantine that
    mesh resolution consults."""
    _ACTIVE[0] = q
    return q


def active_quarantine() -> Optional[Quarantine]:
    return _ACTIVE[0]


def quarantine_ranks(ranks: Sequence[int], reason: str = "") -> int:
    """Suspected-dead ranks (a ``HeartbeatMonitor`` verdict) into the
    active quarantine; 0 when none is installed."""
    q = active_quarantine()
    if q is None:
        return 0
    added = 0
    for r in ranks:
        if q.add_rank(int(r), reason or "suspected dead"):
            added += 1
    return added


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------

def _rank_values(v: int) -> List[int]:
    """Every rank's ``v`` in rank order (this one alone without a world):
    the ranks of the current mesh's group where a quarantine left ranks out
    of it, else the world's."""
    import torch.distributed as dist

    from .parallel.mesh import current_mesh

    if not (dist.is_available() and dist.is_initialized()):
        return [v]
    group = getattr(current_mesh(), "world_group", None)
    n = dist.get_world_size(group)
    if n <= 1:
        return [v]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, v, group=group)
    return [int(x) for x in out]


class Sentinel:
    """The training-integrity monitor: attach it to a compiled step and
    pass it as ``run_elastic(anomaly_fn=...)``::

        step = trainer.compile_step(net, loss_fn)
        snt = sentinel.Sentinel(step=step, directory=ckpt_dir)
        run_elastic(step_fn, state, inputs, ckpt, anomaly_fn=snt, ...)

    Per compiled dispatch the step asks :meth:`want_digest` (True every
    ``every`` calls) and hands the digest form's outputs to
    :meth:`offer`, which consumes the previous pending digest (lagged
    read), votes across ranks, updates the windows and latches a verdict.
    ``run_elastic`` reads the verdict through ``__call__`` on the
    ``every`` cadence and through :meth:`flush` before each save.
    ``every=0`` (or ``MXNET_SENTINEL_EVERY=0``) turns it off."""

    def __init__(self, step=None, directory: Optional[str] = None,
                 every: Optional[int] = None, zmax: Optional[float] = None,
                 strikes: Optional[int] = None,
                 loss_window: bool = True,
                 quarantine: Optional[Quarantine] = None):
        self.every = int(_config.get("MXNET_SENTINEL_EVERY")
                         if every is None else every)
        self.strikes = int(_config.get("MXNET_SENTINEL_STRIKES")
                           if strikes is None else strikes)
        self._gnorm = Window(zmax=zmax)
        self._loss = Window(zmax=zmax) if loss_window else None
        self._calls = 0
        self._pending = None       # (host copies, event, call)
        self._tripped: Optional[Dict[str, Any]] = None
        self._strike_counts: Dict[int, int] = {}
        # the cross-rank vote: off where the step splits its parameters
        self.vote = True
        self.last_fold: Optional[int] = None
        self.last_gnorm: Optional[float] = None
        self.last_psum: Optional[float] = None
        self.last_vote: Optional[Dict[str, Any]] = None
        self.last_rollback: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        if quarantine is not None:
            self.quarantine = quarantine
        elif directory is not None:
            self.quarantine = Quarantine(
                os.path.join(directory, "quarantine.json"))
        else:
            self.quarantine = Quarantine(None)
        install_quarantine(self.quarantine)
        if step is not None:
            step.attach_sentinel(self)
        _engine.register_drainable(self)

    # -- the step's side --------------------------------------------------
    def want_digest(self) -> bool:
        """Called once per compiled dispatch; True on sentinel steps."""
        if self.every <= 0:
            return False
        self._calls += 1
        return self._calls % self.every == 0

    def offer(self, fold, psum, gnorm) -> None:
        """Take the just-dispatched digest (device scalars, unread): start
        its copy to pinned host memory behind an event, and consume the
        previous pending digest, whose copy finished long ago."""
        prev, self._pending = self._pending, self._stage(fold, psum, gnorm)
        if prev is not None:
            self._consume(prev)

    @staticmethod
    def _stage(fold, psum, gnorm):
        vals = torch.stack([fold.to(torch.float64),
                            psum.to(torch.float64),
                            gnorm.to(torch.float64)])
        if vals.device.type != "cuda":
            return vals.clone(), None, fold
        host = torch.empty(3, dtype=torch.float64, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(vals.device))
        return host, done, fold

    def observe_loss(self, value) -> None:
        """Feed an already-read host loss value into the loss window."""
        if self._loss is None or self._tripped is not None:
            return
        if self._loss.update(float(value)):
            self._trip("loss_anomaly", value=float(value))

    # -- run_elastic's side -----------------------------------------------
    def __call__(self, state=None) -> bool:
        """The ``anomaly_fn`` protocol: True when a verdict is latched
        (fault site ``sentinel.rollback`` fires here)."""
        _faults.inject("sentinel.rollback")
        return self._take_verdict()

    def flush(self) -> bool:
        """Consume the pending digest now and return the verdict
        (``run_elastic`` calls it before every save)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._consume(pending)
        return self._take_verdict()

    def drain(self) -> None:
        """``engine.waitall()`` hook: consume the pending digest; never
        raises a verdict."""
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                self._consume(pending)
            except Exception as e:      # a drain must never wedge
                _LOG.warning("sentinel drain read failed: %r", e)

    def reset_window(self) -> None:
        """Forget the windows and the pending digest (after a rollback)."""
        self._gnorm.reset()
        if self._loss is not None:
            self._loss.reset()
        self._pending = None

    # -- internals --------------------------------------------------------
    def _take_verdict(self) -> bool:
        tripped, self._tripped = self._tripped, None
        if tripped is None:
            return False
        self.last_rollback = tripped
        _ROLLBACKS.inc()
        _faults.record_event("sentinel.rollback", "rollback", **tripped)
        self.reset_window()
        return True

    def _trip(self, reason: str, **info) -> None:
        if self._tripped is None:
            self._tripped = dict(info, reason=reason)

    def _consume(self, pending) -> None:
        host, done, _fold = pending
        if done is not None:
            if not done.query():
                _LATE.inc()
            done.synchronize()
        _DIGESTS.inc()
        fold, psum, gnorm = host.tolist()
        fold = int(fold)
        values = _rank_values(fold) if self.vote else [fold]
        counts: Dict[int, int] = {}
        for v in values:
            counts[v] = counts.get(v, 0) + 1
        majority = max(counts, key=lambda v: counts[v])
        self.last_fold = majority
        suspects = [r for r, v in enumerate(values) if v != majority]
        self.last_vote = {"ranks": list(range(len(values))),
                          "values": values, "majority": majority,
                          "suspects": suspects}
        self.history.append({"fold": fold, "psum": psum, "gnorm": gnorm})
        if suspects:
            _DIVERGENCE.inc()
            for r in suspects:
                n = self._strike_counts.get(r, 0) + 1
                self._strike_counts[r] = n
                _telemetry.event("corruption", "sentinel", rank=r,
                                 strikes=n, majority=majority,
                                 value=values[r])
                if n >= self.strikes:
                    self.quarantine.add_rank(
                        r, f"replica divergence x{n} "
                           f"(digest != majority {majority})")
            _LOG.error("cross-rank digest vote: rank(s) %s diverged from "
                       "majority %d; rolling back to the last verified "
                       "checkpoint", suspects, majority)
            self._trip("replica_divergence", ranks=suspects)
            return
        self.last_gnorm = gnorm
        self.last_psum = psum
        if self._gnorm.update(gnorm):
            self._trip("grad_norm_anomaly", value=gnorm)
