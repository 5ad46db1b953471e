"""The engine: the host side of the asynchronous pipeline.

Counterpart of ``mxnet_tpu/engine.py``, whole:

- :func:`engine_type` (``MXNET_ENGINE_TYPE``), :func:`is_naive` and
  :func:`prefetch_depth` (``MXNET_ENGINE_PREFETCH``, 0 under
  ``NaiveEngine``). The reference's ``amp_lag`` waits for AMP (ROADMAP
  A7b).
- the drainable registry: every object with outstanding asynchronous
  host-side work (prefetchers, device metric accumulators, checkpoint
  writers, the sentinel, the serving engines' queues) registers itself
  (:func:`register_drainable`, weakly held), and :func:`waitall` drains
  them all, synchronizes the device (waiting for any capture in flight,
  ``program_store.synchronize``) and flushes the telemetry flight
  recorder: the reference's ``MXEngineWaitAll`` semantics.
- :class:`DevicePrefetcher` / :func:`prefetch`: one producer thread stages
  batch N+1 while step N runs, into a bounded FIFO. On a CUDA device the
  staging copies each host leaf from pinned memory on a side stream and
  records an event there; the consumer's stream waits on that event and
  the staged tensors are marked used by it (``record_stream``), so no
  stream or device synchronization is needed. Pinned buffers come from
  torch's caching host allocator, which reuses one only after the copies
  that read it have finished.
- :func:`bulk` / :func:`set_bulk_size` and :func:`naive_sync`: under
  ``NaiveEngine`` every eager op synchronizes (``ndarray.invoke`` calls
  :func:`naive_sync`), and inside ``bulk(n)`` every n-th op does.

Every blocking synchronization this module makes is counted
(:func:`sync_count`, counter ``engine.host_sync``), so a pipelined loop
can show that it made none.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as onp
import torch

from . import config as _config
from . import program_store as _pstore
from . import telemetry as _telemetry

__all__ = ["amp_lag", "bulk", "set_bulk_size", "waitall", "engine_type", "is_naive",
           "prefetch", "DevicePrefetcher", "prefetch_depth",
           "register_drainable", "drainable_count", "naive_sync",
           "sync_count", "synchronize"]

_bulk_size = 15
_TL = threading.local()

# weakly held: a dropped prefetcher, metric or engine unregisters itself by
# dying
_DRAINABLES: "weakref.WeakSet" = weakref.WeakSet()

_SYNCS = _telemetry.counter(
    "engine.host_sync",
    "blocking device synchronizations made through the engine (waitall, "
    "the NaiveEngine per-op barrier, a bulk scope's exit, "
    "engine.synchronize)")


def engine_type() -> str:
    """``MXNET_ENGINE_TYPE``: ``ThreadedEnginePerDevice`` (default, the
    asynchronous pipeline) or ``NaiveEngine`` (synchronous debugging)."""
    return _config.get("MXNET_ENGINE_TYPE")


def is_naive() -> bool:
    return engine_type() == "NaiveEngine"


def prefetch_depth() -> int:
    """Effective prefetch depth (``MXNET_ENGINE_PREFETCH``); NaiveEngine
    forces 0."""
    if is_naive():
        return 0
    return max(0, int(_config.get("MXNET_ENGINE_PREFETCH")))


def amp_lag() -> int:
    """The deferred AMP gate's lag window (``MXNET_AMP_LAG``, clamped to
    0..1: one unread flag at most); NaiveEngine forces 0, the synchronous
    gate (reference ``engine.py:88-95``)."""
    if is_naive():
        return 0
    return min(1, max(0, int(_config.get("MXNET_AMP_LAG"))))


def sync_count() -> int:
    """Blocking device synchronizations made through :func:`synchronize`
    (the counter ``engine.host_sync``)."""
    return int(_SYNCS.value)


def synchronize(device=None) -> None:
    """One counted blocking synchronization of ``device`` (the current
    CUDA device when None), made outside every capture in flight; only
    counted where no CUDA device is in use."""
    _SYNCS.inc()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _pstore.synchronize(device)


# ---------------------------------------------------------------------------
# drainable registry + waitall
# ---------------------------------------------------------------------------

def register_drainable(obj):
    """Register an object with a ``.drain()`` method; :func:`waitall`
    drains every live one. Weakly referenced: no unregister needed."""
    _DRAINABLES.add(obj)
    return obj


def drainable_count() -> int:
    """Live drainable registrations (the computed gauge
    ``engine.drainables``)."""
    return len(_DRAINABLES)


_telemetry.gauge_fn(
    "engine.drainables", lambda: len(_DRAINABLES),
    "live drainable registrations (prefetchers, metric accumulators, "
    "checkpoint writers, the sentinel, serving and decode queues)")


def waitall() -> None:
    """Block until all outstanding asynchronous work completes: drain
    every registered object (errors it absorbed surface here), synchronize
    the device when CUDA is in use, then flush the flight recorder (a
    no-op unless ``MXNET_TELEMETRY_DIR`` is set)."""
    for obj in list(_DRAINABLES):
        drain = getattr(obj, "drain", None)
        if drain is not None:
            drain()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        synchronize()
    try:
        _telemetry.flush()
    except OSError:           # an unwritable directory must not fail waitall
        pass


# ---------------------------------------------------------------------------
# bulk scope (real semantics under NaiveEngine)
# ---------------------------------------------------------------------------

def set_bulk_size(size: int) -> int:
    """Reference ``MXEngineSetBulkSize``: under NaiveEngine the per-op
    synchronization stride inside a :func:`bulk` scope. Returns the
    previous size."""
    global _bulk_size
    prev = _bulk_size
    _bulk_size = int(size)
    return prev


def _block(tensors) -> None:
    """Wait for the work that produces ``tensors`` (one counted
    synchronization of their CUDA devices)."""
    _SYNCS.inc()
    for d in {t.device for t in tensors if isinstance(t, torch.Tensor)
              and t.device.type == "cuda"}:
        _pstore.synchronize(d)


@contextlib.contextmanager
def bulk(size: int):
    """Reference engine bulk scope. Under the asynchronous engine it is
    advisory; under NaiveEngine ops inside the scope synchronize every
    ``size`` ops instead of every op, and the scope's exit is a
    barrier."""
    prev = set_bulk_size(size)
    _TL.bulk_depth = getattr(_TL, "bulk_depth", 0) + 1
    try:
        yield
    finally:
        _TL.bulk_depth -= 1
        tail = getattr(_TL, "bulk_tail", None)
        _TL.bulk_tail = None
        _TL.bulk_pending = 0
        if tail is not None and is_naive():
            _block(tail)
        set_bulk_size(prev)


def naive_sync(tensors) -> None:
    """NaiveEngine's per-op barrier (``ndarray.invoke`` calls it after
    each eager op): block so that errors surface at the faulting op,
    except inside a :func:`bulk` scope, where the barrier fires every
    ``bulk_size`` ops (the scope's exit still synchronizes the tail)."""
    if getattr(_TL, "bulk_depth", 0) <= 0 or _bulk_size <= 1:
        _block(tensors)
        return
    _TL.bulk_pending = getattr(_TL, "bulk_pending", 0) + 1
    _TL.bulk_tail = tensors
    if _TL.bulk_pending >= _bulk_size:
        _TL.bulk_pending = 0
        _TL.bulk_tail = None
        _block(tensors)


# ---------------------------------------------------------------------------
# device prefetch stage
# ---------------------------------------------------------------------------

def _leaves(item) -> List[torch.Tensor]:
    from .ndarray import NDArray

    if isinstance(item, (tuple, list)):
        return [t for x in item for t in _leaves(x)]
    if isinstance(item, NDArray):
        return [item._data]
    return [item] if isinstance(item, torch.Tensor) else []


def _stage_tensor(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One host leaf on ``device``: from pinned memory by an asynchronous
    copy on the current (side) stream when ``device`` is CUDA."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def _default_transfer(item, device=None):
    """A host batch on the device: every leaf staged (the DataLoader's
    staging contract). numpy leaves come back as NDArrays (the reference's
    ``array(item)``), tensors as tensors, NDArrays on the device as they
    are."""
    from .context import context_of, resolve_device
    from .ndarray import NDArray
    from .ndarray.ndarray import _wrap

    dev = resolve_device(device)
    if isinstance(item, (tuple, list)):
        return type(item)(_default_transfer(x, dev) for x in item)
    if isinstance(item, NDArray):
        if item._data.device == dev:
            return item
        return _wrap(_stage_tensor(item._data, dev), context_of(dev))
    if isinstance(item, torch.Tensor):
        return _stage_tensor(item, dev)
    arr = onp.asarray(item)
    from .ndarray.ndarray import array

    # the narrowing rules of mx.nd.array, then the pinned copy
    host = array(arr, ctx=context_of(torch.device("cpu")))._data
    return _wrap(_stage_tensor(host, dev), context_of(dev))


def _bucket_pad(policy):
    """Bucket padding (``serving.BucketPolicy``) of host batches: every
    leaf's batch axis pads up to its bucket before the copy, so a
    variable-length stream stages a bounded set of shapes."""
    from .ndarray import NDArray

    def pad(x):
        if isinstance(x, (tuple, list)):
            return type(x)(pad(v) for v in x)
        if isinstance(x, NDArray):
            x = x._data
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            onp.asarray(x))
        if t.dim() < 1:
            return x
        b = policy.bucket(int(t.shape[0]))
        if b is None or b == t.shape[0]:
            return x
        from .serving import pad_axis0

        out = pad_axis0(t, b)
        return out if isinstance(x, torch.Tensor) else out.numpy()

    return pad


def _bucket_transfer(policy, device=None):
    pad = _bucket_pad(policy)

    def transfer(item):
        return _default_transfer(pad(item), device)

    return transfer


def _sharded_transfer(sharding, policy=None):
    """Staging onto a mesh: every leaf becomes this rank's rows of the
    global batch on the mesh's device (``parallel.spmd.put_batch``), so a
    step on the mesh takes the prefetched batch without another copy;
    ``policy`` pads before the put."""
    from .context import context_of
    from .ndarray import NDArray
    from .ndarray.ndarray import _wrap
    from .parallel import spmd as _spmd

    mesh = sharding.mesh
    pad = _bucket_pad(policy) if policy is not None else (lambda x: x)

    def put(x):
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, NDArray):
            return _wrap(_spmd.put_batch(x._data, mesh), x.ctx)
        if isinstance(x, torch.Tensor):
            return _spmd.put_batch(x, mesh)
        return _wrap(_spmd.put_batch(onp.asarray(x), mesh),
                     context_of(torch.device(mesh.device)))

    def transfer(item):
        return put(pad(item))

    return transfer


class DevicePrefetcher:
    """Depth-k device prefetch: a transfer thread pulls items from
    ``source`` and stages them onto ``device`` (``transfer``, default the
    pinned-memory staging above) into a bounded FIFO, so batch N+1's
    host-to-device copy overlaps step N.

    Order: one producer, one FIFO: items come in source order, never
    reordered, dropped or duplicated; a source exception is delivered in
    order, after every batch the source produced before it. A transient
    transfer failure retries under the shared policy (site
    ``engine.prefetch``). The thread stops staging new batches once
    ``preemption.draining()`` is set, and the consumer sees the end of
    the stream.

    On a CUDA device each staged item carries an event recorded on the
    producer's side stream after its copies; taking the item makes the
    consumer's current stream wait on it and marks the item's tensors as
    used by that stream: no stream or device synchronization anywhere.
    The FIFO's depth bounds the staged batches, as the reference's does.

    ``stats()`` gives the staged count and the dispatch-ahead depth (how
    many batches were already staged each time the consumer took one);
    ``steady_ahead`` is the pipeline's headline gauge.
    """

    def __init__(self, source: Iterable, depth: Optional[int] = None,
                 transfer: Optional[Callable] = None,
                 name: str = "prefetch", device=None):
        from .context import resolve_device

        self._source = iter(source)
        self._device = resolve_device(device)
        self._transfer = transfer or (
            lambda item: _default_transfer(item, self._device))
        self._depth = prefetch_depth() if depth is None \
            else max(1, int(depth))
        if self._depth < 1:
            self._depth = 1
        self._q: "_queue.Queue" = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._idle = threading.Event()  # no transfer in flight
        self._idle.set()
        self._staged = 0
        self._ahead_samples: List[int] = []
        self._done = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"mxnet-{name}")
        self._thread.start()
        register_drainable(self)

    # -- producer --------------------------------------------------------
    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    def _stage(self, item):
        """(the staged item, the event its copies end with or None)."""
        from . import faults as _faults

        if self._device.type != "cuda":
            return _faults.retry_call(self._transfer, item,
                                      site="engine.prefetch"), None
        stream = _pstore._side_stream(self._device)
        with torch.cuda.stream(stream):
            out = _faults.retry_call(self._transfer, item,
                                     site="engine.prefetch")
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _run(self):
        from . import preemption as _preemption

        try:
            while not self._stop.is_set():
                if _preemption.draining():
                    # stop staging new batches; the staged ones stay
                    # deliverable and the consumer sees the end
                    self._put(("end", None))
                    return
                try:
                    item = next(self._source)
                except StopIteration:
                    self._put(("end", None))
                    return
                self._idle.clear()
                try:
                    out = self._stage(item)
                finally:
                    self._idle.set()
                self._staged += 1
                self._put(("ok", out))
        except BaseException as e:   # delivered in order, then stop
            self._put(("error", e))
        finally:
            self._idle.set()

    # -- consumer --------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        ahead = self._q.qsize()
        kind, val = self._q.get()
        if kind == "end":
            self._done = True
            raise StopIteration
        if kind == "error":
            self._done = True
            raise val
        self._ahead_samples.append(ahead)
        out, done = val
        if done is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(done)
            for t in _leaves(out):
                if t.device.type == "cuda":
                    t.record_stream(cur)
        return out

    # -- lifecycle / introspection --------------------------------------
    def drain(self, timeout: float = 60.0) -> None:
        """Block until the transfer in flight, if any, has been staged
        (enqueued on the device)."""
        self._idle.wait(timeout)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self._done = True

    def stats(self) -> Dict[str, Any]:
        samples = self._ahead_samples
        # the first take races the thread's start; steady state is the rest
        steady = sorted(samples[1:]) if len(samples) > 1 else sorted(samples)
        return {
            "depth": self._depth,
            "staged": self._staged,
            "consumed": len(samples),
            "max_ahead": max(samples, default=0),
            "steady_ahead": steady[len(steady) // 2] if steady else 0,
        }


def prefetch(source: Iterable, depth: Optional[int] = None,
             transfer: Optional[Callable] = None, bucket: bool = False,
             sharding=None, device=None):
    """Wrap an iterable of host batches in a :class:`DevicePrefetcher`.

    ``depth`` defaults to ``MXNET_ENGINE_PREFETCH``; depth 0 (or
    ``NaiveEngine``) returns a synchronous generator applying the same
    transfer inline, so the call site stays the same. ``bucket=True``
    pads each batch's leading axis up to its ``MXNET_SHAPE_BUCKETS``
    bucket before the copy. ``sharding`` (a batch ``NamedSharding``)
    stages each leaf as this rank's rows on the mesh. ``device`` is where
    batches land (the current context's device by default, ``cuda``)."""
    from .context import resolve_device

    # resolved here: the current context is the calling thread's
    device = resolve_device(device)
    policy = None
    if bucket:
        from . import serving as _serving

        p = _serving.BucketPolicy()
        if p.enabled:
            policy = p
    if transfer is None:
        if sharding is not None:
            transfer = _sharded_transfer(sharding, policy)
        elif policy is not None:
            transfer = _bucket_transfer(policy, device)
    eff_depth = prefetch_depth() if depth is None else max(0, int(depth))
    if is_naive():
        eff_depth = 0
    if eff_depth < 1:
        fn = transfer or (lambda item: _default_transfer(item, device))
        return (fn(item) for item in source)
    return DevicePrefetcher(source, depth=eff_depth, transfer=transfer,
                            device=device)
