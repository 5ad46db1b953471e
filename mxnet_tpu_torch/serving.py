"""Shape-bucketed captured inference with dynamic micro-batching.

Counterpart of ``mxnet_tpu/serving.py``:

1. **Shape buckets** (:class:`BucketPolicy`, ``MXNET_SHAPE_BUCKETS``,
   :func:`pad_axis0`, :func:`pad_to_shape`): a variable axis is padded up
   to a bucket of a grid, so that a stream of lengths hits a bounded set of
   programs. ``Trainer.compile_step(bucket=True)`` (``cached_step.py``) and
   ``HybridBlock.hybridize(bucket=True)`` (``gluon/block.py``) pad through
   the same policy.

2. **ServingEngine** (reference :212-955): concurrent :meth:`infer` calls
   enqueue; a stager thread coalesces them into one padded batch per
   dispatch (``MXNET_SERVE_MAX_BATCH`` / ``MXNET_SERVE_MAX_DELAY_US``) and
   stages it to the device, from a pinned host buffer by a non-blocking
   copy on a staging stream with an event, into a queue of depth
   ``max(2, engine.prefetch_depth())``, so batch N+1 stages while batch N
   runs; a dispatcher thread replays one captured program per padded
   signature in the program store's ``serving`` namespace (the net's
   forward in predict mode, without grad: the counterpart of
   ``_build_jit``) and slices the results back per request. Padding is
   trusted only after a one-time verify per signature
   (``MXNET_SERVE_VERIFY``): each request's rows against its own
   exact-shape eager forward, bit-exact passing, a last-ulp difference
   within rtol 1e-5 / atol 1e-6 accepted at level 1 (counted
   ``verify_ulp_accepts``), anything else refusing bucketing for good
   (:attr:`ServingEngine.bucket_refused` keeps the reason) and serving
   exact shapes. The dispatch runs under the ``serving.infer`` fault site:
   any failure of a batched dispatch, a failed capture
   (``program_store.CaptureError``) included, falls back to single
   requests through the eager forward (reference :645-658, :938-953),
   counted in ``single_fallbacks`` with its cause in ``stats()
   ["last_fallback"]``, and an error reaches exactly the request whose
   eager forward raised it. A failed capture's program is not kept, so the
   next batch of that signature captures again.

The engine runs on the device of the net's parameters and never moves
them; a CUDA request to a CPU engine raises, and a CUDA engine never runs
a request on the CPU. One difference from the reference: requests are
flat arrays (``torch.Tensor``, ``NDArray`` or numpy, each with a leading
batch axis), not nested structures; numpy or NDArray requests return
NDArrays on the engine's context, tensor requests tensors. ``mesh=``
other than one device raises (ROADMAP A6).

:func:`bucket_stats` counts hits and misses of the ``serving`` namespace,
for the engines and for the two bucketed users above: a miss is the first
call of a bucketed signature (the one that is verified and captured).
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import autograd
from . import config as _config
from . import engine as _engine
from . import faults as _faults
from . import preemption as _preemption
from . import program_store as _pstore
from . import telemetry as _telemetry
from .context import context_of, resolve_device

__all__ = ["BucketPolicy", "ServingEngine", "pad_axis0", "pad_to_shape",
           "trace_count", "dispatch_count", "bucket_stats",
           "reset_counters"]

_NS = _pstore.namespace("serving")


def trace_count() -> int:
    return _NS.traces


def dispatch_count() -> int:
    return _NS.dispatches


def bucket_stats() -> Dict[str, int]:
    return {"hits": _NS.hits, "misses": _NS.misses}


def reset_counters() -> None:
    _NS.reset()


class BucketPolicy:
    """Maps a dynamic axis length to its padded bucket length.

    Spec (``MXNET_SHAPE_BUCKETS``):

    - ``"pow2"`` (default): round up to the next power of two;
    - ``"none"``: bucketing off (every shape stays exact);
    - ``"8,16,32,64"``: an ascending grid; a length above the largest
      bucket returns ``None`` (the caller keeps the exact shape).
    """

    def __init__(self, spec: Optional[str] = None):
        spec = (spec if spec is not None
                else _config.get("MXNET_SHAPE_BUCKETS")).strip().lower()
        self.spec = spec
        self._grid: Optional[Tuple[int, ...]] = None
        if spec not in ("pow2", "none"):
            try:
                grid = tuple(sorted({int(t) for t in spec.split(",") if t}))
            except ValueError:
                raise ValueError(
                    f"MXNET_SHAPE_BUCKETS={spec!r}: expected 'pow2', "
                    "'none', or a comma list of ints") from None
            if not grid or grid[0] < 1:
                raise ValueError(
                    f"MXNET_SHAPE_BUCKETS={spec!r}: buckets must be >= 1")
            self._grid = grid

    @property
    def enabled(self) -> bool:
        return self.spec != "none"

    def buckets(self) -> Optional[Tuple[int, ...]]:
        """The explicit grid, or None for pow2 and none."""
        return self._grid

    def bucket(self, n: int) -> Optional[int]:
        """Padded length for a true length ``n``; ``None`` when no bucket
        covers it (explicit grid only): the caller keeps the exact
        shape."""
        if not self.enabled:
            return n
        if self._grid is None:
            b = 1
            while b < n:
                b <<= 1
            return b
        for b in self._grid:
            if b >= n:
                return b
        return None

    def __repr__(self):
        return f"BucketPolicy({self.spec!r})"


def pad_axis0(data: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the leading axis up to ``target`` rows."""
    n = data.shape[0]
    if n == target:
        return data
    return torch.cat([data, data.new_zeros((target - n,) + data.shape[1:])])


def pad_to_shape(data: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Zero-pad every axis at its end up to ``shape``."""
    if tuple(data.shape) == tuple(shape):
        return data
    pads = []
    for s, t in reversed(list(zip(data.shape, shape))):
        pads += [0, int(t) - int(s)]
    return F.pad(data, pads)


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------
class _Request:
    __slots__ = ("leaves", "rows", "nd", "event", "result", "error",
                 "t_enqueue", "t_done", "trace_id")

    def __init__(self, leaves, rows, nd):
        self.leaves = leaves          # tensors, leading batch axis
        self.rows = rows
        self.nd = nd                  # answer with NDArrays
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()
        self.t_done = 0.0
        self.trace_id: Optional[str] = None


class _BucketRefused(RuntimeError):
    """Padding or coalescing declared unsafe for this model (sticky)."""


def _leaves(args) -> Tuple[List[torch.Tensor], bool]:
    """(tensors, whether to answer with NDArrays) of a request's arrays."""
    from .ndarray.ndarray import NDArray

    leaves, nd = [], False
    for a in args:
        if isinstance(a, NDArray):
            leaves.append(a._data)
            nd = True
        elif isinstance(a, np.ndarray):
            leaves.append(torch.from_numpy(np.ascontiguousarray(a)))
            nd = True
        elif isinstance(a, torch.Tensor):
            leaves.append(a)
        else:
            raise TypeError(
                "infer() takes arrays (torch.Tensor, NDArray or numpy) with "
                f"a leading batch axis, got {type(a).__name__}")
    return leaves, nd


def _outputs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _rebuild(like, outs):
    if isinstance(like, (tuple, list)):
        return type(like)(outs)
    return outs[0]


class ServingEngine:
    """Captured inference engine over one net: request coalescing,
    shape-bucketed padded programs, de-interleaved results (see the module
    docstring).

    ``engine = ServingEngine(net); out = engine.infer(x)``: ``infer`` is
    thread-safe and blocking; concurrent callers coalesce into one padded
    dispatch. ``device`` is where a net without parameters runs (default:
    the parameters' device, else the current context's)."""

    def __init__(self, net, max_batch: Optional[int] = None,
                 max_delay_us: Optional[int] = None,
                 verify: Optional[bool] = None,
                 policy: Optional[BucketPolicy] = None,
                 mesh=None, device=None):
        self._net = net
        self._policy = policy or BucketPolicy()
        self._device = self._resolve_device(net, device)
        if mesh is not None:
            mdev = getattr(mesh, "device", None)
            if mdev is None or getattr(mesh, "shape", None) is None or any(
                    int(n) != 1 for n in dict(mesh.shape).values()):
                raise NotImplementedError(
                    "ServingEngine over a mesh of more than one device is "
                    "ROADMAP A6 (not ported yet)")
            if torch.device(mdev) != self._device:
                raise ValueError(f"mesh on {mdev}, net on {self._device}")
        self._max_batch = int(max_batch if max_batch is not None
                              else _config.get("MXNET_SERVE_MAX_BATCH"))
        self._max_delay = (max_delay_us if max_delay_us is not None
                           else _config.get("MXNET_SERVE_MAX_DELAY_US")) / 1e6
        self._verify = (bool(_config.get("MXNET_SERVE_VERIFY"))
                        if verify is None else bool(verify))
        self._programs = _pstore.scope("serving")
        self._verified: set = set()
        # sticky refusal: a verify mismatch disables padding and
        # coalescing (outputs that couple across the padded axis)
        self.bucket_refused: Optional[str] = None
        # the cause of the last batched dispatch served by single requests
        self.last_fallback: Optional[str] = None
        # (leaf, axis) -> sizes seen; an axis is dynamic once two sizes
        # are seen, and only dynamic non-batch axes are padded
        self._axis_seen: Dict[Tuple, set] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._requests: "deque[_Request]" = deque()
        self._staged: "_queue.Queue" = _queue.Queue(
            maxsize=max(2, _engine.prefetch_depth()))
        self._stage_stream = None
        self._busy = 0           # groups popped but not yet staged
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._draining = False
        self._latencies: "deque[float]" = deque(maxlen=8192)
        self._stats = _telemetry.CounterGroup(
            _telemetry.instance_name("serving.engine"),
            ("requests", "batches", "coalesced", "padded_rows",
             "true_rows", "bucket_fallbacks", "single_fallbacks",
             "verify_runs", "verify_ulp_accepts", "warmup_programs",
             "shed_draining", "shed_deadline"),
            doc="ServingEngine per-instance counters",
            family="serving.engine")
        _telemetry.register_load_gauges(self, self._stats.prefix)
        _engine.register_drainable(self)

    @staticmethod
    def _resolve_device(net, device) -> torch.device:
        devs = {p.device for p in net.collect_params().values()
                if p.device is not None}
        if len(devs) > 1:
            raise ValueError(f"the net's parameters span devices {devs}")
        if devs:
            dev = devs.pop()
            if device is not None and resolve_device(device) != dev:
                raise ValueError(
                    f"the net's parameters are on {dev}, not on {device}; "
                    "the engine never moves them")
            return dev
        return resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- public ------------------------------------------------------------
    def infer(self, *args):
        """Run one request (a leading batch axis on every array); blocks
        until the coalesced dispatch delivers. Raises whatever the model
        raised for this request, never drops it."""
        with _telemetry.trace_scope():
            return self._infer_traced(args)

    def _shed(self, kind: str, reason: str, message: str):
        self._stats.inc("shed_" + kind)
        _telemetry.event("shed", self._stats.prefix, shed_kind=kind,
                         reason=reason)
        _faults.record_event("serving.infer", "shed", kind=kind,
                             reason=reason)
        raise _faults.ShedError(message, kind=kind)

    def _infer_traced(self, args):
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        if _preemption.draining() or self._draining:
            self._shed("draining", "preemption drain",
                       "serving engine draining after a preemption "
                       "notice; re-queue this request after the restart")
        leaves, nd = _leaves(args)
        if not leaves:
            raise ValueError("infer() needs at least one array argument")
        for l in leaves:
            if l.dim() < 1:
                raise ValueError(
                    "every infer() array argument needs a leading batch "
                    "axis (got a 0-d array)")
            if l.device.type == "cuda" and self._device.type != "cuda":
                raise ValueError(
                    f"a request on {l.device} for an engine on "
                    f"{self._device}: the engine never moves a CUDA "
                    "request to the CPU")
        rows = int(leaves[0].shape[0])
        for l in leaves:
            if int(l.shape[0]) != rows:
                raise ValueError(
                    "all infer() arguments must share the leading batch "
                    f"axis (got {rows} vs {int(l.shape[0])})")
        if rows < 1:
            raise ValueError("infer() needs at least one row")
        self._ensure_initialized(leaves)
        req = _Request(leaves, rows, nd)
        req.trace_id = _telemetry.current_trace()
        if req.trace_id is not None:
            _telemetry.event("admit", self._stats.prefix, rows=rows)
        self._observe_axes(req)
        rem_us = _faults.deadline_remaining_us()
        if rem_us is not None and rem_us <= 0:
            self._shed("deadline", "budget spent at admission",
                       "deadline budget already spent at admission")
        until = (time.monotonic() + rem_us / 1e6
                 if rem_us is not None else None)
        with self._cv:
            self._start_threads()
            self._requests.append(req)
            self._cv.notify_all()
        if until is None:
            delivered = req.event.wait(timeout=300.0)
        else:
            delivered = req.event.wait(
                timeout=max(0.0, until - time.monotonic()))
        if not delivered:
            if until is not None:
                with self._cv:
                    try:
                        self._requests.remove(req)
                    except ValueError:
                        pass
                self._shed("deadline", "budget exhausted in queue",
                           "deadline budget exhausted before the coalesced "
                           "dispatch delivered")
            raise _faults.DeadlineExceeded(
                "serving request not delivered within 300s (engine "
                "threads wedged?)")
        if req.error is not None:
            raise req.error
        self._latencies.append(req.t_done - req.t_enqueue)
        if req.trace_id is not None:
            _telemetry.event("retire", self._stats.prefix, rows=req.rows)
        _telemetry.record_span(
            "serving.request", "serving",
            int(req.t_enqueue * 1e9), int(req.t_done * 1e9),
            args={"rows": req.rows, "engine": self._stats.prefix})
        return req.result

    def spans(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Recent serving spans (request lifecycles and dispatches)."""
        return _telemetry.spans(cat="serving", limit=limit)

    def load(self) -> Dict[str, float]:
        """Live load signals: queued requests and staged batches."""
        with self._lock:
            depth = len(self._requests)
            busy = self._busy
        return {"queue_depth": float(depth),
                "in_flight": float(busy + self._staged.qsize()),
                "pool_pressure": 0.0}

    def stats(self) -> Dict[str, Any]:
        """Counters and latency percentiles (``p50_us``/``p99_us``)."""
        out = dict(self._stats)
        out["programs"] = len(self._programs)
        out["bucket_refused"] = self.bucket_refused
        out["last_fallback"] = self.last_fallback
        out["mesh_devices"] = 1
        lat = sorted(self._latencies)
        if lat:
            out["p50_us"] = lat[len(lat) // 2] * 1e6
            out["p99_us"] = lat[min(len(lat) - 1,
                                    int(len(lat) * 0.99))] * 1e6
            out["mean_us"] = sum(lat) / len(lat) * 1e6
        else:
            out["p50_us"] = out["p99_us"] = out["mean_us"] = 0.0
        return out

    def begin_drain(self) -> None:
        """New admissions on this engine shed typed ``draining``;
        accepted requests still deliver."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def drain(self, timeout: float = 60.0) -> None:
        """``engine.waitall()`` hook: block until every accepted request
        has been staged, dispatched and delivered."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._requests and self._busy == 0
            if idle and self._staged.unfinished_tasks == 0:
                return
            time.sleep(0.002)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._threads:
            # the stop sentinel for the dispatcher; an engine that never
            # started its threads has no consumer for it, and an unconsumed
            # item would hold drain() to its timeout
            try:
                self._staged.put_nowait(None)
            except _queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            if not self._closed:
                self.close()
        except Exception:
            pass

    # -- setup -------------------------------------------------------------
    def _ensure_initialized(self, leaves):
        params = self._net.collect_params()
        if any(p._data is None for p in params.values()):
            # one eager inference completes deferred init, exactly like
            # the first call of a hybridized block
            with torch.no_grad(), autograd.pause():
                self._net(*[l.to(self._device) for l in leaves])

    def _start_threads(self):
        if self._threads or self._closed:
            return
        stager = threading.Thread(target=self._stage_loop, daemon=True,
                                  name="mxnet-serving-stager")
        dispatcher = threading.Thread(target=self._dispatch_loop,
                                      daemon=True,
                                      name="mxnet-serving-dispatcher")
        self._threads = [stager, dispatcher]
        stager.start()
        dispatcher.start()

    def _observe_axes(self, req: _Request):
        for li, arr in enumerate(req.leaves):
            for ax in range(1, arr.dim()):
                seen = self._axis_seen.setdefault((li, ax), set())
                if len(seen) < 64:
                    seen.add(int(arr.shape[ax]))

    def _dynamic_axes(self, li, ndim) -> List[int]:
        return [ax for ax in range(1, ndim)
                if len(self._axis_seen.get((li, ax), ())) > 1]

    # -- stager: coalesce + pad + stage -------------------------------------
    def _stage_loop(self):
        while True:
            try:
                group = self._collect_group()
            except BaseException:            # keep the stager alive
                continue
            if group is None:
                return                       # closed
            with self._lock:
                self._busy += 1
            try:
                try:
                    staged = self._stage_group(group)
                except BaseException as e:   # staging failed: per request
                    self._deliver_fallback(group, cause=e)
                    continue
                self._staged.put(staged)
            finally:
                with self._lock:
                    self._busy -= 1

    def _collect_group(self) -> Optional[List[_Request]]:
        """Pop a head request, then coalesce compatible followers until
        max_batch rows or the max-delay window closes."""
        with self._cv:
            while not self._requests and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._closed and not self._requests:
                return None
            group = [self._requests.popleft()]
            if self.bucket_refused is not None:
                return group                 # single-request mode
            rows = group[0].rows
            deadline = group[0].t_enqueue + self._max_delay
            while rows < self._max_batch:
                if not self._requests:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    self._cv.wait(timeout=remain)
                    if not self._requests:
                        if time.monotonic() >= deadline:
                            break
                        continue
                head = self._requests[0]
                if not self._compatible(group[0], head):
                    break                    # preserve order; next round
                if rows + head.rows > self._max_batch:
                    break
                group.append(self._requests.popleft())
                rows += head.rows
            return group

    def _compatible(self, a: _Request, b: _Request) -> bool:
        if len(a.leaves) != len(b.leaves):
            return False
        for li, (la, lb) in enumerate(zip(a.leaves, b.leaves)):
            if la.dim() != lb.dim() or la.dtype != lb.dtype:
                return False
            dyn = set(self._dynamic_axes(li, la.dim()))
            for ax in range(1, la.dim()):
                if ax not in dyn and la.shape[ax] != lb.shape[ax]:
                    return False
        return True

    def _targets(self, group: List[_Request]):
        """(batch rows, bucket rows, per-leaf padded shapes, whether any
        padding applies)."""
        rows = sum(r.rows for r in group)
        padding = self._policy.enabled and self.bucket_refused is None
        bucket = rows
        if padding:
            b = self._policy.bucket(rows)
            if b is None:                    # above the largest bucket
                self._stats.inc("bucket_fallbacks")
            else:
                bucket = b
        pad_active = bucket != rows
        shapes = []
        for li in range(len(group[0].leaves)):
            first = group[0].leaves[li]
            target = [bucket] + list(first.shape[1:])
            for ax in self._dynamic_axes(li, first.dim()):
                size = max(int(r.leaves[li].shape[ax]) for r in group)
                tb = self._policy.bucket(size) if padding else size
                target[ax] = size if tb is None else tb
                if target[ax] != size or any(
                        int(r.leaves[li].shape[ax]) != size for r in group):
                    pad_active = True
            shapes.append(target)
        return rows, bucket, shapes, pad_active

    def _stage_group(self, group: List[_Request]):
        """Pad every request's dynamic axes to the group's target, stack
        along the batch axis, pad the batch axis to its bucket, and stage
        the batch on the device: host requests through a pinned buffer and
        a non-blocking copy on the staging stream, device requests by pad
        and concatenation there, with an event the dispatcher waits on.
        Runs on the stager thread, overlapping the dispatcher."""
        rows, bucket, shapes, pad_active = self._targets(group)
        cuda = self._device.type == "cuda"
        stream = None
        if cuda:
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self._device)
            stream = self._stage_stream
            stream.wait_stream(torch.cuda.default_stream(self._device))
        batched = []
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            for li, target in enumerate(shapes):
                parts = [r.leaves[li] for r in group]
                on_host = all(p.device.type == "cpu" for p in parts)
                if cuda and on_host:
                    host = torch.zeros(target, dtype=parts[0].dtype,
                                       pin_memory=True)
                    self._fill(host, parts)
                    dev = torch.empty(target, dtype=host.dtype,
                                      device=self._device)
                    dev.copy_(host, non_blocking=True)
                else:
                    dev = torch.zeros(target, dtype=parts[0].dtype,
                                      device=self._device)
                    for p in parts:
                        if p.device.type == "cuda":
                            p.record_stream(stream)
                    self._fill(dev, [p.to(self._device) for p in parts])
                batched.append(dev)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        self._stats.inc("padded_rows", bucket)
        self._stats.inc("true_rows", rows)
        return (group, batched, rows, pad_active, event)

    @staticmethod
    def _fill(out: torch.Tensor, parts: Sequence[torch.Tensor]) -> None:
        """Copy each part into its rows of the zeroed ``out``, at the start
        of every axis."""
        start = 0
        for p in parts:
            idx = (slice(start, start + p.shape[0]),) + tuple(
                slice(0, n) for n in p.shape[1:])
            out[idx].copy_(p)
            start += p.shape[0]

    # -- dispatcher ---------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            item = self._staged.get()
            if item is None:
                self._staged.task_done()
                return
            group, batched, rows, pad_active, event = item
            try:
                if event is not None:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(event)
                    for b in batched:
                        b.record_stream(cur)
                # the serving fault site: a failure of the batched
                # dispatch falls back to single requests, never a drop
                _faults.inject("serving.infer")
                self._dispatch(group, batched, pad_active)
            except BaseException as e:
                # any failure of the batched dispatch, a failed capture
                # included, serves each request alone through the eager
                # forward; a failed capture's program was never kept, so
                # the next batch of its signature captures anew
                _faults.record_event("serving.infer", "fallback", e,
                                     requests=len(group))
                self._stats.inc("single_fallbacks", len(group))
                self.last_fallback = repr(e)
                self._deliver_fallback(group, cause=e)
            finally:
                self._staged.task_done()

    def _held(self) -> List[torch.Tensor]:
        return [p._data for p in self._net.collect_params().values()
                if p._data is not None]

    def _sig(self, shapes_dtypes):
        held = self._held()
        return (tuple(shapes_dtypes), _pstore.knob_key(),
                _pstore.storage_key(held)), held

    def _body(self):
        net = self._net

        def serve_fn(*inputs):
            with torch.no_grad(), autograd.pause():
                return net(*inputs)

        return serve_fn

    def _program(self, sig, held, example):
        """The program of ``sig``: a hit, or a new one (not yet captured;
        the caller inserts it once its first call succeeded)."""
        rec = self._programs.lookup(sig)
        if rec is not None:
            return rec, False
        self._programs.drop_stale(held)
        return _pstore.Program(self._programs.namespace, self._body(),
                               example, self._device, keep=held), True

    def _dispatch(self, group, batched, pad_active):
        sig, held = self._sig([(tuple(b.shape), b.dtype) for b in batched])
        rec, new = self._program(sig, held, batched)
        span_args = {"rows": int(batched[0].shape[0]),
                     "requests": len(group)}
        traces = [r.trace_id for r in group if r.trace_id is not None]
        if traces:
            span_args["trace_ids"] = traces
        with _telemetry.span("serving.dispatch", cat="serving",
                             args=span_args):
            out = rec(*batched)
        if new:
            self._programs.insert(sig, rec)
        self._stats.inc("batches")
        self._stats.inc("requests", len(group))
        self._stats.inc("coalesced", len(group) - 1)
        outs = _outputs(out)
        transformed = pad_active or len(group) > 1
        padded_n = int(batched[0].shape[0])
        if transformed:
            for o in outs:
                if o.dim() < 1 or int(o.shape[0]) != padded_n:
                    raise _BucketRefused(
                        "output does not carry the batch axis (shape "
                        f"{tuple(o.shape)} vs batch {padded_n}); cannot "
                        "slice per-request results")
        if self._verify and transformed and sig not in self._verified:
            self._verify_group(group, outs)
            self._verified.add(sig)
        start = 0
        for req in group:
            mine = [o[start:start + req.rows] if transformed else o
                    for o in outs]
            start += req.rows
            self._finish(req, self._wrap(req, out, mine), None)

    def _wrap(self, req: _Request, like, outs):
        if req.nd:
            from .ndarray.ndarray import _wrap

            ctx = context_of(self._device)
            outs = [_wrap(o, ctx) for o in outs]
        return _rebuild(like, outs)

    @staticmethod
    def _finish(req: _Request, result, error) -> None:
        req.result, req.error = result, error
        req.t_done = time.monotonic()
        req.event.set()

    # -- ahead-of-time warmup ----------------------------------------------
    def warmup(self, *args, max_rows: Optional[int] = None) -> int:
        """Capture the bucket grid before serving, off the request path.
        ``args`` is one example request (its per-row shapes and dtypes;
        the row count is irrelevant). One program per bucket of the
        ``MXNET_SHAPE_BUCKETS`` grid: pow2 spans 1..``max_rows`` (default
        ``MXNET_SERVE_MAX_BATCH``), an explicit grid is taken as it is,
        ``none`` captures the example's exact shape. The first real padded
        batch of each signature is still verified. Returns the programs
        captured (0 = already warm)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        leaves, _ = _leaves(args)
        if not leaves or any(l.dim() < 1 for l in leaves):
            raise ValueError(
                "warmup() needs one example request: array arguments with "
                "a leading batch axis")
        self._ensure_initialized(leaves)
        if not self._policy.enabled:
            grid = [int(leaves[0].shape[0])]
        elif self._policy.buckets() is not None:
            grid = list(self._policy.buckets())
        else:                                     # pow2
            cap = int(max_rows if max_rows is not None
                      else self._max_batch)
            grid, b = [], 1
            while b <= cap:
                grid.append(b)
                b <<= 1
        compiled = 0
        for b in sorted(set(int(g) for g in grid)):
            example = [torch.zeros((b,) + tuple(l.shape[1:]), dtype=l.dtype,
                                   device=self._device) for l in leaves]
            sig, held = self._sig([(tuple(e.shape), e.dtype)
                                   for e in example])
            if sig in self._programs:             # already warm
                continue
            rec, _ = self._program(sig, held, example)
            rec.prepare(*example)
            self._programs.insert(sig, rec)
            compiled += 1
        self._stats.inc("warmup_programs", compiled)
        return compiled

    # -- verify-or-refuse ---------------------------------------------------
    def _verify_group(self, group, outs):
        """One-time per padded signature: each request's rows against its
        own exact-shape eager forward. Bit-exact passes; a last-ulp
        difference (rtol 1e-5, atol 1e-6) is accepted at
        ``MXNET_SERVE_VERIFY=1`` and counted (``verify_ulp_accepts``);
        anything else, or any difference at level 2, refuses with the
        reason kept."""
        strict = int(_config.get("MXNET_SERVE_VERIFY")) >= 2
        self._stats.inc("verify_runs")
        start = 0
        ulp_only = False
        for req in group:
            refs = _outputs(self._eager_forward(req))
            got = [o[start:start + req.rows] for o in outs]
            start += req.rows
            if len(refs) != len(got):
                raise _BucketRefused(
                    f"padded forward returned {len(got)} outputs, eager "
                    f"returned {len(refs)}")
            for gi, (g, r) in enumerate(zip(got, refs)):
                if g.shape != r.shape:
                    raise _BucketRefused(
                        f"output {gi} shape follows the padded length "
                        f"(padded {tuple(g.shape)} vs eager "
                        f"{tuple(r.shape)}); cannot slice back; serve with "
                        "exact shapes")
                if torch.equal(g, r):
                    continue
                if strict or not torch.allclose(g, r, rtol=1e-5,
                                                atol=1e-6):
                    raise _BucketRefused(
                        f"output {gi} not bit-exact after pad+slice (max "
                        f"abs difference {float((g.float() - r.float()).abs().max()):.3g}); "
                        "mean-style reductions over a padded axis need "
                        "masking, and kernels that change with the batch "
                        "extent change the rounding; serve this model with "
                        "exact shapes (or MXNET_SERVE_VERIFY=1 if this was "
                        "only last-ulp rounding)")
                ulp_only = True
        if ulp_only:
            self._stats.inc("verify_ulp_accepts")
            _faults.record_event("serving.infer", "verify_ulp_accept")

    def eager_infer(self, *args):
        """One request through the eager forward alone, on this engine's
        device, answered as :meth:`infer` answers it: the replica router's
        last-resort degraded mode (``MXNET_ROUTER_EAGER_FALLBACK``)."""
        leaves, nd = _leaves(args)
        req = _Request(leaves, int(leaves[0].shape[0]), nd)
        out = self._eager_forward(req)
        return self._wrap(req, out, _outputs(out))

    def _eager_forward(self, req: _Request):
        """The unpadded reference: the net's own forward (its hybridized
        programs bypassed) in predict mode, on the engine's device."""
        with torch.no_grad(), autograd.pause():
            return self._net.forward(*[l.to(self._device)
                                       for l in req.leaves])

    def _deliver_fallback(self, group, cause: BaseException):
        """Single-request fallback: each request re-runs alone through the
        eager forward on the engine's device. A refusal sticks; a request
        that still fails gets that error delivered."""
        if isinstance(cause, _BucketRefused):
            self.bucket_refused = str(cause)
            self._programs.clear()
            _faults.record_event("serving.infer", "bucket_refused",
                                 reason=str(cause))
        for req in group:
            try:
                out = self._eager_forward(req)
                self._finish(req, self._wrap(req, out, _outputs(out)), None)
            except BaseException as e:
                self._finish(req, None, e)

