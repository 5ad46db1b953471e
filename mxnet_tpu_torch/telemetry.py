"""Telemetry: one counter registry, one event bus, one span layer.

Counterpart of ``mxnet_tpu/telemetry.py`` :102-700, the part the serving
engines, the fault sites and the preemption drain call:

- **Counter registry**: :func:`counter` (kinds ``cumulative`` / ``gauge``
  / ``time``), :func:`gauge`, computed gauges (:func:`gauge_fn`,
  :func:`register_load_gauges`), per-instance prefixes
  (:func:`instance_name`), :class:`CounterGroup` (a dict-like fixed-key
  group under one prefix), and :func:`snapshot` / :func:`delta` /
  :func:`reset`, ordered by name.
- **Step index** (:func:`set_step`, :func:`next_step`,
  :func:`current_step`), stamped on every event.
- **Trace context**: a request mints a ``trace_id`` at its admission edge
  (:class:`trace_scope`, ``MXNET_TELEMETRY_TRACE``), carried in a
  thread-local stack that the engines' worker threads re-enter;
  :func:`trace` returns one request's stitched lifecycle.
- **Event bus** (:func:`event` / :func:`events`, capacity
  ``MXNET_TELEMETRY_EVENTS``) and **spans** (:func:`span`,
  :func:`record_span`, :func:`spans`). Where the reference wraps a span in
  a ``jax.profiler`` trace annotation (``MXNET_TELEMETRY_XLA``), the port
  wraps it in ``torch.profiler.record_function`` under the same knob, so
  the host bracket shows in a ``torch.profiler`` trace of the device.

- **Chrome-trace export**: every recorded span is also emitted into the
  profiler's trace buffer while the profiler runs (``profiler.dump``), and
  the spans of one request's trace link into one flow.
- **Flight recorder** (reference :705-1109): :func:`flush` writes this
  process's shard ``telemetry-r<rank>-p<pid>.jsonl`` under
  ``MXNET_TELEMETRY_DIR`` (rewritten whole through a rename, a line cap,
  rotation by ``MXNET_TELEMETRY_MAX_MB``); ``engine.waitall()`` and the
  preemption drain call it. :func:`merge` folds a directory of shards
  into one fleet snapshot, :func:`merge_chrome_trace` renders it with a
  lane per process, :func:`report` is the counter table, and
  ``python -m mxnet_tpu_torch.telemetry {report|trace|merge}``
  (:func:`main`) inspects either without a script.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
import zlib
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional

from . import config as _config

__all__ = [
    "Counter", "CounterGroup", "counter", "gauge", "gauge_fn", "get",
    "registered", "snapshot", "delta", "reset", "instance_name",
    "register_load_gauges", "event", "events", "clear_events", "set_step",
    "current_step", "next_step", "span", "record_span", "spans",
    "clear_spans", "KINDS", "tracing_enabled", "new_trace_id",
    "trace_scope", "current_trace", "current_span_id", "trace",
    "flight_recorder_path", "flush", "merge", "merge_chrome_trace",
    "report", "main", "ROUTER_COUNTERS", "FLEET_COUNTERS", "FLEET_GAUGES",
]

# one lock guards registry structure and every counter value: increments
# are atomic, and a snapshot taken under it never sees a torn update
_LOCK = threading.RLock()

KINDS = ("cumulative", "gauge", "time")

# the replica router's counter groups (serving_router.py): family
# ``serving.router`` (``serving.router<k>.<name>``, one group a router) and
# family ``router.fleet`` (the elastic fleet's lifecycle, with the
# computed gauge ``router.fleet<k>.serving_replicas``)
ROUTER_COUNTERS = (
    "requests", "delivered", "dispatches", "failovers", "hedges",
    "hedge_wins", "hedge_cancelled", "sheds", "shed_unavailable",
    "shed_deadline", "shed_draining", "breaker_opens", "breaker_half_opens",
    "breaker_closes", "probes", "probe_failures", "wedged",
    "eager_fallbacks")
FLEET_COUNTERS = ("joins", "drains", "gone", "warm_programs", "scale_ups",
                  "scale_downs", "ticks", "scale_errors")
FLEET_GAUGES = ("serving_replicas",)


class Counter:
    """One declared counter. ``cumulative`` counters move by :meth:`inc`
    and are monotonic between resets; ``gauge`` / ``time`` counters take
    :meth:`set`."""

    __slots__ = ("name", "doc", "kind", "family", "_value")

    def __init__(self, name: str, doc: str = "", kind: str = "cumulative",
                 family: Optional[str] = None):
        if kind not in KINDS:
            raise ValueError(f"counter kind {kind!r} not in {KINDS}")
        self.name = name
        self.doc = doc
        self.kind = kind
        self.family = family
        self._value = 0.0 if kind == "time" else 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self._value += n

    add = inc

    def set(self, v) -> None:
        with _LOCK:
            self._value = v

    @property
    def value(self):
        with _LOCK:
            return self._value

    def reset(self) -> None:
        self.set(0.0 if self.kind == "time" else 0)

    def __int__(self) -> int:
        return int(self.value)

    def __repr__(self) -> str:
        return (f"Counter({self.name!r}, kind={self.kind!r}, "
                f"value={self.value!r})")


_COUNTERS: Dict[str, Counter] = {}
_GAUGE_FNS: Dict[str, Callable[[], Any]] = {}
_GAUGE_DOCS: Dict[str, str] = {}
_GAUGE_FAMILIES: Dict[str, Optional[str]] = {}
_SEQ: Dict[str, int] = {}


def counter(name: str, doc: str = "", kind: str = "cumulative",
            family: Optional[str] = None) -> Counter:
    """Declare (idempotently) and return the registry counter ``name``
    (namespace-dotted; per-instance counters pass ``family``, their stable
    name)."""
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name, doc, kind, family)
        return c


def gauge(name: str, doc: str = "",
          family: Optional[str] = None) -> Counter:
    """Declare a ``gauge``-kind counter (absolute value, :meth:`set`)."""
    return counter(name, doc, kind="gauge", family=family)


def gauge_fn(name: str, fn: Callable[[], Any], doc: str = "",
             family: Optional[str] = None) -> None:
    """Register a computed gauge: :func:`snapshot` calls ``fn()`` for its
    value."""
    with _LOCK:
        _GAUGE_FNS[name] = fn
        _GAUGE_DOCS[name] = doc
        _GAUGE_FAMILIES[name] = family


def register_load_gauges(engine, prefix: str) -> None:
    """Expose an engine's ``load()`` fields (queue depth, in-flight
    occupancy, KV page-pool pressure) as computed gauges under its
    counter-group prefix (``decode.engine0.queue_depth`` ...). Weakly
    bound: a closed or collected engine reads 0.0."""
    ref = weakref.ref(engine)
    fam = prefix.rstrip("0123456789")

    def _field(key: str):
        def read() -> float:
            eng = ref()
            if eng is None or getattr(eng, "_closed", False):
                return 0.0
            try:
                return float(eng.load().get(key, 0.0))
            except Exception:
                return 0.0
        return read

    for key, doc in (
            ("queue_depth", "Admitted-but-unscheduled requests on this "
             "engine (live load() view)"),
            ("in_flight", "In-flight occupancy of this engine (live rows "
             "/ max rows, or staged batches; load() view)"),
            ("pool_pressure", "KV page-pool pressure of this engine "
             "(1 - free/total pages; 0 for engines without a pool)")):
        gauge_fn(f"{prefix}.{key}", _field(key), doc=doc, family=fam)


def get(name: str) -> Counter:
    with _LOCK:
        try:
            return _COUNTERS[name]
        except KeyError:
            raise KeyError(
                f"undeclared telemetry counter {name!r}; declare it with "
                "telemetry.counter(name, doc, kind)") from None


def registered() -> Dict[str, Dict[str, Any]]:
    """Metadata of every declared counter (computed gauges included)."""
    with _LOCK:
        out = {n: {"kind": c.kind, "doc": c.doc, "family": c.family}
               for n, c in _COUNTERS.items()}
        for n in _GAUGE_FNS:
            out.setdefault(n, {"kind": "gauge", "doc": _GAUGE_DOCS[n],
                               "family": _GAUGE_FAMILIES.get(n)})
    return out


def instance_name(prefix: str) -> str:
    """Deterministic per-process instance prefix (``serving.engine0``,
    ``serving.engine1``, ...)."""
    with _LOCK:
        n = _SEQ.get(prefix, 0)
        _SEQ[prefix] = n + 1
    return f"{prefix}{n}"


def snapshot() -> Dict[str, Any]:
    """All counter values, sorted by name; computed gauges evaluate outside
    the lock."""
    with _LOCK:
        vals = {n: c._value for n, c in _COUNTERS.items()}
        fns = list(_GAUGE_FNS.items())
    for n, fn in fns:
        if n not in vals:
            try:
                vals[n] = fn()
            except Exception:
                vals[n] = None
    return dict(sorted(vals.items()))


def delta(base: Mapping, current: Optional[Mapping] = None
          ) -> Dict[str, Any]:
    """Counter movement since ``base`` (a prior :func:`snapshot`):
    cumulative and time counters subtract, gauges report their current
    value; counters born after ``base`` delta from 0."""
    cur = snapshot() if current is None else current
    kinds = registered()
    out: Dict[str, Any] = {}
    for name in sorted(cur):
        kind = kinds.get(name, {}).get("kind", "cumulative")
        v = cur[name]
        if kind == "gauge" or v is None:
            out[name] = v
            continue
        out[name] = v - (base.get(name, 0) or 0)
    return out


def reset(prefix: Optional[str] = None) -> None:
    """Zero declared counters, all or those whose name starts with
    ``prefix``. Events and spans are untouched."""
    with _LOCK:
        for n, c in _COUNTERS.items():
            if prefix is None or n.startswith(prefix):
                c._value = 0.0 if c.kind == "time" else 0


class CounterGroup(Mapping):
    """A fixed-key set of registry counters under one dotted prefix, read
    as a dict of ints (``dict(group)``, ``group["k"]``); ``group.inc(k)``
    is the atomic increment."""

    __slots__ = ("prefix", "_counters")

    def __init__(self, prefix: str, keys, doc: str = "",
                 kind: str = "cumulative", family: Optional[str] = None):
        self.prefix = prefix
        self._counters = {k: counter(f"{prefix}.{k}", doc, kind, family)
                          for k in keys}

    def __getitem__(self, k):
        return self._counters[k].value

    def __setitem__(self, k, v) -> None:
        self._counters[k].set(v)

    def inc(self, k, n: int = 1) -> None:
        self._counters[k].inc(n)

    def __iter__(self) -> Iterator:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()


# ---------------------------------------------------------------------------
# step index
# ---------------------------------------------------------------------------
_STEP: List[Optional[int]] = [None]


def set_step(i: Optional[int]) -> None:
    """Pin the current train-step index (events stamp it)."""
    _STEP[0] = i


def next_step() -> int:
    """Advance and return the process-wide step index."""
    with _LOCK:
        _STEP[0] = 0 if _STEP[0] is None else _STEP[0] + 1
        return _STEP[0]


def current_step() -> Optional[int]:
    return _STEP[0]


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------
_TRACE = threading.local()

_TRACES_MINTED = counter(
    "telemetry.traces_minted",
    "request trace ids minted at serving admission edges "
    "(MXNET_TELEMETRY_TRACE; one id = one end-to-end request lifecycle)")


def tracing_enabled() -> bool:
    """Is request-trace minting on (``MXNET_TELEMETRY_TRACE``, default
    1)?"""
    return bool(_config.get("MXNET_TELEMETRY_TRACE"))


def new_trace_id() -> str:
    """A process-unique trace id (``<pid hex>-<seq hex>``)."""
    with _LOCK:
        _TRACES_MINTED._value += 1
        n = _TRACES_MINTED._value
    return f"{os.getpid():x}-{n:x}"


def _trace_stack() -> List:
    st = getattr(_TRACE, "stack", None)
    if st is None:
        st = _TRACE.stack = []
    return st


def current_trace() -> Optional[str]:
    """The ambient trace id on this thread, or None."""
    st = getattr(_TRACE, "stack", None)
    return st[-1][0] if st else None


def current_span_id() -> Optional[str]:
    """The ambient parent-span id on this thread, or None."""
    st = getattr(_TRACE, "stack", None)
    return st[-1][1] if st else None


def _next_span_id() -> str:
    with _LOCK:
        _SPANS_SEQ[0] += 1
        return f"s{_SPANS_SEQ[0]:x}"


class trace_scope:
    """Establish (or re-enter) the thread's request-trace context.

    ``trace_scope()`` at an admission edge inherits the ambient trace, else
    mints a fresh id when :func:`tracing_enabled`, else is a no-op.
    ``trace_scope(trace_id=req.trace_id)`` on a worker thread carries the
    request's one identity across the thread hop; a ``None`` id is a
    passthrough. ``scope.trace_id`` is the active id."""

    __slots__ = ("trace_id", "_parent", "_pushed", "_explicit")

    _UNSET = object()

    def __init__(self, trace_id: Any = _UNSET,
                 parent: Optional[str] = None):
        self._explicit = trace_id is not trace_scope._UNSET
        self.trace_id = (None if trace_id is trace_scope._UNSET
                         else trace_id)
        self._parent = parent
        self._pushed = False

    def __enter__(self) -> "trace_scope":
        tid = self.trace_id
        if tid is None and not self._explicit:
            tid = current_trace()
            if tid is None and tracing_enabled():
                tid = new_trace_id()
        if tid is None:
            return self
        st = _trace_stack()
        parent = self._parent
        if parent is None and st:
            parent = st[-1][1]
        st.append((tid, parent))
        self.trace_id = tid
        self._pushed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._pushed:
            _trace_stack().pop()
            self._pushed = False


def trace(trace_id: str) -> Dict[str, Any]:
    """One request's stitched lifecycle: every buffered event stamped with
    ``trace_id`` and every span that carries it (directly or in its
    ``args.trace_ids``), merged into one time-ordered ``records`` list."""
    evs = [e for e in events() if e.get("trace_id") == trace_id]
    sps = [s for s in spans()
           if s.get("trace_id") == trace_id or trace_id in
           ((s.get("args") or {}).get("trace_ids") or ())]
    records: List[Dict[str, Any]] = [dict(e, type="event") for e in evs]
    records += [dict(s, type="span", t_us=s["t0_us"]) for s in sps]
    records.sort(key=lambda r: (r["t_us"], r.get("seq", 0)))
    return {"trace_id": trace_id, "events": evs, "spans": sps,
            "records": records}


# ---------------------------------------------------------------------------
# event bus
# ---------------------------------------------------------------------------
_EVENTS: "deque" = deque(
    maxlen=max(1, int(_config.get("MXNET_TELEMETRY_EVENTS"))))
_EVENTS_EMITTED = counter(
    "telemetry.events", "structured events emitted through the bus "
    "(the bounded buffer keeps the newest MXNET_TELEMETRY_EVENTS)")
_EVT_LOCK = threading.Lock()
_FLUSH_SEQ = [0]          # bus sequence already flushed to disk

_RESERVED_EVENT_KEYS = ("kind", "name", "step", "t_us", "seq",
                        "trace_id", "parent")


def event(kind: str, name: str, /, step: Any = "auto", **fields) -> None:
    """Append one structured event: ``kind`` (shed, preempt, fault,
    admit, retire, ...), ``name`` the subsystem or site, the step index
    and a monotonic microsecond timestamp; inside a request's
    :class:`trace_scope` also ``trace_id`` and ``parent``. Extra fields
    whose names collide with the bus keys are prefixed ``x_``."""
    ev: Dict[str, Any] = {
        "kind": kind, "name": name,
        "step": current_step() if step == "auto" else step,
        "t_us": time.monotonic_ns() // 1000,
    }
    tid = current_trace()
    if tid is not None:
        ev["trace_id"] = tid
        sid = current_span_id()
        if sid is not None:
            ev["parent"] = sid
    for k, v in fields.items():
        if v is not None:
            ev["x_" + k if k in _RESERVED_EVENT_KEYS else k] = v
    with _EVT_LOCK:
        _EVENTS_EMITTED.inc()
        ev["seq"] = int(_EVENTS_EMITTED.value)
        _EVENTS.append(ev)


def events(kind: Optional[str] = None,
           name: Optional[str] = None) -> List[Dict[str, Any]]:
    with _EVT_LOCK:
        evs = list(_EVENTS)
    if kind is not None:
        evs = [e for e in evs if e["kind"] == kind]
    if name is not None:
        evs = [e for e in evs if e["name"] == name]
    return evs


def clear_events() -> None:
    """Drop buffered events; the emitted counter is untouched."""
    with _EVT_LOCK:
        _EVENTS.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
_SPANS: "deque" = deque(maxlen=2048)
_SPANS_SEQ = [0]          # span ids + the flight recorder's flush cursor
# trace ids whose chrome flow already emitted its "s" (start) arrow: later
# spans of the same trace emit "t" (step), so a request renders as one flow
_FLOW_STARTED: set = set()


def _flow_id(trace_id: str) -> int:
    return zlib.crc32(trace_id.encode()) & 0x7FFFFFFF

_SPANS_RECORDED = counter(
    "telemetry.spans", "completed spans recorded (serving / decode / user "
    "categories)")


def record_span(name: str, cat: str, t0_ns: int, t1_ns: int,
                step: Any = "auto",
                args: Optional[Dict[str, Any]] = None,
                span_id: Optional[str] = None) -> Dict[str, Any]:
    """Record one completed span post-hoc (the lifecycle spans whose
    endpoints were timed elsewhere). Inside a request's
    :class:`trace_scope` it stamps ``trace_id``, ``parent`` and its own
    ``id``."""
    rec = {
        "name": name, "cat": cat,
        "step": current_step() if step == "auto" else step,
        "t0_us": t0_ns // 1000,
        "dur_us": max((t1_ns - t0_ns) // 1000, 1),
        "thread": threading.get_ident(),
    }
    tid = current_trace()
    if tid is not None:
        rec["trace_id"] = tid
        rec["id"] = span_id if span_id is not None else _next_span_id()
        parent = current_span_id()
        if parent is not None and parent != rec["id"]:
            rec["parent"] = parent
    with _LOCK:
        _SPANS_SEQ[0] += 1
        rec["seq"] = _SPANS_SEQ[0]
    if args:
        rec["args"] = dict(args)
    _SPANS_RECORDED.inc()
    _SPANS.append(rec)
    from . import profiler as _profiler

    _profiler._emit(name, cat, "X", ts=rec["t0_us"], dur=rec["dur_us"],
                    args=rec.get("args"))
    if tid is not None:
        first = tid not in _FLOW_STARTED
        if first:
            _FLOW_STARTED.add(tid)
            if len(_FLOW_STARTED) > 8192:
                _FLOW_STARTED.clear()
                _FLOW_STARTED.add(tid)
        _profiler._emit(f"trace:{tid}", "flow", "s" if first else "t",
                        ts=rec["t0_us"], flow_id=_flow_id(tid))
    return rec


def _profiler_ranges_on() -> bool:
    return bool(_config.get("MXNET_TELEMETRY_XLA"))


class span:
    """Context-manager span: times the enclosed work and records it (see
    :func:`record_span`); with ``MXNET_TELEMETRY_XLA=1`` it also opens a
    ``torch.profiler.record_function`` range named ``cat:name``. Inside a
    request's :class:`trace_scope` the span takes an id at entry and is
    the ambient parent of everything recorded under it."""

    __slots__ = ("name", "cat", "args", "_t0", "_ann", "_sid", "_pushed")

    def __init__(self, name: str, cat: str = "user",
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.args = dict(args) if args else None
        self._t0 = None
        self._ann = None
        self._sid = None
        self._pushed = False

    def annotate(self, **kw) -> "span":
        """Attach or extend span args mid-flight (recorded at exit)."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter_ns()
        st = getattr(_TRACE, "stack", None)
        if st:
            self._sid = _next_span_id()
            st.append((st[-1][0], self._sid))
            self._pushed = True
        if _profiler_ranges_on():
            import torch.profiler

            self._ann = torch.profiler.record_function(
                f"{self.cat}:{self.name}")
            self._ann.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            finally:
                self._ann = None
        if self._pushed:
            _trace_stack().pop()
            self._pushed = False
        if self._t0 is not None:
            record_span(self.name, self.cat, self._t0,
                        time.perf_counter_ns(), args=self.args,
                        span_id=self._sid)
            self._t0 = None


def spans(cat: Optional[str] = None,
          limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Recent completed span records, oldest first (bounded buffer)."""
    out = list(_SPANS)
    if cat is not None:
        out = [s for s in out if s["cat"] == cat]
    if limit is not None:
        out = out[-int(limit):]
    return out


def clear_spans() -> None:
    _SPANS.clear()
    _FLOW_STARTED.clear()


# ---------------------------------------------------------------------------
# exporters: the flight recorder (per-process shards) + fleet merge
# ---------------------------------------------------------------------------
_SHARDS_ROTATED = counter(
    "telemetry.shards_rotated",
    "flight-recorder shards deleted by the MXNET_TELEMETRY_MAX_MB "
    "oldest-first size-cap rotation")


def _flight_dir() -> Optional[str]:
    d = _config.get("MXNET_TELEMETRY_DIR")
    if not d:
        return None
    return os.path.expanduser(d)


def _process_rank() -> int:
    """``MXNET_TPU_PROC_ID``, else the ``torch.distributed`` rank when a
    world is up, else 0."""
    r = _config.get("MXNET_TPU_PROC_ID")
    if r is not None:
        return int(r)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def flight_recorder_path() -> Optional[str]:
    """This process's shard file (``MXNET_TELEMETRY_DIR`` set), else None
    (recorder off). Shards are stamped with rank and pid,
    ``telemetry-r<rank>-p<pid>.jsonl``, so every process writes its own
    file and :func:`merge` folds them back together."""
    d = _flight_dir()
    if d is None:
        return None
    return os.path.join(
        d, f"telemetry-r{_process_rank()}-p{os.getpid()}.jsonl")


_FLUSH_LOCK = threading.Lock()
_SPAN_FLUSH_SEQ = [0]     # span sequence already flushed to disk


def _shard_line_cap() -> int:
    # the newest 4x the bus capacity of event and span lines survive
    return 4 * max(1, int(_config.get("MXNET_TELEMETRY_EVENTS")))


def _rotate_shards(directory: str, keep: str) -> int:
    """``MXNET_TELEMETRY_MAX_MB`` over the shard directory: delete the
    oldest shards (never ``keep``, this process's own) until the total
    fits. Returns the shards removed."""
    cap_mb = float(_config.get("MXNET_TELEMETRY_MAX_MB"))
    if cap_mb <= 0:
        return 0
    cap = cap_mb * 1024 * 1024
    shards = []
    try:
        for fn in os.listdir(directory):
            if fn.startswith("telemetry-") and fn.endswith(".jsonl"):
                p = os.path.join(directory, fn)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                shards.append((st.st_mtime, st.st_size, p))
    except OSError:
        return 0
    total = sum(s for _m, s, _p in shards)
    removed = 0
    for _mtime, size, p in sorted(shards):
        if total <= cap:
            break
        if os.path.abspath(p) == os.path.abspath(keep):
            continue
        try:
            os.unlink(p)
        except OSError:
            continue
        total -= size
        removed += 1
    if removed:
        _SHARDS_ROTATED.inc(removed)
    return removed


def flush(snapshot_too: bool = True,
          path: Optional[str] = None) -> Optional[str]:
    """The flight recorder: every event and span not yet flushed, plus (by
    default) one fresh ``{"kind": "snapshot"}`` record of all counters,
    into this process's shard under ``MXNET_TELEMETRY_DIR``. The shard is
    rewritten whole through a rename, so a kill mid-flush leaves the
    previous complete shard. A no-op returning None when the knob is
    unset. ``path`` overrides the shard file (tests)."""
    path = flight_recorder_path() if path is None else path
    if path is None:
        return None
    with _FLUSH_LOCK:
        with _EVT_LOCK:
            pending = [e for e in _EVENTS if e["seq"] > _FLUSH_SEQ[0]]
            if pending:
                _FLUSH_SEQ[0] = pending[-1]["seq"]
        pend_spans = [s for s in list(_SPANS)
                      if s.get("seq", 0) > _SPAN_FLUSH_SEQ[0]]
        if pend_spans:
            _SPAN_FLUSH_SEQ[0] = pend_spans[-1]["seq"]
        # earlier data lines survive the rewrite (meta and snapshot are
        # made fresh at each flush: only the newest matters)
        old: List[str] = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        kind = json.loads(line).get("kind")
                    except ValueError:
                        continue
                    if kind not in ("meta", "snapshot"):
                        old.append(line)
        except OSError:
            pass
        lines = old
        lines.extend(json.dumps(e, default=str) for e in pending)
        lines.extend(json.dumps({"kind": "span", **s}, default=str)
                     for s in pend_spans)
        cap = _shard_line_cap()
        if len(lines) > cap:
            lines = lines[-cap:]
        meta = {"kind": "meta", "pid": os.getpid(),
                "rank": _process_rank(),
                "t_us": time.monotonic_ns() // 1000,
                "counter_kinds": {n: m["kind"]
                                  for n, m in registered().items()}}
        directory = os.path.dirname(path)
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for line in lines:
                f.write(line + "\n")
            if snapshot_too:
                f.write(json.dumps({
                    "kind": "snapshot", "step": current_step(),
                    "t_us": time.monotonic_ns() // 1000,
                    "counters": snapshot()}, default=str) + "\n")
        os.replace(tmp, path)
        _rotate_shards(directory, keep=path)
    return path


# -- fleet merge ------------------------------------------------------------

def _read_shard(path: str) -> Dict[str, Any]:
    sh: Dict[str, Any] = {"path": path, "meta": {}, "snapshot": None,
                          "events": [], "spans": [], "skipped_lines": 0}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                sh["skipped_lines"] += 1      # a torn tail
                continue
            kind = rec.get("kind")
            if kind == "meta":
                sh["meta"] = rec
            elif kind == "snapshot":
                sh["snapshot"] = rec          # the last one wins
            elif kind == "span":
                sh["spans"].append(rec)
            else:
                sh["events"].append(rec)
    return sh


def merge(directory: str) -> Dict[str, Any]:
    """A directory of per-process shards folded into ONE fleet snapshot:
    cumulative and time counters sum across processes, gauges stay per
    process, and every event and span comes back stamped with its
    ``pid``, ``rank`` and ``shard``. Torn or mid-write files (``*.tmp``,
    invalid lines) are skipped, never fatal."""
    directory = os.path.expanduser(directory)
    shards: List[Dict[str, Any]] = []
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith("telemetry-") and fn.endswith(".jsonl")):
            continue
        try:
            shards.append(_read_shard(os.path.join(directory, fn)))
        except OSError:
            continue
    counters: Dict[str, Any] = {}
    gauges: Dict[str, Dict[str, Any]] = {}
    events_all: List[Dict[str, Any]] = []
    spans_all: List[Dict[str, Any]] = []
    processes: List[Dict[str, Any]] = []
    skipped = 0
    for sh in shards:
        name = os.path.basename(sh["path"])
        meta = sh["meta"]
        pid, rank = meta.get("pid"), meta.get("rank", 0)
        kinds = meta.get("counter_kinds", {})
        processes.append({"shard": name, "pid": pid, "rank": rank,
                          "events": len(sh["events"]),
                          "spans": len(sh["spans"]),
                          "skipped_lines": sh["skipped_lines"]})
        skipped += sh["skipped_lines"]
        snap = (sh["snapshot"] or {}).get("counters", {})
        for cname, val in snap.items():
            kind = kinds.get(cname, "cumulative")
            if kind == "gauge" or val is None:
                gauges.setdefault(cname, {})[name] = val
            else:
                counters[cname] = counters.get(cname, 0) + val
        for ev in sh["events"]:
            events_all.append(dict(ev, pid=pid, rank=rank, shard=name))
        for sp in sh["spans"]:
            spans_all.append(dict(sp, pid=pid, rank=rank, shard=name))
    events_all.sort(key=lambda e: e.get("t_us", 0))
    spans_all.sort(key=lambda s: s.get("t0_us", 0))
    return {
        "dir": directory,
        "shards": [os.path.basename(s["path"]) for s in shards],
        "processes": processes,
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "events": events_all,
        "spans": spans_all,
        "skipped_lines": skipped,
    }


def merge_chrome_trace(directory: str,
                       merged: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """One chrome trace over every process's shard: a lane per process
    (its ``pid`` and a ``process_name`` row naming the rank), spans as
    duration events, and spans that share a ``trace_id`` linked into one
    flow across processes."""
    m = merged if merged is not None else merge(directory)
    events: List[Dict[str, Any]] = []
    for proc in m["processes"]:
        pid = proc["pid"] if proc["pid"] is not None else proc["shard"]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {proc['rank']} "
                                        f"({proc['shard']})"}})
    flow_started: set = set()
    for sp in m["spans"]:
        pid = sp.get("pid") if sp.get("pid") is not None \
            else sp.get("shard")
        ev = {"name": sp["name"], "cat": sp["cat"], "ph": "X",
              "pid": pid, "tid": sp.get("thread", 0),
              "ts": sp["t0_us"], "dur": sp["dur_us"]}
        args = dict(sp.get("args") or {})
        if sp.get("trace_id"):
            args["trace_id"] = sp["trace_id"]
        if args:
            ev["args"] = args
        events.append(ev)
        tid = sp.get("trace_id")
        if tid:
            first = tid not in flow_started
            flow_started.add(tid)
            events.append({"name": f"trace:{tid}", "cat": "flow",
                           "ph": "s" if first else "t", "pid": pid,
                           "tid": sp.get("thread", 0), "ts": sp["t0_us"],
                           "id": _flow_id(tid)})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def report(prefix: Optional[str] = None, nonzero_only: bool = True) -> str:
    """The counter table (name, kind, value), grouped by top-level
    namespace."""
    snap = snapshot()
    kinds = registered()
    lines = [f"{'Counter':<52}{'Kind':>12}{'Value':>16}", "=" * 80]
    last_ns = None
    for name, val in snap.items():
        if prefix is not None and not name.startswith(prefix):
            continue
        if nonzero_only and not val:
            continue
        ns = name.split(".", 1)[0]
        if ns != last_ns:
            if last_ns is not None:
                lines.append("-" * 80)
            last_ns = ns
        kind = kinds.get(name, {}).get("kind", "?")
        if isinstance(val, float):
            lines.append(f"{name:<52}{kind:>12}{val:>16.3f}")
        else:
            lines.append(f"{name:<52}{kind:>12}{val!s:>16}")
    lines.append("=" * 80)
    lines.append(f"{len(snap)} declared counters; "
                 f"{len(events())} buffered events; "
                 f"{len(spans())} buffered spans")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI: python -m mxnet_tpu_torch.telemetry {report | trace <id> | merge <dir>}
# ---------------------------------------------------------------------------

def _merged_report(merged: Dict[str, Any],
                   prefix: Optional[str] = None) -> str:
    """The :func:`report` table over a fleet merge."""
    lines = [f"{'Counter (fleet sum)':<52}{'Value':>16}", "=" * 68]
    for name, val in merged["counters"].items():
        if prefix is not None and not name.startswith(prefix):
            continue
        if not val:
            continue
        if isinstance(val, float):
            lines.append(f"{name:<52}{val:>16.3f}")
        else:
            lines.append(f"{name:<52}{val!s:>16}")
    lines.append("=" * 68)
    lines.append(f"{len(merged['shards'])} shard(s): "
                 f"{', '.join(merged['shards']) or '-'}; "
                 f"{len(merged['events'])} events, "
                 f"{len(merged['spans'])} spans"
                 + (f"; {merged['skipped_lines']} torn line(s) skipped"
                    if merged["skipped_lines"] else ""))
    return "\n".join(lines)


def _trace_from_merge(merged: Dict[str, Any],
                      trace_id: str) -> Dict[str, Any]:
    """:func:`trace` stitched from a shard merge."""
    evs = [e for e in merged["events"] if e.get("trace_id") == trace_id]
    sps = [s for s in merged["spans"]
           if s.get("trace_id") == trace_id or
           trace_id in ((s.get("args") or {}).get("trace_ids") or ())]
    records = [dict(e, type="event") for e in evs]
    records += [dict(s, type="span", t_us=s["t0_us"]) for s in sps]
    records.sort(key=lambda r: (r["t_us"], r.get("seq", 0)))
    return {"trace_id": trace_id, "events": evs, "spans": sps,
            "records": records}


def main(argv: Optional[List[str]] = None) -> int:
    """Inspection without a script:

    - ``report [--dir D] [--prefix P]``: the counter table; with ``--dir``
      the fleet sum over that shard directory.
    - ``trace <id> [--dir D]``: one request's stitched lifecycle, from
      the in-process buffers or a shard directory.
    - ``merge <dir> [--json] [--chrome OUT]``: fold the shards into one
      snapshot; ``--json`` dumps the whole merge, ``--chrome`` writes the
      chrome trace with a lane per process.
    """
    import argparse

    p = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.telemetry",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="counter table")
    rp.add_argument("--dir", default=None,
                    help="shard directory (default: this process)")
    rp.add_argument("--prefix", default=None)
    tp = sub.add_parser("trace", help="one request's stitched lifecycle")
    tp.add_argument("trace_id")
    tp.add_argument("--dir", default=None,
                    help="shard directory (default: in-process buffers)")
    mp = sub.add_parser("merge", help="fold shards into one snapshot")
    mp.add_argument("dir")
    mp.add_argument("--json", action="store_true",
                    help="dump the full merge as JSON")
    mp.add_argument("--chrome", default=None, metavar="OUT",
                    help="also write the merged chrome trace here")
    a = p.parse_args(argv)
    if a.cmd == "report":
        if a.dir:
            print(_merged_report(merge(a.dir), prefix=a.prefix))
        else:
            print(report(prefix=a.prefix))
        return 0
    if a.cmd == "trace":
        tr = (_trace_from_merge(merge(a.dir), a.trace_id) if a.dir
              else trace(a.trace_id))
        print(json.dumps(tr, indent=2, default=str))
        return 0 if tr["records"] else 1
    merged = merge(a.dir)
    if a.chrome:
        with open(a.chrome, "w") as f:
            json.dump(merge_chrome_trace(a.dir, merged), f)
    if a.json:
        print(json.dumps(merged, default=str))
    else:
        print(_merged_report(merged))
    return 0


if __name__ == "__main__":          # pragma: no cover - CLI entry
    import sys as _sys

    _sys.exit(main())
