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

Not ported yet (ROADMAP A7): the flight recorder (``flush``,
``flight_recorder_path``), the fleet ``merge`` and ``merge_chrome_trace``,
the chrome-trace export through the profiler, ``report`` and the ``main``
CLI (reference :715-1109).
"""
from __future__ import annotations

import os
import threading
import time
import weakref
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
]

# one lock guards registry structure and every counter value: increments
# are atomic, and a snapshot taken under it never sees a torn update
_LOCK = threading.RLock()

KINDS = ("cumulative", "gauge", "time")


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
_SPANS_SEQ = [0]
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
