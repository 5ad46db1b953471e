"""``mx.profiler``: tracing and profiling (counterpart of
``mxnet_tpu/profiler.py``; reference ``python/mxnet/profiler.py:34-407``).

Two layers, as in the reference:

1. the device: with ``set_config(device_trace_dir=...)`` (the reference's
   ``xla_trace_dir`` is taken under its own name too) ``set_state("run")``
   starts a ``torch.profiler`` session over the CPU and, where there is
   one, the CUDA device, and ``set_state("stop")`` writes its chrome
   trace there (``trace-p<pid>.json``). :func:`device_events` returns the
   device kernels that session saw, with the times ``torch.profiler``
   measured; :func:`dump` adds them to the host trace on a lane of their
   own. No device time is derived from the host clock.
2. the host: user scopes (:class:`Task`, :class:`Frame`, :class:`Event`,
   :class:`Marker`, :class:`Counter`, :class:`scope`), every imperative
   op's dispatch (``ndarray.invoke`` calls :func:`record_op` while
   collection runs with ``profile_imperative``) and the telemetry spans
   are recorded into an in-process buffer and dumped as chrome-trace JSON
   (:func:`dump` / :func:`dumps`).

:class:`StepTimeline` splits a train loop's host time per step into the
phases ``h2d``, ``dispatch``, ``read`` and ``host-gap``;
``device_idle_gap_us``, the host time per step outside ``dispatch``, is the
pipeline's headline gauge (with one captured program a step, whatever the
host does between dispatches is the window in which the device can run
dry). :func:`memory_summary` lists a block's parameters by name beside the
caching allocator's ``torch.cuda.memory_stats``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

__all__ = ["set_config", "set_state", "state", "pause", "resume", "dump",
           "dumps", "Task", "Frame", "Event", "Counter", "Marker", "scope",
           "StepTimeline", "memory_summary", "device_events"]

_LOCK = threading.Lock()
_CONFIG = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": True,
    "aggregate_stats": False,
    "device_trace_dir": None,
}
_RUNNING = False
_PAUSED = False
_EVENTS: List[dict] = []
_DEVICE = {"session": None, "events": []}


def set_config(**kwargs):
    """Configure the profiler (reference ``set_config``). Unknown keys are
    accepted, as the reference accepts them."""
    for k, v in kwargs.items():
        if k in ("filename", "file_name"):
            _CONFIG["filename"] = v
        elif k == "xla_trace_dir":
            _CONFIG["device_trace_dir"] = v
        elif k in _CONFIG:
            _CONFIG[k] = v


def state():
    return "run" if (_RUNNING and not _PAUSED) else "stop"


def _start_device_trace() -> None:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sess = profile(activities=acts)
    sess.__enter__()
    _DEVICE["session"] = sess


def _stop_device_trace() -> None:
    sess, _DEVICE["session"] = _DEVICE["session"], None
    if sess is None:
        return
    sess.__exit__(None, None, None)
    out = []
    for e in sess.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append({"name": e.name, "ts": e.time_range.start,
                        "dur": e.time_range.end - e.time_range.start})
    _DEVICE["events"] = out
    tdir = _CONFIG["device_trace_dir"]
    if tdir:
        os.makedirs(tdir, exist_ok=True)
        sess.export_chrome_trace(os.path.join(tdir,
                                              f"trace-p{os.getpid()}.json"))


def set_state(state_name="stop"):
    """``'run'`` starts collection (and the device trace when
    ``device_trace_dir`` is set); ``'stop'`` ends it."""
    global _RUNNING
    if state_name == "run":
        _RUNNING = True
        with _LOCK:
            _EVENTS.clear()
        if _CONFIG["device_trace_dir"] and _DEVICE["session"] is None:
            _start_device_trace()
    elif state_name == "stop":
        _RUNNING = False
        _stop_device_trace()
    else:
        raise ValueError("state must be 'run' or 'stop'")


def pause(profile_process="worker"):
    global _PAUSED
    _PAUSED = True


def resume(profile_process="worker"):
    global _PAUSED
    _PAUSED = False


def ops_active() -> bool:
    """True when imperative op dispatches should be recorded."""
    return _RUNNING and not _PAUSED and _CONFIG["profile_imperative"]


def record_op(name: str, t0_ns: int, t1_ns: int) -> None:
    """One imperative op's dispatch bracket (called by ``ndarray.invoke``;
    the host's dispatch time, the asynchronous counterpart of the
    reference's operator-execution record)."""
    _emit(name, "operator", "X", ts=t0_ns // 1000,
          dur=max((t1_ns - t0_ns) // 1000, 1))


def _emit(name, cat, ph, ts=None, dur=None, args=None, flow_id=None):
    if not _RUNNING or _PAUSED:
        return
    ev = {"name": name, "cat": cat, "ph": ph, "pid": os.getpid(),
          "tid": threading.get_ident(),
          "ts": (time.perf_counter_ns() // 1000) if ts is None else ts}
    if dur is not None:
        ev["dur"] = dur
    if args is not None:
        ev["args"] = args
    if flow_id is not None:
        ev["id"] = flow_id
    with _LOCK:
        _EVENTS.append(ev)


def device_events() -> List[dict]:
    """The device kernels of the last device trace: ``{"name", "ts",
    "dur"}`` in microseconds, as ``torch.profiler`` measured them."""
    return list(_DEVICE["events"])


def _trace_events() -> List[dict]:
    with _LOCK:
        events = list(_EVENTS)
    lane = f"device ({os.getpid()})"
    events += [{"name": e["name"], "cat": "device", "ph": "X", "pid": lane,
                "tid": 0, "ts": e["ts"], "dur": e["dur"]}
               for e in _DEVICE["events"]]
    return events


def dumps(reset=False, format="table") -> str:
    """Aggregate table of the recorded durations (reference
    ``DumpAggregate``); ``format`` is ``'table'`` or ``'json'``.
    ``reset=True`` clears the trace-event buffer only: declared counters
    keep their values."""
    if format not in ("table", "json"):
        raise ValueError("format must be 'table' or 'json'")
    events = _trace_events()
    if reset:
        with _LOCK:
            _EVENTS.clear()
    if format == "json":
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
    agg: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        if ev["ph"] == "X":
            agg[ev["name"]].append(ev.get("dur", 0) / 1000.0)
    lines = [f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"
             f"{'Max(ms)':>12}"]
    lines.append("=" * 84)
    for name, durs in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"{name[:39]:<40}{len(durs):>8}{sum(durs):>12.3f}"
                     f"{sum(durs) / len(durs):>12.3f}{max(durs):>12.3f}")
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write the chrome trace (reference ``DumpProfile``); returns its
    path."""
    with open(_CONFIG["filename"], "w") as f:
        json.dump({"traceEvents": _trace_events(),
                   "displayTimeUnit": "ms"}, f)
    return _CONFIG["filename"]


class _DurationScope:
    """A duration event (reference ``Task`` / ``Frame``)."""

    _cat = "user"

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter_ns()
        return self

    def stop(self):
        if self._t0 is None:
            return
        dur = (time.perf_counter_ns() - self._t0) // 1000
        _emit(self.name, self._cat, "X", ts=self._t0 // 1000, dur=dur)
        self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Task(_DurationScope):
    _cat = "task"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Frame(_DurationScope):
    _cat = "frame"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Event(_DurationScope):
    _cat = "event"


class Marker:
    """Instant marker (reference ``Marker``)."""

    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        _emit(self.name, "marker", "i")


class Counter:
    """Named counter series (reference ``Counter``), held in the telemetry
    registry as ``profiler.<name>``: it survives a trace-buffer reset, and
    a new ``Counter("x")`` resumes where the last one left off."""

    def __init__(self, name, domain=None, value=None):
        from . import telemetry as _telemetry

        self.name = name
        self._c = _telemetry.counter(
            f"profiler.{name}", "user profiler counter series",
            kind="gauge", family="profiler.user")
        if value is not None:
            self.set_value(value)

    @property
    def _value(self):
        return self._c.value

    def set_value(self, value):
        self._c.set(value)
        _emit(self.name, "counter", "C", args={self.name: value})

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class scope:
    """A named profiler scope (reference ``profiler.scope``)."""

    def __init__(self, name="<unk>:", append_mode=False):
        self._name = name

    def __enter__(self):
        _emit(self._name, "scope", "B")
        return self

    def __exit__(self, *exc):
        _emit(self._name, "scope", "E")


# ---------------------------------------------------------------------------
# per-step phase timeline (the pipeline's host-gap meter)
# ---------------------------------------------------------------------------

class StepTimeline:
    """Per-step phases of a train loop's host side: ``h2d`` (taking the
    next batch, its staging or copy), ``dispatch`` (enqueueing the
    captured step), ``read`` (host value reads: metric folds, a loss
    print), and ``host-gap`` (the rest between two steps). Each phase is a
    telemetry span (category ``step_phase``), so it lands in the span
    buffer and, while the profiler runs, in its chrome trace; the sums
    are kept here too, so a loop can use a timeline without the global
    collection.

    ``device_idle_gap_us`` is the mean host time per step spent outside
    the dispatch phase. Usage::

        tl = profiler.StepTimeline()
        for batch in loader:
            with tl.phase("h2d"):
                x, y = stage(batch)
            with tl.phase("dispatch"):
                loss = step(x, y)
            tl.step()            # close the step (the rest is host-gap)
        print(tl.summary())
    """

    PHASES = ("h2d", "dispatch", "host-gap", "read")

    def __init__(self, name: str = "step"):
        self.name = name
        self.steps = 0
        self.phase_ns: Dict[str, int] = defaultdict(int)
        self._step_ns = 0
        self._step_t0: Optional[int] = None
        self._accounted_ns = 0

    class _Phase:
        __slots__ = ("_tl", "_name", "_t0")

        def __init__(self, tl, name):
            self._tl = tl
            self._name = name

        def __enter__(self):
            if self._tl._step_t0 is None:
                self._tl._step_t0 = time.perf_counter_ns()
            self._t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            t1 = time.perf_counter_ns()
            dur = t1 - self._t0
            self._tl.phase_ns[self._name] += dur
            self._tl._accounted_ns += dur
            from . import telemetry as _telemetry

            _telemetry.record_span(
                f"{self._tl.name}:{self._name}", "step_phase",
                self._t0, t1)

    def phase(self, name: str) -> "_Phase":
        return self._Phase(self, name)

    def step(self) -> None:
        """Close one step: the time since the step began that no phase
        took is the host-gap."""
        now = time.perf_counter_ns()
        if self._step_t0 is not None:
            wall = now - self._step_t0
            gap = max(0, wall - self._accounted_ns)
            self.phase_ns["host-gap"] += gap
            self._step_ns += wall
        self._accounted_ns = 0
        self._step_t0 = now
        self.steps += 1

    def summary(self) -> Dict[str, object]:
        steps = max(self.steps, 1)
        phase_us = {k: round(v / 1000.0 / steps, 1)
                    for k, v in sorted(self.phase_ns.items())}
        non_dispatch = sum(v for k, v in self.phase_ns.items()
                           if k != "dispatch")
        return {
            "steps": self.steps,
            "phase_us_per_step": phase_us,
            "wall_us_per_step": round(self._step_ns / 1000.0 / steps, 1),
            "device_idle_gap_us": round(non_dispatch / 1000.0 / steps, 1),
        }


def _maybe_autostart():
    from . import config

    if config.get("MXNET_PROFILER_AUTOSTART"):
        set_state("run")


_maybe_autostart()


# ---------------------------------------------------------------------------
# memory attribution
# ---------------------------------------------------------------------------

def memory_summary(block=None, device=None, top=20) -> str:
    """A block's parameter and gradient tensors by name (the reference's
    storage-profiler attribution, ``storage_profiler.h:131``), largest
    first, beside the caching allocator's totals for each CUDA device in
    use (``torch.cuda.memory_stats``: allocated now and at peak, reserved),
    and the allocated bytes no named tensor accounts for. ``device``
    (a string such as ``"cuda:0"`` or ``"cpu"``) keeps only its tensors;
    ``top`` is the reference's cap on anonymous rows; every row here is
    named, and named rows always print."""
    rows = []
    if block is not None:
        for n, p in block.collect_params().items():
            t = getattr(p, "_data", None)
            if not isinstance(t, torch.Tensor):
                continue
            for name, x in ((n, t), (f"{n}.grad", t.grad)):
                if x is None or (device is not None
                                 and str(device) not in str(x.device)):
                    continue
                rows.append((x.numel() * x.element_size(), name,
                             tuple(x.shape), str(x.dtype).replace(
                                 "torch.", ""), str(x.device)))
    rows.sort(reverse=True)
    named = sum(r[0] for r in rows)
    lines = [f"{'bytes':>14}  {'name':<36} shape dtype device"]
    for nbytes, name, shape, dtype, dev in rows:
        lines.append(f"{nbytes:>14}  {name:<36} {shape} {dtype} {dev}")
    lines.append(f"{named:>14}  TOTAL named ({len(rows)} tensors)")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            if device is not None and str(device) not in (f"cuda:{i}",
                                                          "cuda"):
                continue
            st = torch.cuda.memory_stats(i)
            alloc = int(st.get("allocated_bytes.all.current", 0))
            lines.append(
                f"{alloc:>14}  TOTAL allocated on cuda:{i} (peak "
                f"{int(st.get('allocated_bytes.all.peak', 0))}, reserved "
                f"{int(st.get('reserved_bytes.all.current', 0))}, not "
                f"named {max(0, alloc - named)})")
    return "\n".join(lines)
