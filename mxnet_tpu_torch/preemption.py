"""Preemption survival: the SIGTERM "preemption notice" -> graceful drain.

Counterpart of ``mxnet_tpu/preemption.py``, whole:

1. :func:`install` registers SIGTERM/SIGINT handlers. On the first signal
   :func:`notice` flips the process-wide draining flag (:func:`draining`;
   the computed telemetry gauge ``preemption.draining``), emits a
   ``drain`` event, and arms a grace watchdog
   (``MXNET_PREEMPTION_GRACE_S``) that force-exits if the drain wedges.
2. The draining flag stops new work at every admission edge: the serving
   engines refuse new requests with a typed :class:`faults.ShedError` of
   kind ``draining``, never a timeout.
3. :func:`drain` runs ``engine.waitall()`` (the serving and decode queues
   flush, then the device synchronizes), then the :func:`on_drain` hooks;
   its duration lands in the ``preemption.drain_s`` counter.
4. The process exits with ``MXNET_PREEMPTION_EXIT_CODE`` (default 83) by
   raising :class:`Preempted` (a ``SystemExit``) in the main thread, so
   ``finally`` blocks still run; a drain that failed exits 1, and a second
   signal while draining exits at once.

``notice()`` is callable directly, ``install(exit_fn=...)`` lets a test
observe the exit instead of dying, and the ``preemption.drain`` injection
site fires at the start of every drain. The telemetry flight recorder is
flushed before every exit (``telemetry.flush``, a no-op unless
``MXNET_TELEMETRY_DIR`` is set), as in the reference.

Inside :func:`cooperative` (``parallel.elastic.run_elastic`` with
preemption enters it) a notice only sets the draining flag, emits its
event and arms the watchdog: the loop, whose steps update state in place,
drains at its next step boundary through
:func:`finish_cooperative_drain` (the same drain, hooks and exit). A
signal handler runs between bytecodes of the main thread, anywhere in a
step; only the loop knows where a step ends.
"""
from __future__ import annotations

import logging
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["Preempted", "install", "uninstall", "installed", "draining",
           "notice", "drain", "on_drain", "remove_drain_hook", "reset",
           "exit_code", "grace_s", "cooperative",
           "finish_cooperative_drain"]

_LOG = logging.getLogger("mxnet_tpu_torch.preemption")


class Preempted(SystemExit):
    """The distinguished exit of a SUCCESSFUL graceful drain: raised in
    the main thread after the final checkpoint landed, so an uncaught
    one exits the process with ``MXNET_PREEMPTION_EXIT_CODE`` while
    ``finally`` blocks still run.  ``.code`` carries the exit code."""


# -- counters ---------------------------------------------------------------
_NOTICES = _telemetry.counter(
    "preemption.notices",
    "preemption notices taken (SIGTERM/SIGINT caught by the installed "
    "handler, or notice() called directly)")
_DRAIN_S = _telemetry.counter(
    "preemption.drain_s",
    "seconds the most recent graceful drain took (waitall + final "
    "checkpoint hooks)", kind="time")

# -- process-wide state -----------------------------------------------------
_DRAINING = threading.Event()
_LOCK = threading.Lock()
_STATE: Dict[str, object] = {
    "installed": False,
    "prev_handlers": {},        # signum -> previous handler
    "grace_s": None,            # install-time override, else knob
    "exit_code": None,          # install-time override, else knob
    "exit_fn": None,            # install-time override, else raise
    "watchdog": None,           # armed threading.Timer
    "cooperative": 0,           # depth of cooperative() scopes
}
_DRAIN_HOOKS: List[Callable[[], None]] = []

_telemetry.gauge_fn(
    "preemption.draining", lambda: int(_DRAINING.is_set()),
    "1 while the process is draining after a preemption notice "
    "(admission edges shed, prefetch stops staging)")


def draining() -> bool:
    """True once a preemption notice was taken: admission edges must
    refuse new work (typed ``ShedError`` kind ``draining``) and staging
    loops should wind down.  One Event read — hot-path safe."""
    return _DRAINING.is_set()


def installed() -> bool:
    return bool(_STATE["installed"])


def grace_s() -> float:
    """Effective grace budget (install override, else the knob)."""
    g = _STATE["grace_s"]
    return float(_config.get("MXNET_PREEMPTION_GRACE_S")
                 if g is None else g)


def exit_code() -> int:
    """Effective distinguished exit code (install override, else the
    knob)."""
    c = _STATE["exit_code"]
    return int(_config.get("MXNET_PREEMPTION_EXIT_CODE")
               if c is None else c)


def install(grace_s: Optional[float] = None,
            exit_code: Optional[int] = None,
            signals: Optional[tuple] = None,
            exit_fn: Optional[Callable[[int], None]] = None) -> None:
    """Install the preemption-notice signal handlers (idempotent;
    re-installing updates the overrides).

    ``grace_s`` / ``exit_code`` override the ``MXNET_PREEMPTION_GRACE_S``
    / ``MXNET_PREEMPTION_EXIT_CODE`` knobs for this process.  ``signals``
    defaults to ``(SIGTERM, SIGINT)``.  ``exit_fn(code)`` replaces the
    default exit (raising :class:`Preempted` in the main thread) — the
    in-process test hook; the grace watchdog always uses ``os._exit``
    (it runs off the main thread, where raising cannot work).  Must be
    called from the main thread (CPython delivers signals there)."""
    with _LOCK:
        _STATE["grace_s"] = grace_s
        _STATE["exit_code"] = exit_code
        _STATE["exit_fn"] = exit_fn
        if not _STATE["installed"]:
            prev: Dict[int, object] = {}
            for sig in signals or (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, notice)
            _STATE["prev_handlers"] = prev
            _STATE["installed"] = True


def uninstall() -> None:
    """Restore the pre-install signal handlers and clear the hooks +
    draining flag (tests)."""
    with _LOCK:
        for sig, h in dict(_STATE["prev_handlers"]).items():
            try:
                signal.signal(sig, h)
            except (ValueError, TypeError, OSError):
                pass
        _STATE["prev_handlers"] = {}
        _STATE["installed"] = False
    reset()
    del _DRAIN_HOOKS[:]


def reset() -> None:
    """Clear the draining flag and disarm the watchdog (tests — a unit
    test that took a notice must not leave every admission edge in the
    process shedding)."""
    _DRAINING.clear()
    wd = _STATE["watchdog"]
    _STATE["watchdog"] = None
    if wd is not None:
        wd.cancel()


def on_drain(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a hook run AFTER ``engine.waitall()`` during the drain —
    the final-blocking-checkpoint slot (``run_elastic(preemption=...)``
    registers its save here).  Hooks run in registration order; a hook
    exception fails the drain (exit degrades to 1).  Returns ``fn`` so
    the caller can :func:`remove_drain_hook` it."""
    _DRAIN_HOOKS.append(fn)
    return fn


def remove_drain_hook(fn: Callable[[], None]) -> None:
    try:
        _DRAIN_HOOKS.remove(fn)
    except ValueError:
        pass


def drain() -> float:
    """Run the graceful drain NOW: the ``preemption.drain`` injection
    site, ``engine.waitall()`` (the serving/decode queues; admission
    edges already shed because :func:`draining` is set), then every
    :func:`on_drain` hook.  Returns the elapsed seconds (also set on
    the ``preemption.drain_s`` counter).  Raises on failure — the
    caller (:func:`notice`) degrades the exit code."""
    from . import engine as _engine
    from . import faults as _faults

    t0 = time.monotonic()
    _faults.inject("preemption.drain")
    _engine.waitall()
    for fn in list(_DRAIN_HOOKS):
        fn()
    secs = time.monotonic() - t0
    _DRAIN_S.set(secs)
    _telemetry.event("drain", "preemption", phase="complete",
                     drain_s=round(secs, 6))
    return secs


def _flush_telemetry() -> None:
    try:
        _telemetry.flush()
    except OSError:
        pass


class cooperative:
    """A scope in which a notice only flags the drain; the loop inside it
    calls :func:`finish_cooperative_drain` at a step boundary."""

    def __enter__(self):
        with _LOCK:
            _STATE["cooperative"] += 1
        return self

    def __exit__(self, *exc):
        with _LOCK:
            _STATE["cooperative"] -= 1
        return False


def finish_cooperative_drain() -> None:
    """The second half of a notice (at once outside :func:`cooperative`,
    at the loop's step boundary inside it): run :func:`drain`
    (``engine.waitall()``, then the hooks), disarm the watchdog and exit
    with the distinguished code (1 when the drain failed)."""
    code = exit_code()
    try:
        drain()
    except BaseException as e:
        from . import faults as _faults

        _faults.record_event("preemption.drain", "drain_failed", e)
        _LOG.error("preemption drain FAILED (%r); exiting 1 — do not "
                   "trust the newest checkpoint beyond its digest", e)
        code = 1
    finally:
        wd = _STATE["watchdog"]
        _STATE["watchdog"] = None
        if wd is not None:
            wd.cancel()
    _do_exit(code)


def _do_exit(code: int) -> None:
    _flush_telemetry()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except (OSError, ValueError):
        pass
    fn = _STATE["exit_fn"]
    if fn is not None:
        fn(code)
        return
    raise Preempted(code)


def _force_exit() -> None:
    """Grace-watchdog expiry: the drain wedged past the budget.  Runs
    off the main thread, so it cannot raise there — ``os._exit`` with
    exit_code + 1 (distinguished-but-degraded: the checkpoint may be
    stale).  An ``exit_fn`` override (tests) is honored instead."""
    if not _DRAINING.is_set():
        return
    code = exit_code() + 1
    _LOG.error("preemption drain exceeded the %.1fs grace budget; "
               "force-exiting %d", grace_s(), code)
    _telemetry.event("drain", "preemption", phase="grace_exceeded",
                     grace_s=grace_s())
    _flush_telemetry()
    fn = _STATE["exit_fn"]
    if fn is not None:
        fn(code)
        return
    os._exit(code)


def notice(signum: Optional[int] = None, frame: object = None) -> None:
    """The preemption-notice handler (also directly callable — tests and
    drills trigger it without a real signal).

    First notice: flip the draining flag, emit the ``drain`` event
    (stamped with the current train-step index), arm the grace
    watchdog, run :func:`drain`, then exit with the distinguished code
    (drain failure exits 1 instead); inside :func:`cooperative` the
    drain and the exit wait for the loop's step boundary.  A second
    notice while draining exits immediately — the supervisor
    escalated."""
    _NOTICES.inc()
    first = not _DRAINING.is_set()
    _DRAINING.set()
    if not first:
        _LOG.warning("second preemption notice while draining; "
                     "exiting immediately")
        _do_exit(exit_code())
        return
    g = grace_s()
    _telemetry.event("drain", "preemption", phase="notice",
                     sig=int(signum) if signum is not None else None,
                     grace_s=g)
    _LOG.warning("preemption notice (sig=%s): draining (grace %.1fs)",
                 signum, g)
    wd = None
    if g > 0:
        wd = threading.Timer(g, _force_exit)
        wd.daemon = True
        wd.start()
        _STATE["watchdog"] = wd
    if _STATE["cooperative"] > 0:
        return                 # the loop drains at its next step boundary
    finish_cooperative_drain()
