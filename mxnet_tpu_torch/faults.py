"""Deterministic fault injection and the shared retry/deadline policy.

Counterpart of ``mxnet_tpu/faults.py``, whole (host Python, no device
work): the error types (:class:`FaultInjected`, :class:`TransientFault`,
:class:`FatalFault`, :class:`DeadlineExceeded`, :class:`ShedError`),
:class:`FaultPlan` with :func:`install` / :func:`uninstall` /
:func:`active` and the injection hook :func:`inject` (one module-global
``None`` check when no plan is installed), the bounded event log
(:func:`record_event`, :func:`events`) and per-site counters
(:func:`counters`, in the telemetry registry under family
``faults.site``), :func:`reset`, the per-thread shared deadline budget
(:func:`deadline_scope`, :func:`deadline_remaining_us`), and the one
retry policy (:func:`is_retryable`, :func:`retry_call`: deterministic
exponential backoff, ``inject(site)`` before every attempt).

Pure operations retry; mutating operations fail fast. The serving engines
inject at ``serving.infer`` (the batched dispatch; failure falls back to
single requests) and ``serving.admit`` (admission; failure sheds), and
the preemption drain at ``preemption.drain``. The replica router
(``serving_router.py``, ``serving_remote.py``) registers three more:
``router.dispatch`` (every dispatch attempt, the failover retry loop),
``router.remote`` (every framed round trip to a remote replica, so a plan
can sever the wire without killing a process) and ``router.scale``
(every membership change: ``add_replica``, ``drain_replica``); they are
listed in :data:`SITES`. ``MXNET_FAULT_PLAN`` installs a plan at import,
for subprocess tests.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import config
from . import telemetry as _telemetry

__all__ = [
    "FaultInjected", "TransientFault", "FatalFault", "DeadlineExceeded",
    "ShedError",
    "FaultPlan", "install", "uninstall", "active", "inject", "retry_call",
    "is_retryable", "counters", "events", "record_event", "reset",
    "deadline_scope", "deadline_remaining_us", "deadline_site", "SITES",
]

# the named injection sites the port compiles in, each exercised by a test
SITES = ("serving.infer", "serving.admit", "preemption.drain",
         "engine.prefetch", "spmd.put", "checkpoint.write",
         "checkpoint.async", "checkpoint.restore", "elastic.step",
         "elastic.restore", "sentinel.rollback", "sentinel.quarantine",
         "router.dispatch", "router.remote", "router.scale",
         "cached_step.step", "trainer.step")


class FaultInjected(RuntimeError):
    """Base of every exception raised by an injection site."""


class TransientFault(FaultInjected):
    """Injected fault classified retryable (models preemption / flap)."""


class FatalFault(FaultInjected):
    """Injected fault classified NON-retryable (models a real bug)."""


class DeadlineExceeded(RuntimeError):
    """A retry loop or barrier ran out of wall-clock budget."""


class ShedError(RuntimeError):
    """Typed load-shed refusal (serving admission control, site
    ``serving.admit``; the replica router, site ``router.dispatch``):
    the request was rejected IMMEDIATELY — queue full, KV page pool
    exhausted, the SLO provably unmeetable, the process draining for
    preemption, every replica's circuit breaker open, or the request's
    own deadline budget spent — instead of queueing toward a timeout.
    Overload degrades loudly: callers see this exact type and can back
    off / route elsewhere; they never see a 300 s deadline breach.  NOT
    retryable by default (retrying into an overloaded server amplifies
    the overload).

    ``kind`` tags the refusal reason (``queue`` | ``pool`` | ``slo`` |
    ``draining`` | ``unavailable`` | ``deadline`` | ``None`` for legacy
    raisers) so callers can route on it without parsing the message —
    the machine-readable half of the docs/ROBUSTNESS.md shed contract:
    a ``draining`` shed means this process took a preemption notice
    (retry on another replica or after the restart, never here);
    ``unavailable`` means every serving replica is ejected (breaker
    open / dead) and the router refused rather than hang; ``deadline``
    means the request's ``deadline_us`` budget was exhausted across
    admission + queue + retries + hedges (resubmit with a bigger
    budget, or not at all)."""

    kind: Optional[str] = None

    def __init__(self, *args, kind: Optional[str] = None):
        super().__init__(*args)
        if kind is not None:
            self.kind = kind


# exception kinds a plan spec may name (MXNET_FAULT_PLAN "site:times:kind")
_KINDS: Dict[str, type] = {
    "transient": TransientFault,
    "fatal": FatalFault,
    "oserror": OSError,
    "timeout": TimeoutError,
}


class FaultPlan:
    """Deterministic schedule of injected faults, keyed by site.

    ``fail("ckpt.write", times=2)`` makes invocations 1..2 of that site
    raise :class:`TransientFault`; ``after=N`` shifts the window to
    invocations N+1..N+times.  Counting is per-plan (install a fresh plan
    — or :meth:`reset` — for a fresh schedule) and thread-safe.

    Env form (``MXNET_FAULT_PLAN``), for subprocess tests::

        site[@after]:times[:kind][,site...]   kind in {transient (default),
                                              fatal, oserror, timeout}

    e.g. ``MXNET_FAULT_PLAN="checkpoint.write:1,elastic.step@3:1"``.
    """

    def __init__(self):
        self._rules: Dict[str, List[Dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def fail(self, site: str, times: int = 1, exc: type = TransientFault,
             after: int = 0) -> "FaultPlan":
        if times < 1 or after < 0:
            raise ValueError(f"bad fault rule: times={times} after={after}")
        self._rules.setdefault(site, []).append(
            {"after": after, "times": times, "exc": exc, "seen": 0})
        return self

    @classmethod
    def from_env(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for term in spec.split(","):
            term = term.strip()
            if not term:
                continue
            parts = term.split(":")
            site, after = parts[0], 0
            if "@" in site:
                site, after_s = site.split("@", 1)
                after = int(after_s)
            times = int(parts[1]) if len(parts) > 1 else 1
            kind = parts[2].lower() if len(parts) > 2 else "transient"
            if kind not in _KINDS:
                raise ValueError(
                    f"MXNET_FAULT_PLAN kind {kind!r} unknown "
                    f"(one of {sorted(_KINDS)})")
            plan.fail(site, times=times, exc=_KINDS[kind], after=after)
        return plan

    def sites(self) -> List[str]:
        return sorted(self._rules)

    def reset(self) -> None:
        with self._lock:
            for rules in self._rules.values():
                for r in rules:
                    r["seen"] = 0

    def check(self, site: str) -> None:
        rules = self._rules.get(site)
        if not rules:
            return
        with self._lock:
            fire: Optional[Tuple[type, int]] = None
            for r in rules:
                r["seen"] += 1
                if fire is None and \
                        r["after"] < r["seen"] <= r["after"] + r["times"]:
                    fire = (r["exc"], r["seen"])
        if fire is not None:
            exc, n = fire
            _stats(site).inc("injected")
            record_event(site, "inject", invocation=n, kind=exc.__name__)
            raise exc(f"injected fault at site {site!r} (invocation {n})")


# -- module state ----------------------------------------------------------
_PLAN: Optional[FaultPlan] = None
# per-site counters live in the telemetry registry (family 'faults.site',
# names 'faults.<site>.<attempts|failures|retries|injected>'); _STATS
# caches the site -> CounterGroup views so counters() keeps returning
# plain-int dicts for exactly the sites seen since the last reset()
_STATS: Dict[str, "_telemetry.CounterGroup"] = {}
_EVENTS: "deque" = deque(
    maxlen=max(1, int(config.get("MXNET_FAULT_EVENTS"))))
_STATE_LOCK = threading.Lock()
_sleep = time.sleep          # patch point for tests (no real waiting)


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or, with ``None``, remove) the active plan."""
    global _PLAN
    _PLAN = plan


def uninstall() -> None:
    install(None)


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped installation for tests; restores the previous plan."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = prev


def inject(site: str) -> None:
    """Fault hook.  ZERO overhead when no plan is installed (one global
    ``None`` check) — safe on per-step hot paths."""
    if _PLAN is not None:
        _PLAN.check(site)


def _stats(site: str) -> "_telemetry.CounterGroup":
    s = _STATS.get(site)
    if s is None:
        with _STATE_LOCK:
            s = _STATS.get(site)
            if s is None:
                s = _STATS[site] = _telemetry.CounterGroup(
                    f"faults.{site}",
                    ("attempts", "failures", "retries", "injected"),
                    doc=f"fault-site {site!r} retry-policy counters",
                    family="faults.site")
                # a re-seen site after reset() starts from zero again
                # (counters() contract: reset forgets every site)
                s.reset()
    return s


def counters(site: Optional[str] = None) -> Dict:
    """Per-site ``{attempts, failures, retries, injected}`` counters
    (views over the telemetry registry, family ``faults.site``)."""
    if site is not None:
        return dict(_stats(site))
    return {k: dict(v) for k, v in _STATS.items()}


def record_event(site: str, action: str, error: Optional[BaseException] = None,
                 **extra) -> None:
    """Append a structured entry to the bounded event log (recovery paths
    outside :func:`retry_call` — e.g. checkpoint-restore degradation —
    log through this too).  Every entry also mirrors onto the telemetry
    event bus (kind ``fault``) where it picks up the current train-step
    index and monotonic timestamp — and, inside a request's
    ``telemetry.trace_scope`` (``retry_call`` runs on the request's own
    thread, so a routed request's retries/deadlines inherit its scope
    ambiently), both copies stamp the request's ``trace_id``."""
    ev: Dict[str, Any] = {"site": site, "action": action, "time": time.time()}
    if error is not None:
        ev["error"] = repr(error)
    trace_id = _telemetry.current_trace()
    if trace_id is not None:
        ev["trace_id"] = trace_id
    ev.update(extra)
    _EVENTS.append(ev)
    _telemetry.event("fault", site, action=action,
                     error=repr(error) if error is not None else None,
                     **extra)


def events(site: Optional[str] = None) -> List[Dict[str, Any]]:
    evs = list(_EVENTS)
    if site is not None:
        evs = [e for e in evs if e.get("site") == site]
    return evs


def reset() -> None:
    """Clear counters + events (and the active plan's invocation counts)."""
    with _STATE_LOCK:
        for g in _STATS.values():
            g.reset()               # zero the registry-backed values too
        _STATS.clear()
    _EVENTS.clear()
    if _PLAN is not None:
        _PLAN.reset()


# -- shared deadline budget -------------------------------------------------
# One wall-clock budget per request, threaded through every nested
# retried site instead of multiplying per-site timeouts: the OUTERMOST
# deadline_scope (or retry_call(deadline_us=)) pins an absolute
# monotonic expiry on this thread; nested scopes can only NARROW it,
# and every retry_call underneath draws backoff from the same remaining
# budget.  Exhaustion raises DeadlineExceeded naming the OUTERMOST
# site — the one whose budget it really was.
_DEADLINE = threading.local()


def _deadline_state() -> Optional[Tuple[float, str]]:
    """(absolute monotonic expiry, outermost site) or None."""
    return getattr(_DEADLINE, "state", None)


def deadline_remaining_us() -> Optional[int]:
    """Microseconds left in this thread's ambient deadline budget
    (negative once spent), or ``None`` when no budget is set.  Queue
    waits and admission checks inside a budget consult this instead of
    inventing their own timeout."""
    st = _deadline_state()
    if st is None:
        return None
    return int((st[0] - time.monotonic()) * 1e6)


def deadline_site() -> Optional[str]:
    """The outermost site that owns the ambient budget (exception
    attribution), or None."""
    st = _deadline_state()
    return None if st is None else st[1]


@contextlib.contextmanager
def deadline_scope(deadline_us: Optional[int] = None, *, site: str,
                   until: Optional[float] = None):
    """Establish (or narrow) the thread's shared deadline budget.

    ``deadline_us`` is relative to now; ``until`` is an absolute
    ``time.monotonic()`` expiry (for carrying ONE request budget across
    threads — stamp the absolute expiry on the request at admission and
    re-enter the scope on whichever thread dispatches it).  An
    enclosing budget that is already tighter wins, and the OUTERMOST
    scope's ``site`` owns every :class:`DeadlineExceeded` raised
    underneath.  With neither argument the scope is a no-op
    passthrough."""
    prev = _deadline_state()
    if until is None:
        if deadline_us is None:
            yield prev
            return
        until = time.monotonic() + deadline_us / 1e6
    if prev is not None:
        until = min(until, prev[0])
        site = prev[1]
    _DEADLINE.state = (until, site)
    try:
        yield _DEADLINE.state
    finally:
        _DEADLINE.state = prev


def _check_deadline(site: str, last_error: Optional[BaseException] = None,
                    about_to_sleep: float = 0.0) -> None:
    """Raise DeadlineExceeded (named after the OUTERMOST site) when the
    ambient budget is spent — or would be spent by sleeping
    ``about_to_sleep`` more seconds."""
    st = _deadline_state()
    if st is None:
        return
    remaining = st[0] - time.monotonic()
    if remaining - about_to_sleep > 0:
        return
    record_event(site, "deadline", last_error,
                 budget_site=st[1], remaining_us=int(remaining * 1e6))
    msg = (f"site {st[1]!r}: shared deadline budget exhausted"
           + (f" at nested site {site!r}" if site != st[1] else "")
           + (f"; last error: {last_error!r}" if last_error is not None
              else ""))
    if last_error is not None:
        raise DeadlineExceeded(msg) from last_error
    raise DeadlineExceeded(msg)


# -- retryable classification ---------------------------------------------
# multiprocessing.TimeoutError subclasses neither OSError nor TimeoutError
import multiprocessing as _mp  # noqa: E402  (stdlib, cheap)

RETRYABLE_DEFAULT: Tuple[type, ...] = (
    TransientFault, OSError, TimeoutError, ConnectionError,
    _mp.TimeoutError, queue.Empty,
)


def is_retryable(exc: BaseException) -> bool:
    """Default classification: transient-looking errors (IO, timeouts,
    injected :class:`TransientFault`) retry; everything else — and any
    :class:`FatalFault` — fails fast."""
    if isinstance(exc, FatalFault):
        return False
    return isinstance(exc, RETRYABLE_DEFAULT)


def retry_call(fn: Callable, *args,
               site: str,
               retries: Optional[int] = None,
               backoff: Optional[float] = None,
               max_backoff: Optional[float] = None,
               deadline: Optional[float] = None,
               deadline_us: Optional[int] = None,
               retryable: Optional[Callable[[BaseException], bool]] = None,
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)`` under the shared retry policy.

    - ``retries``: max re-attempts after the first try (total attempts =
      retries + 1); default ``MXNET_RETRY_MAX``.
    - ``backoff``/``max_backoff``: deterministic exponential delay
      ``min(backoff * 2**(attempt-1), max_backoff)`` between attempts;
      defaults ``MXNET_RETRY_BACKOFF`` / ``MXNET_RETRY_BACKOFF_MAX``.
    - ``deadline``: legacy per-call wall-clock budget (seconds);
      breaching it raises :class:`DeadlineExceeded` chained to the last
      error.
    - ``deadline_us``: the SHARED budget (see :func:`deadline_scope`) —
      one wall clock across this site AND every retried site nested
      under it: each attempt and each backoff sleep draws from the same
      remaining budget (backoff is truncated to it), and exhaustion
      raises :class:`DeadlineExceeded` naming the OUTERMOST site.  An
      ambient scope established by a caller is inherited (and only ever
      narrowed) whether or not this call passes its own value — this is
      what fixes nested-retry timeout multiplication.
    - ``retryable``: predicate overriding :func:`is_retryable`.

    ``inject(site)`` runs before every attempt, so a :class:`FaultPlan`
    targeting ``site`` exercises exactly this recovery path.  After the
    budget is spent the LAST underlying exception re-raises unchanged —
    callers' ``except`` clauses see the same types as without retry.
    """
    with deadline_scope(deadline_us, site=site):
        return _retry_loop(fn, args, kwargs, site, retries, backoff,
                           max_backoff, deadline, retryable, on_retry)


def _retry_loop(fn, args, kwargs, site, retries, backoff, max_backoff,
                deadline, retryable, on_retry):
    retries = config.get("MXNET_RETRY_MAX") if retries is None else retries
    backoff = config.get("MXNET_RETRY_BACKOFF") if backoff is None else backoff
    max_backoff = (config.get("MXNET_RETRY_BACKOFF_MAX")
                   if max_backoff is None else max_backoff)
    check = is_retryable if retryable is None else retryable
    stats = _stats(site)
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        _check_deadline(site)            # budget spent: never attempt
        stats.inc("attempts")
        try:
            inject(site)
            return fn(*args, **kwargs)
        except BaseException as e:
            stats.inc("failures")
            if not check(e) or attempt > retries:
                record_event(site, "raise", e, attempt=attempt)
                raise
            delay = min(backoff * (2 ** (attempt - 1)), max_backoff)
            if deadline is not None and \
                    time.monotonic() - start + delay > deadline:
                record_event(site, "deadline", e, attempt=attempt)
                raise DeadlineExceeded(
                    f"site {site!r}: {deadline}s deadline exceeded after "
                    f"{attempt} attempt(s); last error: {e!r}") from e
            # the SHARED budget: a backoff that would sleep past the
            # remaining budget raises instead (truncation to zero is a
            # loud DeadlineExceeded, never a silent overrun)
            _check_deadline(site, last_error=e, about_to_sleep=delay)
            stats.inc("retries")
            record_event(site, "retry", e, attempt=attempt, delay=delay)
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                _sleep(delay)


# -- env-driven installation (subprocess tests) ----------------------------
_spec = config.get("MXNET_FAULT_PLAN")
if _spec:
    install(FaultPlan.from_env(_spec))
del _spec
