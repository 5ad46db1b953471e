"""The engine's drain surface.

Counterpart of ``mxnet_tpu/engine.py`` :54-155: :func:`engine_type`
(``MXNET_ENGINE_TYPE``), :func:`is_naive`, :func:`prefetch_depth`
(``MXNET_ENGINE_PREFETCH``, 0 under ``NaiveEngine``), and the drainable
registry: every object with outstanding asynchronous host-side work (the
serving engines' queues) registers itself (:func:`register_drainable`,
weakly held), and :func:`waitall` drains them all and then synchronizes
the device, the reference's ``MXEngineWaitAll`` semantics ("block until
every pushed async op completed"); the synchronization waits for any
capture in flight (``program_store.synchronize``).

Not ported yet (ROADMAP A7): ``DevicePrefetcher`` / ``prefetch``,
``bulk`` / ``set_bulk_size``, ``naive_sync`` and ``amp_lag``, and the
flight-recorder flush at the end of ``waitall``.
"""
from __future__ import annotations

import weakref

import torch

from . import config as _config
from . import program_store as _pstore
from . import telemetry as _telemetry

__all__ = ["engine_type", "is_naive", "prefetch_depth",
           "register_drainable", "drainable_count", "waitall"]

# weakly held: a dropped engine unregisters itself by dying
_DRAINABLES: "weakref.WeakSet" = weakref.WeakSet()


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
    "live drainable registrations (serving and decode engine queues)")


def waitall() -> None:
    """Block until all outstanding asynchronous work completes: drain
    every registered object (errors it absorbed surface here), then
    synchronize the device when CUDA is in use."""
    for obj in list(_DRAINABLES):
        drain = getattr(obj, "drain", None)
        if drain is not None:
            drain()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _pstore.synchronize()
