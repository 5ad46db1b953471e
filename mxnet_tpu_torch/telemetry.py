"""Named counters.

Counterpart of ``mxnet_tpu/telemetry.py``, of which the port so far needs
only ``counter(name, help)``: a process-wide, idempotently declared counter
with ``.inc()`` and ``.value``.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["Counter", "counter"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, "Counter"] = {}


class Counter:
    """One monotonic counter."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


def counter(name: str, help: str = "") -> Counter:
    """Declare (idempotently) and return the counter ``name``."""
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name, help)
        return c
