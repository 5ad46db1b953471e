"""Random state: one ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py``. The reference splits a threefry key
chain (``next_key``) per eager draw; the port's random ops draw from the
generator of the device they run on (:func:`generator`), as MXNet's
per-device generators do (``src/common/random_generator.*``). The same seed
gives the same draws within the port, device by device; the draws are not
the reference's (ROADMAP Queue C, differences by design).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .context import Context, resolve_device

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_GENERATORS: Dict[torch.device, torch.Generator] = {}
_SEED = [0]                     # the seed of generators made from now on


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state: int, ctx: Optional[Context] = None) -> None:
    """Seed the generator of ``ctx``'s device, or every device's (those
    made later included) when ``ctx`` is None or ``"all"`` (reference
    ``python/mxnet/random.py:30``)."""
    s = int(seed_state)
    with _lock:
        if ctx is None or ctx == "all":
            _SEED[0] = s
            for g in _GENERATORS.values():
                g.manual_seed(s)
            return
        dev = _key(resolve_device(ctx))
        g = _GENERATORS.get(dev)
        if g is None:
            g = _GENERATORS[dev] = torch.Generator(device=dev)
        g.manual_seed(s)


def generator(device) -> torch.Generator:
    """The generator of ``device``, made (and seeded with the last global
    seed, 0 by default) at its first use."""
    dev = _key(device)
    with _lock:
        g = _GENERATORS.get(dev)
        if g is None:
            g = _GENERATORS[dev] = torch.Generator(device=dev)
            g.manual_seed(_SEED[0])
        return g
