"""Optimizer base class and registry.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: learning rate, weight
decay, ``rescale_grad`` and ``create`` by name. Updates run as
``torch._foreach_*`` ops over every parameter that shares a device and
dtype.

The per-step values (``lr``, ``wd``, ``rescale_grad``) are also held as
0-dim fp32 tensors on each device the optimizer updates on (:meth:`scalars`),
and the updates read those, as the reference passes them to its compiled
step as traced arguments: a captured step then sees a new learning rate or
batch size without a new capture. Setting one of them writes the tensors
(a fill on the device, no host sync) when its value changes. The eager and
the captured step run the same arithmetic.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Optimizer", "register", "create"]

_STEP_VALUES = ("lr", "wd", "rescale_grad")


class Optimizer:
    """Base optimizer."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, learning_rate=None):
        self._values = {"lr": 0.01 if learning_rate is None
                        else float(learning_rate),
                        "wd": float(wd), "rescale_grad": float(rescale_grad)}
        self._scalars: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _get(self, name):
        return self._values[name]

    def _set(self, name, value):
        value = float(value)
        if value == self._values[name]:
            return
        self._values[name] = value
        for scalars in self._scalars.values():
            scalars[name].fill_(value)

    lr = property(lambda self: self._get("lr"),
                  lambda self, v: self._set("lr", v))
    wd = property(lambda self: self._get("wd"),
                  lambda self, v: self._set("wd", v))
    rescale_grad = property(lambda self: self._get("rescale_grad"),
                            lambda self, v: self._set("rescale_grad", v))

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def scalars(self, device) -> Dict[str, torch.Tensor]:
        """``{"lr", "wd", "rescale_grad"}`` as 0-dim fp32 tensors on
        ``device``, made at the first request (before any capture)."""
        device = torch.device(device)
        if device not in self._scalars:
            self._scalars[device] = {
                k: torch.full((), self._values[k], dtype=torch.float32,
                              device=device) for k in _STEP_VALUES}
        return self._scalars[device]

    def fixed_signature(self) -> tuple:
        """The hyper-parameters an update reads as Python numbers (fixed
        at construction): part of a captured step's key."""
        return ()

    def create_state(self, weight: torch.Tensor):
        return None

    def step(self, weights: List[torch.Tensor], grads: List[torch.Tensor],
             states: List) -> None:
        """Update ``weights`` in place from ``grads`` and ``states``."""
        raise NotImplementedError


def register(klass):
    """Register an optimizer under its lowercased class name."""
    Optimizer.opt_registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> Optimizer:
    key = name.lower()
    if key not in Optimizer.opt_registry:
        raise ValueError(f"Cannot find optimizer {name}; ported: "
                         f"{sorted(Optimizer.opt_registry)}")
    return Optimizer.opt_registry[key](**kwargs)


def groups(weights, grads, states):
    """Split the update into lists that share (device, dtype), the unit one
    ``torch._foreach_*`` call takes. Yields (device, weights, grads,
    states)."""
    out: Dict[tuple, tuple] = {}
    for w, g, s in zip(weights, grads, states):
        lists = out.setdefault((w.device, w.dtype), ([], [], []))
        lists[0].append(w)
        lists[1].append(g)
        lists[2].append(s)
    for (device, _dtype), lists in out.items():
        yield (device,) + lists
