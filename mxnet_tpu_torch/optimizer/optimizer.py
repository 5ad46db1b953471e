"""Optimizer base class and registry.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: learning rate, weight
decay, ``rescale_grad`` and ``create`` by name. Updates run as
``torch._foreach_*`` ops over every parameter that shares a device and
dtype.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Optimizer", "register", "create"]


class Optimizer:
    """Base optimizer."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, learning_rate=None):
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.wd = wd

    def set_learning_rate(self, lr):
        self.lr = lr

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
    ``torch._foreach_*`` call takes. Yields (weights, grads, states)."""
    out: Dict[tuple, tuple] = {}
    for w, g, s in zip(weights, grads, states):
        lists = out.setdefault((w.device, w.dtype), ([], [], []))
        lists[0].append(w)
        lists[1].append(g)
        lists[2].append(s)
    yield from out.values()
