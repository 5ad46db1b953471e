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

:meth:`Optimizer.step` takes two more device values for AMP (reference
``optimizer/fused.py:165-288``): ``ok``, a 0-dim bool (the all-finite flag
of ``fused.all_finite``), with which every weight and state leaf ends as
``where(ok, new, old)``, so that an overflowed step leaves them bitwise as
they were with no host read between the check and the update; and
``rescale``, a 0-dim fp32 that stands in for ``rescale_grad`` (the loss
scale's divisor, chosen on the device by the deferred gate).

``multi_precision=True`` (reference ``optimizer.py:30-50, :153-200``): an
fp16 weight gets an fp32 master copy, its state is ``(master, inner
state)``, and the update runs on the master from the fp32 gradient, the
weight then set to the master rounded to fp16.
"""
from __future__ import annotations

import logging
from typing import Dict, List

import torch

__all__ = ["Optimizer", "register", "create", "state_leaves"]

_STEP_VALUES = ("lr", "wd", "rescale_grad")


class Optimizer:
    """Base optimizer."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, learning_rate=None,
                 multi_precision=False):
        self._values = {"lr": 0.01 if learning_rate is None
                        else float(learning_rate),
                        "wd": float(wd), "rescale_grad": float(rescale_grad)}
        self._scalars: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.multi_precision = bool(multi_precision)

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
        return (self.multi_precision,)

    def create_state(self, weight: torch.Tensor):
        return None

    def create_state_multi_precision(self, weight: torch.Tensor):
        """The state of ``weight``: ``(fp32 master copy, its state)`` for an
        fp16 weight under ``multi_precision``, else :meth:`create_state`'s
        (reference ``create_state_multi_precision``)."""
        if self.multi_precision and weight.dtype == torch.float16:
            master = weight.detach().float()
            return (master, self.create_state(master))
        if weight.dtype == torch.float16:
            logging.warning(
                "Accumulating with float16 in optimizer can lead to poor "
                "accuracy or slow convergence. Consider using "
                "multi_precision=True option of the optimizer")
        return self.create_state(weight)

    def _begin_step(self, weights) -> None:
        """What a step does once before its groups (Adam counts t)."""

    def _update(self, ws, gs, states, s) -> None:
        """The update of one group in place: ``ws`` and the state leaves
        of ``states`` from ``gs``, reading the device scalars ``s``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, weights: List[torch.Tensor], grads: List[torch.Tensor],
             states: List, ok=None, rescale=None) -> None:
        """Update ``weights`` in place from ``grads`` and ``states``; with
        ``ok`` each weight and state leaf ends as ``where(ok, new, old)``;
        ``rescale`` stands in for ``rescale_grad`` (see the module
        docstring)."""
        self._begin_step(weights)
        for device, ws, gs, ss in groups(weights, grads, states):
            s = self.scalars(device)
            if rescale is not None:
                s = dict(s, rescale_grad=rescale)
            mp = self.multi_precision and ws[0].dtype == torch.float16
            targets, inner = ws, ss
            if mp:
                targets = [st[0] for st in ss]
                inner = [st[1] for st in ss]
                gs = [g.float() for g in gs]
            live = list(ws) + state_leaves(ss)
            snap = None if ok is None else [t.clone() for t in live]
            self._update(targets, gs, inner, s)
            if mp:
                torch._foreach_copy_(ws, targets)
            if snap is not None:
                for t, old in zip(live, snap):
                    torch.where(ok, t, old, out=t)


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


def state_leaves(states) -> List[torch.Tensor]:
    """The tensors of a list of states in order (a state is None, a tensor
    or a tuple of states)."""
    out: List[torch.Tensor] = []
    for st in states:
        if isinstance(st, torch.Tensor):
            out.append(st)
        elif isinstance(st, (list, tuple)):
            out.extend(state_leaves(st))
    return out


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
