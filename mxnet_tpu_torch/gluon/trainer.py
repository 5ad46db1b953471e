"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``, one device).

Applies an optimizer to a set of parameters: ``step(batch_size)`` sets
``rescale_grad = 1 / batch_size`` and updates every parameter that has a
gradient request, in place (``trainer.py:240-292``). A parameter that the
last backward did not reach updates with a zero gradient (weight decay and
momentum still act), as in the reference. There is no kvstore, AMP or
compiled step in the port yet.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import optimizer as opt
from ..context import resolve_device
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        elif not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
            if p.grad_req != "null":
                # a parameter not initialized yet would be made on cuda
                resolve_device(p.device)
                self._params.append(p)
        self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, object] = {}

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size) -> None:
        """Normalize the gradients by ``batch_size`` and update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        weights, grads, states = [], [], []
        for i, p in enumerate(self._params):
            w = p._check()
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(w)
            weights.append(w)
            grads.append(w.grad if w.grad is not None
                         else torch.zeros_like(w))
            states.append(self._states[i])
        self._optimizer.step(weights, grads, states)
