"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``, one device).

Applies an optimizer to a set of parameters: ``step(batch_size)`` sets
``rescale_grad = 1 / batch_size`` and updates every parameter that has a
gradient request, in place (``trainer.py:240-292``). A parameter that the
last backward did not reach updates with a zero gradient (weight decay and
momentum still act), as in the reference. ``compile_step`` returns the
compiled whole step (``cached_step.TrainStep``). There is no kvstore or AMP
in the port yet.
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

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_states(self) -> list:
        """The optimizer state of every parameter, made where missing (a
        compiled step makes them before its first capture); and the
        optimizer's device scalars on their devices."""
        for i, p in enumerate(self._params):
            if i not in self._states:
                w = p._check()
                self._states[i] = self._optimizer.create_state(w)
                self._optimizer.scalars(w.device)
        return [self._states[i] for i in range(len(self._params))]

    def compile_step(self, net, loss_fn, bucket=False, accum_steps=1):
        """Forward, backward and the optimizer update as ONE captured
        program (``cached_step.TrainStep``), the counterpart of the
        reference's one donated XLA program a step. ``loss_fn(net, *args)``
        returns the loss; the returned step is called as ``step(*args,
        batch_size=...)`` and replaces the record / backward / ``step()``
        triple. Setups it cannot capture (``MXNET_COMPILED_STEP=0``,
        ``grad_req='add'``, a pending deferred initialization) run the
        eager tape and name their reason in ``last_fallback_reason``.
        ``bucket=True`` pads each batch to its shape bucket, once checked
        for a pad-safe loss; ``accum_steps=N`` makes a window of N calls
        one update (N grad programs and one update program)."""
        from ..cached_step import TrainStep

        return TrainStep(net, loss_fn, self, bucket=bucket,
                         accum_steps=accum_steps)

    def step(self, batch_size) -> None:
        """Normalize the gradients by ``batch_size`` and update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        states = self._init_states()
        weights, grads = [], []
        for p in self._params:
            w = p._check()
            weights.append(w)
            grads.append(w.grad if w.grad is not None
                         else torch.zeros_like(w))
        self._optimizer.step(weights, grads, states)
