"""SGD with momentum (counterpart of ``mxnet_tpu/optimizer/sgd.py`` ``SGD``).

The arithmetic is ``sgd_mom_update``'s (``mxnet_tpu/ops/optimizer.py:19-57``):
``g = grad · rescale_grad + wd · w``, ``mom = momentum · mom − lr · g``,
``w += mom``, in the weight's dtype, in place, each product rounded to that
dtype as the reference's expression rounds it. ``lr``, ``wd`` and
``rescale_grad`` are read from the optimizer's device scalars
(:meth:`Optimizer.scalars`); ``momentum`` is fixed at construction. With
momentum 0 this is ``w -= lr · g``, the reference's plain ``sgd_update``.
``Optimizer.step`` adds the AMP flag and the fp32 master weights
(``multi_precision``).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register

__all__ = ["SGD"]


@register
class SGD(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def fixed_signature(self) -> tuple:
        return super().fixed_signature() + (float(self.momentum),)

    def create_state(self, weight):
        return torch.zeros_like(weight)

    def _update(self, ws, gs, ms, s) -> None:
        g = torch._foreach_mul(gs, s["rescale_grad"])
        torch._foreach_add_(g, torch._foreach_mul(ws, s["wd"]))
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_sub_(ms, torch._foreach_mul(g, s["lr"]))
        torch._foreach_add_(ws, ms)
