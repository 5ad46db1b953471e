"""Adam (counterpart of ``Adam`` in ``mxnet_tpu/optimizer/adam.py``; the
file's other optimizers wait for ROADMAP A4).

The arithmetic is ``adam_update``'s (``ops/optimizer.py``), in the
reference's order, each product rounded to the weight's dtype: ``g = grad
· rescale_grad + wd · w``, ``mean = β1 · mean + (1 − β1) · g``, ``var =
β2 · var + (1 − β2) · g²``, ``w −= lr_t · mean / (sqrt(var) + ε)``, with the
bias correction in the learning rate, ``lr_t = lr · sqrt(1 − β2^t) / (1 −
β1^t)``. The step count ``t`` is a 0-dim fp32 tensor beside the
optimizer's other device scalars (:meth:`Optimizer.scalars`), counted up on
the device once a step, so a captured step counts its replays; the
reference counts on the host per parameter and computes ``lr_t`` in
double, so ``lr_t`` here rounds once more, in fp32.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register

__all__ = ["Adam"]


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def fixed_signature(self) -> tuple:
        return super().fixed_signature() + (
            float(self.beta1), float(self.beta2), float(self.epsilon))

    def scalars(self, device):
        s = super().scalars(device)
        if "t" not in s:
            s["t"] = torch.zeros((), dtype=torch.float32, device=device)
        return s

    def create_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _begin_step(self, weights) -> None:
        # t counts every step, a skipped (overflowed) one too, as the
        # reference's update counts do
        for device in {w.device for w in weights}:
            self.scalars(device)["t"].add_(1)

    def _update(self, ws, gs, st, s) -> None:
        b1, b2 = self.beta1, self.beta2
        t = s["t"]
        lr_t = s["lr"] * torch.sqrt(1.0 - torch.pow(b2, t)) \
            / (1.0 - torch.pow(b1, t))
        means = [m for m, _ in st]
        vars_ = [v for _, v in st]
        g = torch._foreach_mul(gs, s["rescale_grad"])
        torch._foreach_add_(g, torch._foreach_mul(ws, s["wd"]))
        torch._foreach_mul_(means, b1)
        torch._foreach_add_(means, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(vars_, b2)
        torch._foreach_add_(vars_, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        den = torch._foreach_add(torch._foreach_sqrt(vars_), self.epsilon)
        num = torch._foreach_mul(means, lr_t.to(ws[0].dtype))
        torch._foreach_sub_(ws, torch._foreach_div(num, den))
