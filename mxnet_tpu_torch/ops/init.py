"""Creation operators (counterpart of ``mxnet_tpu/ops/init.py``): made on
the current context's device (``with mx.cpu():``, or ``ctx=`` through
``mx.nd``)."""
from __future__ import annotations

import torch

from ..base import op_dtype
from ..context import resolve_device
from .registry import register


def _at():
    return resolve_device(None)


@register("zeros", num_inputs=0, differentiable=False)
def zeros(shape=None, dtype="float32"):
    return torch.zeros(tuple(shape), dtype=op_dtype(dtype), device=_at())


@register("ones", num_inputs=0, differentiable=False)
def ones(shape=None, dtype="float32"):
    return torch.ones(tuple(shape), dtype=op_dtype(dtype), device=_at())


@register("full", num_inputs=0, differentiable=False)
def full(shape=None, value=0.0, dtype="float32"):
    return torch.full(tuple(shape), value, dtype=op_dtype(dtype),
                      device=_at())


@register("arange", num_inputs=0, differentiable=False)
def arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=op_dtype(dtype),
                       device=_at())
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("linspace", num_inputs=0, differentiable=False)
def linspace(start=0, stop=1, num=50, endpoint=True, dtype="float32"):
    num = int(num)
    if endpoint or num == 0:
        out = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:-1]
    return out.to(device=_at(), dtype=op_dtype(dtype))


@register("eye", num_inputs=0, differentiable=False)
def eye(N=0, M=0, k=0, dtype="float32"):
    n, m, k = int(N), int(M) if M else int(N), int(k)
    rows = torch.arange(n, device=_at())[:, None]
    cols = torch.arange(m, device=_at())[None, :]
    return (cols - rows == k).to(op_dtype(dtype))
