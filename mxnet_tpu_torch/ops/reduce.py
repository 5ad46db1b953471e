"""Reduction operators (counterpart of ``mxnet_tpu/ops/reduce.py``).
``argmax``/``argmin`` return float32 indices and the cumulative ops keep a
small integer input at 32 bits, as the reference's do."""
from __future__ import annotations

import torch

from ..base import op_dtype
from .registry import register


def _axes(axis, ndim, exclude=False):
    """The reduced dims as a tuple (all of them for None)."""
    if axis is None:
        return tuple(range(ndim))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % ndim for a in ax)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _reduce(f, data, axis, keepdims, exclude=False):
    dims = _axes(axis, data.dim(), exclude)
    if not dims:
        return data
    return f(data, dim=dims, keepdim=keepdims)


@register("sum", aliases=["sum_axis"])
def sum_op(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.sum, data, axis, keepdims, exclude)


@register("mean")
def mean(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.mean, data, axis, keepdims, exclude)


def _prod(data, dim, keepdim):
    out = data
    for d in sorted(dim, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


@register("prod")
def prod(data, axis=None, keepdims=False, exclude=False):
    return _reduce(_prod, data, axis, keepdims, exclude)


@register("nansum")
def nansum(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.nansum, data, axis, keepdims)


@register("nanprod")
def nanprod(data, axis=None, keepdims=False, exclude=False):
    ones = torch.where(torch.isnan(data), torch.ones_like(data), data)
    return _reduce(_prod, ones, axis, keepdims)


@register("max", aliases=["max_axis"])
def max_op(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amax, data, axis, keepdims, exclude)


@register("min", aliases=["min_axis"])
def min_op(data, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amin, data, axis, keepdims, exclude)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    if ord == 2:
        return torch.sqrt(_reduce(torch.sum, torch.square(data), axis,
                                  keepdims))
    if ord == 1:
        return _reduce(torch.sum, torch.abs(data), axis, keepdims)
    raise ValueError("norm only supports ord=1 or 2 (reference parity)")


def _arg(f, data, axis, keepdims):
    if axis is None:
        out = f(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = f(data, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", differentiable=False)
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


def _cum(f, a, axis, dtype):
    x = a.reshape(-1) if axis is None else a
    out = f(x, dim=0 if axis is None else axis)
    if dtype:
        return out.to(op_dtype(dtype))
    if a.dtype == torch.bool or (not a.is_floating_point()
                                 and a.dtype.itemsize < 4):
        return out.to(torch.uint32 if a.dtype == torch.uint8
                      or a.dtype == torch.uint16 else torch.int32)
    return out.to(a.dtype)


@register("cumsum")
def cumsum(a, axis=None, dtype=None):
    return _cum(torch.cumsum, a, axis, dtype)


@register("cumprod")
def cumprod(a, axis=None, dtype=None):
    return _cum(torch.cumprod, a, axis, dtype)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    denom = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                       + eps)
    return data / denom
