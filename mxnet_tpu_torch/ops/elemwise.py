"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``).

Binary broadcast ops and their scalar forms, unary math, and ``clip``, as
plain torch calls. Comparisons and logical ops return the left input's
dtype (0 and 1), as MXNet's legacy ops do. A scalar form casts its scalar
to the data's dtype first (``jnp.asarray(scalar, dtype)``), and holds it as
a 0-dim tensor on the data's device: on CUDA, torch divides by a Python
number as a multiply by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import torch

from .registry import register


def _cmp(f):
    return lambda a, b: f(a, b).to(a.dtype)


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": torch.remainder,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": _cmp(torch.eq),
    "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt),
    "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt),
    "lesser_equal": _cmp(torch.le),
    "logical_and": _cmp(torch.logical_and),
    "logical_or": _cmp(torch.logical_or),
    "logical_xor": _cmp(torch.logical_xor),
}

_NONDIFF_BINARY = {
    "equal", "not_equal", "greater", "greater_equal", "lesser",
    "lesser_equal", "logical_and", "logical_or", "logical_xor",
}


def _scalar_like(data, scalar):
    """``scalar`` in data's dtype, as a 0-dim tensor on data's device."""
    dt = data.dtype
    if dt.is_floating_point or dt.is_complex:
        v = float(scalar)
    elif dt == torch.bool:
        v = bool(scalar)
    else:
        v = int(scalar)
    return torch.full((), v, dtype=dt, device=data.device)


for _name, _f in _BINARY.items():
    def _make(f):
        def op(lhs, rhs):
            return f(lhs, rhs)
        return op

    register(f"broadcast_{_name}", num_inputs=2,
             differentiable=_name not in _NONDIFF_BINARY,
             aliases=[f"elemwise_{_name}"]
             if _name in ("add", "sub", "mul", "div") else [])(_make(_f))

    def _make_scalar(f):
        def op(data, scalar=0.0, reverse=False):
            s = _scalar_like(data, scalar)
            return f(s, data) if reverse else f(data, s)
        return op

    register(f"{_name}_scalar", num_inputs=1,
             differentiable=_name not in _NONDIFF_BINARY)(_make_scalar(_f))


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "negative": torch.negative,
    "reciprocal": torch.reciprocal,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}

_NONDIFF_UNARY = {"sign", "rint", "ceil", "floor", "trunc", "fix",
                  "logical_not", "isnan", "isinf", "isfinite"}

for _name, _f in _UNARY.items():
    def _mk(f):
        def op(data):
            return f(data)
        return op

    register(_name, num_inputs=1,
             differentiable=_name not in _NONDIFF_UNARY)(_mk(_f))


@register("clip")
def clip(data, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)
