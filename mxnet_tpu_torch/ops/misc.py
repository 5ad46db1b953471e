"""The AMP cast ops (counterpart of the AMP part of ``mxnet_tpu/ops/misc.py``,
:18-50, after the reference's ``src/operator/tensor/amp_cast.cc``); the
rest of that module waits for ROADMAP A9."""
from __future__ import annotations

import torch

from ..base import op_dtype
from .registry import register

_FLOAT_ORDER = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@register("amp_cast")
def amp_cast(data, dtype="float32"):
    """The mixed-precision cast node: ``data`` in ``dtype``."""
    return data.to(op_dtype(dtype))


@register("amp_multicast", num_inputs=-1, num_outputs=-1)
def amp_multicast(arrays, num_outputs=0, cast_narrow=False):
    """Every floating input cast to their widest (``cast_narrow``: their
    narrowest) floating dtype, in the order float16 < bfloat16 < float32 <
    float64; other inputs pass unchanged. Returns a tuple."""
    floats = [a.dtype for a in arrays if a.dtype in _FLOAT_ORDER]
    if not floats:
        return tuple(arrays)
    target = (min if cast_narrow else max)(floats, key=_FLOAT_ORDER.index)
    return tuple(a.to(target) if a.dtype in _FLOAT_ORDER else a
                 for a in arrays)
