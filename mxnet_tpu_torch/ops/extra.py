"""The finiteness checks of AMP (counterpart of ``mxnet_tpu/ops/extra.py``
:95-110, after the reference's ``src/operator/contrib/all_finite.cc``):
1.0 if every element is finite, as a (1,) fp32 tensor. The rest of that
module waits for ROADMAP A9."""
from __future__ import annotations

import torch

from .registry import register


@register("all_finite", differentiable=False)
def all_finite(data, init_output=True):
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite", num_inputs=-1, differentiable=False)
def multi_all_finite(arrays, num_arrays=0, init_output=True):
    ok = torch.ones((), dtype=torch.bool,
                    device=arrays[0].device if arrays else None)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)
