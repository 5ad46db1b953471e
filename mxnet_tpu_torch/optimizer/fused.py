"""The all-finite check of AMP (counterpart of ``all_finite`` in
``mxnet_tpu/optimizer/fused.py:137-162``).

The reference's grouped update programs are the port's ``torch._foreach``
updates (``Optimizer.step``), which take the flag this returns as ``ok``.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["all_finite"]


def all_finite(arrays: Sequence, device=None) -> torch.Tensor:
    """Whether every element of every tensor (or NDArray) is finite, as a
    0-dim bool on their device: one reduction, no host read. An empty list
    gives True on ``device`` (the CPU by default)."""
    ts = [getattr(a, "_data", a) for a in arrays if a is not None]
    if not ts:
        return torch.ones((), dtype=torch.bool, device=device)
    return torch.stack([torch.isfinite(t).all() for t in ts]).all()
