"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``;
``Activation`` only so far)."""
from __future__ import annotations

from ...ops import nn as F
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return F.activation(x, self._act_type)
