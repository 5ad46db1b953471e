"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``;
``Activation`` only so far): the ``Activation`` op (through
``ndarray.tensor_op``, the layers' dispatch), for
each ``act_type`` it accepts (relu, sigmoid, log_sigmoid, tanh, softrelu,
softsign, mish)."""
from __future__ import annotations

from ...ndarray.ndarray import tensor_op
from ...ops import nn as _nn_ops
from ..block import HybridBlock

_ACTIVATION = tensor_op("Activation")

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        if activation not in _nn_ops._ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; one of "
                             f"{sorted(_nn_ops._ACTIVATIONS)}")
        self._act_type = activation

    def forward(self, x):
        return _ACTIVATION(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"
