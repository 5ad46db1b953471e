"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``; the base
``Loss`` and ``SoftmaxCrossEntropyLoss`` so far). A loss returns one value
per sample, the mean over every axis but the batch axis, as the reference
does; ``autograd.backward`` (ones as the head gradient) then
back-propagates their sum. The ops are dispatched as the reference's
``invoke`` calls (``log_softmax``, ``pick``, ``negative``, the weighting's
``mul_scalar`` / ``broadcast_mul``, ``mean``), through
``ndarray.tensor_op``: a loss's call holds only tensors."""
from __future__ import annotations

from ..ndarray.ndarray import tensor_op
from ..ops import elemwise as _elemwise  # noqa: F401  (registers the ops)
from ..ops import nn as _nn_ops  # noqa: F401
from ..ops import reduce as _reduce  # noqa: F401
from ..ops import tensor as _tensor  # noqa: F401
from .block import HybridBlock

_BROADCAST_MUL, _MUL_SCALAR, _MEAN, _LOG_SOFTMAX, _NEGATIVE, _PICK = map(
    tensor_op, ("broadcast_mul", "mul_scalar", "mean", "log_softmax",
                "negative", "pick"))

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Reference ``loss.py:49``."""
    if sample_weight is not None:
        loss = _BROADCAST_MUL(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be numeric")
        loss = _MUL_SCALAR(loss, scalar=float(weight))
    return loss


class Loss(HybridBlock):
    """Base loss (reference ``loss.py:74``)."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        if not axes:
            return loss
        return _MEAN(loss, axis=axes)


class SoftmaxCrossEntropyLoss(Loss):
    """Reference ``loss.py:117-140`` with sparse labels:
    ``-log_softmax(pred)[label]``."""

    def __init__(self, axis=-1, from_logits=False, weight=1.0,
                 batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _LOG_SOFTMAX(pred, axis=self._axis)
        loss = _NEGATIVE(_PICK(pred, label, axis=self._axis, keepdims=False))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
