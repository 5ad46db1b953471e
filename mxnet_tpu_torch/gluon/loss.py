"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``; the base
``Loss`` and ``SoftmaxCrossEntropyLoss`` so far). A loss returns one value
per sample, the mean over every axis but the batch axis, as the reference
does; ``autograd.backward`` (ones as the head gradient) then
back-propagates their sum."""
from __future__ import annotations

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be numeric")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss (reference ``loss.py:74``)."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


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
            pred = F.log_softmax(pred, self._axis)
        loss = -F.pick(pred, label, axis=self._axis, keepdims=False)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
