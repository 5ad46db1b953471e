"""Basic layers: containers, Dense, BatchNorm, Flatten.

Counterpart of the parts of ``mxnet_tpu/gluon/nn/basic_layers.py`` that the
ResNet path uses. ``BatchNorm`` has no ``_fused_conv_src`` (the
``MXNET_FUSED_CONV_BN`` route) in the port yet.
"""
from __future__ import annotations

import math

import torch

from ... import autograd, initializer
from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Blocks run in sequence (reference ``basic_layers.py:86``)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, i: int):
        return list(self._children.values())[i]


class Dense(HybridBlock):
    """Fully-connected layer: ``x @ weightᵀ + bias``, weight (units,
    in_units) (reference ``basic_layers.py:136``)."""

    def __init__(self, units, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        self.weight = Parameter("weight", shape=(units, in_units),
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter(
            "bias", shape=(units,),
            init=initializer.create(bias_initializer),
            allow_deferred_init=True) if use_bias else None

    def infer_shape(self, x):
        in_units = (math.prod(x.shape[1:]) if self._flatten
                    else int(x.shape[-1]))
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        return F.fully_connected(
            x, self.weight.data(),
            self.bias.data() if self._use_bias else None, self._flatten)


class BatchNorm(HybridBlock):
    """Batch normalization (reference ``basic_layers.py:186-352``). In
    training mode it normalizes by the batch statistics and folds them into
    the running statistics, in their dtype, with ``momentum``:
    ``running = running * momentum + batch * (1 - momentum)``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=initializer.create(gamma_initializer),
            allow_deferred_init=True, differentiable=scale)
        self.beta = Parameter(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=initializer.create(beta_initializer),
            allow_deferred_init=True, differentiable=center)
        self.running_mean = Parameter(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=initializer.create(running_mean_initializer),
            allow_deferred_init=True, differentiable=False)
        self.running_var = Parameter(
            "running_var", grad_req="null", shape=(in_channels,),
            init=initializer.create(running_variance_initializer),
            allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x):
        c = int(x.shape[self._axis])
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def update_running_stats(self, mean, var) -> None:
        """Fold batch statistics into the running ones, in the running
        buffers' dtype, recording nothing."""
        m = self._momentum
        with torch.no_grad():
            for p, batch in ((self.running_mean, mean),
                             (self.running_var, var)):
                buf = p._data
                buf.copy_(buf * m + batch.to(buf.dtype) * (1 - m))

    def forward(self, x):
        training = autograd.is_training() and not self._use_global_stats
        outs = F.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            out, mean, var = outs
            self.update_running_stats(mean, var)
            return out
        return outs[0]


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
