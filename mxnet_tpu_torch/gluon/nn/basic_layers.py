"""Basic layers: containers, Dense, BatchNorm, Flatten.

Counterpart of the parts of ``mxnet_tpu/gluon/nn/basic_layers.py`` that the
ResNet path uses. Each layer dispatches its op under the reference's name
and attrs (``"FullyConnected"``, ``"BatchNorm"``, ``"flatten"``, the fused
ops), as the reference's layers do through ``invoke`` (``basic_layers.py:
143, :176, :313, :327, :529``), through ``ndarray.tensor_op``: a layer
holds only tensors, and each dispatch counts in ``invoke_count`` as the
reference's does. With the ``MXNET_FUSED_CONV_BN`` route
(``BatchNorm._fused_conv_src`` / ``BatchNorm.forward``, reference
``basic_layers.py:232-325``): under hybridized training a ``Conv2D`` that
feeds a ``BatchNorm`` runs with the BN as one op, whose conv kernel also
takes the batch statistics (``ops.nn.fused_conv1x1_bn`` /
``fused_convkxk_bn``).

The reference decides at trace time: ``Conv2D`` tags its output with its
inputs, a following ``BatchNorm`` re-derives the conv through the fused op,
and XLA drops the untouched conv as dead code. Eager PyTorch has no such
pass, so a tag would run every fused conv twice. The port decides before
the conv runs instead: :func:`fused_conv_bn` takes a (conv, BN) pair and
returns the fused output, or None when the rule turns the pair away.
``HybridSequential.forward`` offers it each child followed by a
``BatchNorm``, and the ResNet bottleneck's fused-epilogue branch its 3x3
pair. That covers every site the reference fuses in the model zoo's
ResNets, but less than the tag: a block of a user's that writes
``bn(conv(x))`` by hand does not fuse. Fused or not, the function is the
same; only the rounding differs. An in-place change of the conv's output
(``y = conv(x); y += 1; bn(y)``) therefore never fuses either.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ... import autograd, config as _config, initializer
from ...ndarray.ndarray import tensor_op
from ...ops import cuda_kernels
from ...ops import nn as _nn_ops  # noqa: F401  (registers the ops)
from ...ops import tensor as _tensor_ops  # noqa: F401
from ..block import HybridBlock, in_hybridized_call
from ..parameter import Parameter
from .activations import Activation
from .conv_layers import Conv2D

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten",
           "fused_conv_bn", "fused_conv_bn_counts",
           "reset_fused_conv_bn_counts"]

_SITES: Dict[str, int] = {"1x1": 0, "kxk": 0, "refused": 0}
_FUSED = {kind: tensor_op(f"_fused_conv{kind}_bn") for kind in ("1x1", "kxk")}
_FULLY_CONNECTED, _BATCH_NORM, _FLATTEN = map(
    tensor_op, ("FullyConnected", "BatchNorm", "flatten"))


def fused_conv_bn_counts() -> Dict[str, int]:
    """Conv + BatchNorm pairs so far that ran as one fused op, by kind
    (``1x1``, ``kxk``), and that the rule turned away (``refused``), each
    in a hybridized training call with ``MXNET_FUSED_CONV_BN`` on for the
    input's device."""
    return dict(_SITES)


def reset_fused_conv_bn_counts() -> None:
    for k in _SITES:
        _SITES[k] = 0


def fused_conv_bn(conv, bn, x):
    """``bn(conv(x))`` as one fused op when ``MXNET_FUSED_CONV_BN`` admits
    the pair; its output, or None (the caller then runs the two layers).
    Only an exact ``Conv2D`` followed by an exact ``BatchNorm``, in
    training mode with batch statistics, inside a hybridized call (the
    reference's trace), and with the knob on: 1 where x lies on a CUDA
    device, 2 anywhere. Such a pair that the rule refuses is counted."""
    if type(conv) is not Conv2D or type(bn) is not BatchNorm:
        return None
    if not autograd.is_training() or bn._use_global_stats or \
            not in_hybridized_call():
        return None
    mode = _config.get("MXNET_FUSED_CONV_BN")
    if not mode or (mode != 2 and x.device.type != "cuda"):
        return None
    fused = bn._fused_conv_src(conv, x)
    if fused is None:
        _SITES["refused"] += 1
        return None
    kind, geom = fused
    ins = [x, conv.weight.data()]
    if conv.bias is not None:
        ins.append(conv.bias.data())
    ins += [bn.gamma.data(), bn.beta.data()]
    attrs = {"eps": bn._epsilon, "fix_gamma": not bn._scale,
             "has_bias": conv.bias is not None,
             ("stride" if kind == "1x1" else "pad"): geom}
    out, mean, var = _FUSED[kind](ins, **attrs)
    bn.update_running_stats(mean, var)
    _SITES[kind] += 1
    return out


def _fused_kinds():
    kinds = {k.strip()
             for k in _config.get("MXNET_FUSED_CONV_BN_KINDS").split(",")}
    unknown = kinds - {"1x1", "kxk", ""}
    if unknown:
        raise ValueError(f"MXNET_FUSED_CONV_BN_KINDS: unknown kind(s) "
                         f"{sorted(unknown)} (valid: '1x1', 'kxk')")
    return kinds


class HybridSequential(HybridBlock):
    """Blocks run in sequence (reference ``basic_layers.py:86``). A child
    followed by a ``BatchNorm`` is first offered to :func:`fused_conv_bn`
    with it."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        blocks = list(self._children.values())
        i = 0
        while i < len(blocks):
            if i + 1 < len(blocks):
                out = fused_conv_bn(blocks[i], blocks[i + 1], x)
                if out is not None:
                    x = out
                    i += 2
                    continue
            x = blocks[i](x)
            i += 1
        return x

    def __getitem__(self, i: int):
        return list(self._children.values())[i]


class Dense(HybridBlock):
    """Fully-connected layer: ``act(x @ weightᵀ + bias)``, weight (units,
    in_units) (reference ``basic_layers.py:136``); ``activation`` is any
    ``act_type`` of the ``Activation`` op, run as the child ``act``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
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
        self.act = Activation(activation) if activation else None

    def infer_shape(self, x):
        in_units = (math.prod(x.shape[1:]) if self._flatten
                    else int(x.shape[-1]))
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        args = [x, self.weight.data()]
        if self._use_bias:
            args.append(self.bias.data())
        out = _FULLY_CONNECTED(args, num_hidden=self._units,
                               no_bias=not self._use_bias,
                               flatten=self._flatten)
        return out if self.act is None else self.act(out)


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

    def _fused_conv_src(self, conv, x):
        """``(kind, geometry)`` when ``self(conv(x))`` may run as one fused
        op, else None: kind ``"1x1"`` with the stride (a 1x1 conv, pad 0,
        any stride) or ``"kxk"`` with the padding (a KxK stride-1 conv),
        each admitted by ``MXNET_FUSED_CONV_BN_KINDS`` and by its kernel's
        rule (``cuda_kernels.epilogue_fits`` / ``convkxk_fits``); always an
        NHWC conv of dilation 1 and one group, axis 3, fp32 or bf16."""
        kw = conv._kwargs
        kinds = _fused_kinds()
        if (kw["dilate"] != (1, 1) or kw["num_group"] != 1
                or kw["layout"] != "NHWC" or self._axis not in (3, -1)
                or x.dtype not in (torch.float32, torch.bfloat16)):
            return None
        n, h, wd, cin = x.shape
        kernel, stride, pad = kw["kernel"], kw["stride"], kw["pad"]
        cout = conv._channels
        if kernel == (1, 1) and pad == (0, 0):
            ho, wo = -(-h // stride[0]), -(-wd // stride[1])
            if "1x1" in kinds and cuda_kernels.epilogue_fits(
                    n * ho * wo, cin, cout, x.dtype):
                return "1x1", stride
            return None
        if stride == (1, 1) and "kxk" in kinds and cuda_kernels.convkxk_fits(
                x.shape, cout, kernel, pad, x.dtype):
            return "kxk", pad
        return None

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
        outs = _BATCH_NORM(
            [x, self.gamma.data(), self.beta.data(),
             self.running_mean.data(), self.running_var.data()],
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
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
        return _FLATTEN(x)
