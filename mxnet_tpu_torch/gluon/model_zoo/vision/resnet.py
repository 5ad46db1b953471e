"""ResNet v1 (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

He et al., "Deep Residual Learning", 18/34/50/101/152 layers, with the
reference's ``layout`` ("NCHW" default, or "NHWC") and ``input_layout``
(one transpose at the entry when they differ). The V2 nets and the
space-to-depth stem (``stem_s2d``) are not ported yet. Every op is
dispatched under the reference's names (``resnet.py:108``), through
``ndarray.tensor_op``: the blocks' residual add and ReLU are
``broadcast_add`` and ``relu``, the entry transpose ``transpose``, the
head's ``flatten``.

The fused conv/BN/ReLU epilogue (``MXNET_FUSED_EPILOGUE``,
``resnet.py:55-123``): under hybridized training, ``BottleneckV1`` routes
its three 1x1 sites (conv1 + BN + ReLU, the downsample conv + BN, and conv3
+ BN + residual + ReLU) through ``ops.nn.fused_conv1x1_bn_act``, which runs
the matmul-stats and matmul-epilogue kernels. Each site checks its geometry
against the port's own rule (``cuda_kernels.epilogue_fits``) and runs the
plain layers where it does not fit, so the block computes the same
function either way. Mode 1 fuses where the input lies on a CUDA device,
mode 2 also on the CPU (through the kernels' plain versions), mode 0 never.

The fused conv + batch-norm statistics (``MXNET_FUSED_CONV_BN``,
``gluon/nn/basic_layers.py``): every conv + BN pair of the net's
``HybridSequential``s goes through ``nn.fused_conv_bn``, and so does the
bottleneck's 3x3 pair in the fused-epilogue branch, where the reference
fuses it too. In ResNet-50 v1 that is 36 1x1 and 16 3x3 sites; the
7x7/stride-2 stem is refused. With both knobs on, the epilogue takes the
1x1 sites and the 3x3 sites go through the statistics kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from .... import autograd, config as _config
from ....context import resolve_device
from ....ndarray.ndarray import tensor_op
from ....ops import cuda_kernels
from ....ops import elemwise as _elemwise  # noqa: F401  (registers the ops)
from ....ops import nn as _nn_ops  # noqa: F401
from ....ops import tensor as _tensor_ops  # noqa: F401
from ... import nn
from ...block import HybridBlock, in_hybridized_call
from ...nn.basic_layers import (fused_conv_bn, fused_conv_bn_counts,
                                reset_fused_conv_bn_counts)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet", "fused_epilogue_counts",
           "reset_fused_epilogue_counts", "fused_conv_bn_counts",
           "reset_fused_conv_bn_counts"]

_SITES: Dict[str, int] = {"fused": 0, "refused": 0}
_FUSED_ACT, _RELU, _BROADCAST_ADD, _TRANSPOSE, _FLATTEN = map(
    tensor_op, ("_fused_conv1x1_bn_act", "relu", "broadcast_add",
                "transpose", "flatten"))


def fused_epilogue_counts() -> Dict[str, int]:
    """Fused-epilogue sites so far: ``fused`` ran the kernels' op,
    ``refused`` fell back to the plain layers because
    ``cuda_kernels.epilogue_fits`` refused the shape."""
    return dict(_SITES)


def reset_fused_epilogue_counts() -> None:
    for k in _SITES:
        _SITES[k] = 0


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _fused_epilogue_mode() -> int:
    return _config.get("MXNET_FUSED_EPILOGUE")


def _try_fused_epilogue(conv, bn, x, relu=False, residual=None):
    """Route ``relu(bn(conv(x)) [+ residual])`` through the fused op when
    eligible; return its output, or None (the caller then runs the plain
    layers). Training mode only (the batch statistics are the fusion) and
    inside a hybridized call only (eager calls never take it), and the
    running statistics fold exactly as ``BatchNorm.forward`` folds them."""
    if not autograd.is_training() or bn._use_global_stats:
        return None
    if not in_hybridized_call():
        return None
    mode = _fused_epilogue_mode()
    if mode != 2 and x.device.type != "cuda":
        return None
    kw = conv._kwargs
    if (kw["kernel"] != (1, 1) or kw["pad"] != (0, 0)
            or kw["dilate"] != (1, 1) or kw["num_group"] != 1
            or kw["layout"] != "NHWC" or bn._axis not in (3, -1)
            or x.dtype not in (torch.float32, torch.bfloat16)):
        return None
    stride = kw["stride"]
    n, h, wd, cin = x.shape
    ho, wo = -(-h // stride[0]), -(-wd // stride[1])
    cout = conv._channels
    if not cuda_kernels.epilogue_fits(n * ho * wo, cin, cout, x.dtype):
        _SITES["refused"] += 1
        return None
    if residual is not None and tuple(residual.shape) != (n, ho, wo, cout):
        return None
    ins = [x, conv.weight.data()]
    if conv.bias is not None:
        ins.append(conv.bias.data())
    if residual is not None:
        ins.append(residual)
    ins += [bn.gamma.data(), bn.beta.data()]
    out, mean, var = _FUSED_ACT(
        ins, stride=stride, eps=bn._epsilon, fix_gamma=not bn._scale,
        has_bias=conv.bias is not None, has_residual=residual is not None,
        relu=relu)
    bn.update_running_stats(mean, var)
    _SITES["fused"] += 1
    return out


def _conv_bn(conv, bn, x):
    """bn(conv(x)), fused where ``MXNET_FUSED_CONV_BN`` admits the pair."""
    out = fused_conv_bn(conv, bn, x)
    return bn(conv(x)) if out is None else out


def _add_relu(x, residual):
    """``(x + residual).relu()``, the reference blocks' two ops."""
    return _RELU(_BROADCAST_ADD(x, residual))


def _bn(layout="NCHW", **kwargs):
    return nn.BatchNorm(axis=layout.index("C"), **kwargs)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return _add_relu(x, residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def forward(self, x):
        b = self.body
        if _fused_epilogue_mode():
            # conv1 (1x1 + bn + relu) fused; the 3x3 and its bn as a fused
            # conv + batch-norm pair where MXNET_FUSED_CONV_BN admits it,
            # else the plain layers; conv3 (1x1 + bn) takes the residual
            # add and the block's relu into its epilogue
            h = _try_fused_epilogue(b[0], b[1], x, relu=True)
            if h is not None:
                h = b[5](_conv_bn(b[3], b[4], h))
                if self.downsample:
                    residual = _try_fused_epilogue(
                        self.downsample[0], self.downsample[1], x)
                    if residual is None:
                        residual = self.downsample(x)
                else:
                    residual = x
                out = _try_fused_epilogue(b[6], b[7], h, relu=True,
                                          residual=residual)
                if out is not None:
                    return out
                return _add_relu(_conv_bn(b[6], b[7], h), residual)
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return _add_relu(x, residual)


class ResNetV1(HybridBlock):
    """ResNet v1. Takes input in ``input_layout`` (default NCHW) and
    computes in ``layout``; when they differ one transpose runs at the
    entry."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", input_layout=None):
        super().__init__()
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"resnet layout must be NCHW or NHWC: {layout}")
        if len(layers) != len(channels) - 1:
            raise ValueError("len(layers) must be len(channels) - 1")
        self._layout = layout
        self._input_layout = input_layout or "NCHW"
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        layout=layout))
            self.features.add(_bn(layout))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=self._layout))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=self._layout))
        return layer

    def _to_compute_layout(self, x):
        if self._input_layout == self._layout:
            return x
        axes = (0, 2, 3, 1) if self._layout == "NHWC" else (0, 3, 1, 2)
        # contiguous in the compute layout, as the NHWC kernels read it
        return _TRANSPOSE(x, axes=axes).contiguous()

    def forward(self, x):
        x = self.features(self._to_compute_layout(x))
        return self.output(_FLATTEN(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet ``v{version}`` with ``num_layers`` layers. ``ctx`` is the
    device ``initialize`` uses by default (``cuda`` if None: raises without
    CUDA unless given the CPU)."""
    if num_layers not in resnet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version != 1:
        raise NotImplementedError("ResNet v2 is not ported yet")
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported")
    device = resolve_device(ctx)
    block_type, layers, channels = resnet_spec[num_layers]
    net = ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)
    net._default_ctx = device
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
