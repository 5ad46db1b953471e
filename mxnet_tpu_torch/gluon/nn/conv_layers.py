"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``; the 2-D layers ResNet uses). NHWC
layers keep OHWI weights, as the reference does. They dispatch the
``Convolution`` and ``Pooling`` ops with the reference's attrs
(``conv_layers.py:99, :217``) through ``ndarray.tensor_op``.

``Conv2D`` sets no producer tag on its output (reference
``conv_layers.py:100-112``): the port pairs a conv with the ``BatchNorm``
it feeds before either runs (``basic_layers.fused_conv_bn``), since eager
PyTorch cannot drop a conv that has already run."""
from __future__ import annotations

from ... import initializer
from ...ndarray.ndarray import tensor_op
from ...ops import nn as _nn_ops  # noqa: F401  (registers the ops)
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]

_CONVOLUTION, _POOLING = tensor_op("Convolution"), tensor_op("Pooling")


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class Conv2D(HybridBlock):
    """2-D convolution (reference ``conv_layers.py`` ``_Conv``/``Conv2D``).
    Weight (channels, in_channels/groups, kh, kw) for NCHW, (channels, kh,
    kw, in_channels/groups) for NHWC; in_channels 0 is inferred on the first
    call."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        super().__init__()
        if layout not in ("NCHW", "NHWC"):
            raise NotImplementedError(f"Conv2D layout {layout!r} is not "
                                      "ported")
        self._channels = channels
        self._in_channels = in_channels
        self._groups = groups
        self._layout = layout
        self._use_bias = use_bias
        self._kwargs = {
            "kernel": _tuple(kernel_size, 2), "stride": _tuple(strides, 2),
            "dilate": _tuple(dilation, 2), "pad": _tuple(padding, 2),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self.weight = Parameter("weight",
                                shape=self._weight_shape(in_channels),
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter(
            "bias", shape=(channels,),
            init=initializer.create(bias_initializer),
            allow_deferred_init=True) if use_bias else None

    def _weight_shape(self, in_channels):
        kernel = self._kwargs["kernel"]
        cin = in_channels // self._groups
        if self._layout == "NCHW":
            return (self._channels, cin) + kernel
        return (self._channels,) + kernel + (cin,)

    def infer_shape(self, x):
        self._in_channels = int(x.shape[self._layout.index("C")])
        self.weight.shape = self._weight_shape(self._in_channels)

    def forward(self, x):
        args = [x, self.weight.data()]
        if self._use_bias:
            args.append(self.bias.data())
        return _CONVOLUTION(args, **self._kwargs)


class MaxPool2D(HybridBlock):
    """Max pooling ('valid' convention: ceil_mode is not ported)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__()
        if ceil_mode:
            raise NotImplementedError("MaxPool2D ceil_mode is not ported")
        pool_size = _tuple(pool_size, 2)
        self._kwargs = {
            "kernel": pool_size,
            "stride": _tuple(strides, 2) if strides is not None
            else pool_size,
            "pad": _tuple(padding, 2), "global_pool": False,
            "pool_type": "max", "pooling_convention": "valid",
            "layout": layout}

    def forward(self, x):
        return _POOLING(x, **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    """Mean over H and W, keeping them as size 1."""

    def __init__(self, layout="NCHW"):
        super().__init__()
        self._kwargs = {"kernel": (1, 1), "stride": (1, 1), "pad": (0, 0),
                        "global_pool": True, "pool_type": "avg",
                        "pooling_convention": "valid", "layout": layout}

    def forward(self, x):
        return _POOLING(x, **self._kwargs)
