"""Contributed operators (counterpart of ``mxnet_tpu/contrib``): so far the
op level of int8 quantization, :mod:`.quantization`."""
from . import quantization

__all__ = ["quantization"]
