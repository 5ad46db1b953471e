"""The port's error type.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, line 99), holding only
what the port raises so far.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework, as the reference's
    ``mxnet.base.MXNetError``."""
