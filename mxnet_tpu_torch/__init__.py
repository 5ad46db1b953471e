"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or anything of ``mxnet_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit device they raise.

Ported so far: the flagship transformer LM forward (``models``), with the
flash-attention forward as a hand-written Hopper kernel
(``ops/csrc/flash_attention_fwd.cu``).
"""
from . import models

__all__ = ["models"]
