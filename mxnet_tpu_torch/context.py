"""Device resolution for the port's entry points.

Counterpart of ``mxnet_tpu/context.py``. Unlike the JAX package, which falls
back to the CPU with a warning when the accelerator is missing, the port
never carries on quietly on the CPU: the default device is ``cuda``, the CPU
is used only when asked for, and asking for CUDA without a GPU raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; anything else as given. Raises ``RuntimeError``
    if the result is a CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mxnet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
