"""Devices for the port's entry points.

Counterpart of ``mxnet_tpu/context.py``: ``Context``, ``cpu()`` and
``gpu(i)`` name a ``torch.device``. Unlike the JAX package, which falls
back to the CPU with a warning when the accelerator is missing, the port
never carries on quietly on the CPU: the default device is ``cuda``, the CPU
is used only when asked for, and asking for CUDA without a GPU raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Context", "cpu", "gpu", "resolve_device"]


class Context:
    """A device by MXNet's names: ``Context("cpu")``, ``Context("gpu", 1)``
    (``"cuda"`` is taken for ``"gpu"``). ``.device`` is the torch device."""

    def __init__(self, device_type: str = "gpu", device_id: int = 0):
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def resolve_device(device: Optional[Union[str, torch.device, Context]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a ``Context`` -> its torch device; anything
    else as given. Raises ``RuntimeError`` if the result is a CUDA device
    and CUDA is not available."""
    if isinstance(device, Context):
        device = device.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mxnet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
