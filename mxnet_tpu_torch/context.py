"""Devices for the port's entry points.

Counterpart of ``mxnet_tpu/context.py``: ``Context``, ``cpu()`` and
``gpu(i)`` name a ``torch.device``, and ``with ctx:`` makes ``ctx`` the
current context (``current_context``, reference ``context.py:41-85,
:170``) for the creation functions and every entry point given no device.
Unlike the JAX package, which falls back to the CPU with a warning when the
accelerator is missing, the port never carries on quietly on the CPU: the
default context is ``gpu(0)``, the CPU is used only when asked for (``with
mx.cpu():``, ``ctx=mx.cpu()``, ``device="cpu"``), and asking for CUDA
without a GPU raises.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "resolve_device"]


class Context:
    """A device by MXNet's names: ``Context("cpu")``, ``Context("gpu", 1)``
    (``"cuda"`` is taken for ``"gpu"``). ``.device`` is the torch device.
    As a context manager it is the current context inside its scope."""

    _default_ctx = threading.local()

    def __init__(self, device_type: str = "gpu", device_id: int = 0):
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctxs = []

    @property
    def device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    def __repr__(self):
        return f"Context({self})"

    def __enter__(self):
        self._old_ctxs.append(getattr(Context._default_ctx, "value", None))
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctxs.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The context of the innermost ``with ctx:`` scope of this thread,
    else ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return gpu(0) if ctx is None else ctx


def num_gpus() -> int:
    return torch.cuda.device_count()


def context_of(device: torch.device) -> Context:
    """The ``Context`` naming a torch device."""
    if device.type == "cpu":
        return cpu()
    return gpu(0 if device.index is None else device.index)


def resolve_device(device: Optional[Union[str, torch.device, Context]] = None
                   ) -> torch.device:
    """``None`` -> the current context's device (``cuda`` unless inside
    ``with mx.cpu():``); a ``Context`` -> its torch device; anything else
    as given. Raises ``RuntimeError`` if the result is a CUDA device and
    CUDA is not available."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        device = device.device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mxnet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or ctx=mx.cpu(), or work inside "
            "`with mx.cpu():`) to run on the CPU")
    return dev
