"""Gluon Parameter.

Counterpart of ``mxnet_tpu/gluon/parameter.py``. A Parameter owns one
tensor on one device (the reference keeps per-context replicas; the port
has one device per process so far). Its gradient is torch's own: a
parameter with ``grad_req`` ``"write"`` holds a leaf tensor that requires
grad, and each ``backward`` replaces its ``.grad`` (a hook clears the old
one before torch accumulates); ``"add"`` keeps adding each backward's
gradient to ``.grad`` until ``zero_grad``; ``"null"`` (the batch-norm
running statistics) carries no gradient. A backward of NDArray heads
(``autograd.backward``) writes the same ``.grad`` by the same rule, as the
reference's parameters are marked variables.

Shapes may hold 0 (unknown): the layer completes them on its first forward
and the deferred initialization then runs, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import autograd, initializer
from ..context import resolve_device

__all__ = ["Parameter", "DeferredInitializationError", "dtype_of"]


class DeferredInitializationError(RuntimeError):
    """Parameter read before its shape is known."""


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64}


def dtype_of(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or the reference's name for it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {dtype!r}")
    return _DTYPES[name]


def shape_is_known(shape) -> bool:
    return shape is not None and all(int(s) > 0 for s in shape)


class Parameter:
    """A settable, differentiable tensor held by Blocks."""

    def __init__(self, name: str = "weight", grad_req: str = "write",
                 shape=None, dtype="float32", init=None,
                 allow_deferred_init: bool = False,
                 differentiable: bool = True):
        self._name = name
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        self.dtype = dtype_of(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data: Optional[torch.Tensor] = None
        self._deferred_init = ()   # (init, device, default_init)
        self._differentiable = differentiable
        self._hooked = False
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {grad_req!r}")
        self._grad_req = "null" if not differentiable else grad_req

    def __repr__(self):
        return (f"Parameter {self._name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    @property
    def name(self) -> str:
        return self._name

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            self._data.grad = None
            self._data.requires_grad_(req != "null")
            self._hook()
            if req != "null":
                autograd._track(self)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape) or
                any(a not in (0, -1) and a != b
                    for a, b in zip(self._shape, new_shape))):
            raise AssertionError(
                f"Expected shape {new_shape} is incompatible with given "
                f"shape {self._shape} for Parameter {self._name}")
        self._shape = new_shape

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the value, or of the pending deferred
        initialization, or None."""
        if self._data is not None:
            return self._data.device
        return self._deferred_init[1] if self._deferred_init else None

    # -- initialization --------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Create the value on ``ctx`` (``cuda`` if None; raises without
        CUDA) and fill it: by ``init``, else the parameter's own
        initializer, else ``default_init`` (``Uniform()``). With an unknown
        shape and ``allow_deferred_init`` the fill waits for the first
        forward."""
        if self._data is not None and not force_reinit:
            return
        device = resolve_device(ctx)
        default_init = default_init or initializer.Uniform()
        if init is None:
            init = default_init if self.init is None else self.init
        self._data = None
        self._deferred_init = (init, device, default_init)
        if shape_is_known(self._shape):
            self._finish_deferred_init()
        elif not self.allow_deferred_init:
            raise ValueError(
                f"Cannot initialize Parameter '{self._name}' because it has "
                f"invalid shape: {self._shape}. Set allow_deferred_init=True "
                "or specify in_units/in_channels etc.")

    def _finish_deferred_init(self, data: Optional[torch.Tensor] = None):
        if not self._deferred_init:
            return
        init, device, default_init = self._deferred_init
        if not shape_is_known(self._shape):
            raise DeferredInitializationError(
                f"Parameter '{self._name}' has unknown shape {self._shape} "
                "at deferred-init completion time")
        self._deferred_init = ()
        if data is None:
            data = torch.zeros(self._shape, dtype=self.dtype, device=device)
            desc = initializer.InitDesc(self._name)
            if init is not None and init is not default_init:
                desc = initializer.InitDesc(self._name,
                                            {"force_weight": True})
            (init if init is not None else default_init)(desc, data)
        else:
            data = data.detach().to(device=device, dtype=self.dtype).clone()
        self._set_leaf(data)

    def _set_leaf(self, data: torch.Tensor) -> None:
        self._data = data
        self._hooked = False
        if self._grad_req != "null":
            data.requires_grad_(True)
            self._hook()
            autograd._track(self)

    # the marked-leaf protocol of autograd.backward on NDArray heads
    def _ag_leaf(self) -> Optional[torch.Tensor]:
        d = self._data
        if self._grad_req == "null" or d is None or not d.requires_grad:
            return None
        return d

    def _ag_receive(self, g: torch.Tensor) -> None:
        d = self._data
        with torch.no_grad():
            if self._grad_req == "add" and d.grad is not None:
                d.grad.add_(g)
            else:
                d.grad = g.contiguous()

    def _hook(self) -> None:
        if not self._hooked and self._data.requires_grad:
            self._data.register_hook(self._write_hook)
            self._hooked = True

    def _write_hook(self, grad):
        # with "write", this backward's gradient replaces the last one
        if self._grad_req == "write":
            self._data.grad = None
        return grad

    # -- access ----------------------------------------------------------
    def _check(self) -> torch.Tensor:
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    f"Parameter '{self._name}' has not been initialized yet "
                    "because initialization was deferred. Actual "
                    "initialization happens during the first forward pass.")
            raise RuntimeError(
                f"Parameter '{self._name}' has not been initialized. You "
                "should initialize parameters and create a Trainer first.")
        return self._data

    def data(self, ctx=None) -> torch.Tensor:
        """The value: the leaf tensor itself while recording (so gradients
        reach it), a detached view otherwise."""
        d = self._check()
        if ctx is not None and resolve_device(ctx) != d.device:
            raise RuntimeError(f"Parameter '{self._name}' lives on "
                               f"{d.device}, not {ctx}")
        return d if autograd.is_recording() else d.detach()

    def grad(self, ctx=None) -> torch.Tensor:
        """The gradient (zeros before the first backward, and where the
        last backward did not reach the parameter)."""
        d = self._check()
        if self._grad_req == "null":
            raise RuntimeError(f"Cannot get gradient array for Parameter "
                               f"'{self._name}' because grad_req='null'")
        return torch.zeros_like(d) if d.grad is None else d.grad

    def set_data(self, data) -> None:
        """Set the value (a tensor, an NDArray or array-like), cast to the
        parameter's dtype (completes a pending deferred initialization)."""
        from ..ndarray.ndarray import NDArray

        data = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(data)
        self.shape = tuple(data.shape)
        if self._data is None:
            if not self._deferred_init:
                raise RuntimeError(f"Parameter '{self._name}' has not been "
                                   "initialized")
            self._finish_deferred_init(data)
            return
        with torch.no_grad():
            self._data.copy_(data.to(self._data.device, self._data.dtype))

    def zero_grad(self) -> None:
        if self._data is not None and self._data.grad is not None:
            self._data.grad = None

    def cast(self, dtype) -> None:
        """Cast the value (and drop the gradient) to ``dtype``."""
        self.dtype = dtype_of(dtype)
        if self._data is not None:
            self._set_leaf(self._data.detach().to(self.dtype))
