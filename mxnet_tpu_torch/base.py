"""Errors, environment readers and small helpers.

Counterpart of ``mxnet_tpu/base.py:99-209``: ``MXNetError``,
``NotSupportedForSparseNDArray``, the ``env_*`` readers of user-named
variables, ``Registry`` and ``classproperty``; and the port's dtype names
(``torch_dtype``, ``op_dtype``, ``dtype_np``).

Not ported: the x64 / int32 envelope helpers (``base.py:47-90``,
``enable_x64``, ``int32_overflow_dim``, ``pow2_col_factor``,
``S64_DEMOTING_PLATFORMS``). They exist because JAX computes in 32 bits
unless asked and the TPU compiler demotes s64; torch has native int64 on
every device, so an index past 2^31 needs no envelope here.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as onp
import torch

__all__ = ["MXNetError", "NotSupportedForSparseNDArray", "env_str",
           "env_int", "env_bool", "Registry", "classproperty",
           "string_types", "numeric_types", "integer_types", "torch_dtype",
           "op_dtype", "dtype_np"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework, as the reference's
    ``mxnet.base.MXNetError``."""


class NotSupportedForSparseNDArray(MXNetError):
    def __init__(self, function, alias, *args):
        super().__init__(
            f"Function {function.__name__}"
            + (f" (alias {alias})" if alias else "")
            + " is not supported for sparse NDArray")


string_types = (str,)
numeric_types = (float, int)
integer_types = (int,)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """An environment variable of the user's (the reference's
    ``dmlc::GetEnv``); the port's own knobs go through ``config``."""
    return os.environ.get(name, default)


def env_int(name: str, default: int = 0) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "off", "")


class Registry:
    """A name -> object registry with case-insensitive keys (the
    reference's stand-in for ``dmlc::Registry``)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._store: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None,
                 allow_override: bool = False):
        def _do(obj, key):
            key = key.lower()
            if key in self._store and not allow_override:
                raise ValueError(f"{self.kind} '{key}' already registered")
            self._store[key] = obj
            return obj

        if callable(name):          # used as a bare decorator
            return _do(name, name.__name__)

        def deco(obj):
            return _do(obj, name or obj.__name__)

        return deco

    def get(self, name: str):
        key = name.lower()
        if key not in self._store:
            raise KeyError(f"{self.kind} '{name}' is not registered. "
                           f"Available: {sorted(self._store)}")
        return self._store[key]

    def find(self, name: str):
        return self._store.get(name.lower())

    def list(self):
        return sorted(self._store)


def classproperty(func: Callable):
    class _Desc:
        def __get__(self, obj, owner):
            return func(owner)

    return _Desc()


# -- dtypes ------------------------------------------------------------------

_NP_TO_TORCH = {
    onp.dtype("float16"): torch.float16, onp.dtype("float32"): torch.float32,
    onp.dtype("float64"): torch.float64, onp.dtype("int8"): torch.int8,
    onp.dtype("uint8"): torch.uint8, onp.dtype("int16"): torch.int16,
    onp.dtype("int32"): torch.int32, onp.dtype("int64"): torch.int64,
    onp.dtype("bool"): torch.bool,
    onp.dtype("complex64"): torch.complex64,
    onp.dtype("complex128"): torch.complex128,
}
_NP_TO_TORCH.update({
    onp.dtype(n): getattr(torch, n) for n in ("uint16", "uint32", "uint64")
    if hasattr(torch, n)})
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    (``"bfloat16"`` included). None is float32, MXNet's default."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None or (isinstance(dtype, str) and dtype == "None"):
        return torch.float32
    if str(dtype) in ("bfloat16", "torch.bfloat16"):
        return torch.bfloat16
    return _NP_TO_TORCH[onp.dtype(dtype)]


_X32 = {torch.int64: torch.int32, torch.float64: torch.float32,
        torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _X32[torch.uint64] = torch.uint32


def op_dtype(dtype) -> torch.dtype:
    """The dtype an op makes when asked for ``dtype`` (``cast``, the
    creation and sampling ops, index outputs): a 64-bit type is its 32-bit
    one, as the reference's ops compute in JAX's 32-bit mode. Only array
    creation (``nd.array``) keeps int64, as there."""
    dt = torch_dtype(dtype)
    return _X32.get(dt, dt)


def dtype_np(dtype: torch.dtype):
    """The numpy dtype of a torch dtype; ``torch.bfloat16`` itself for
    bfloat16, which numpy lacks."""
    return _TORCH_TO_NP.get(dtype, dtype)
