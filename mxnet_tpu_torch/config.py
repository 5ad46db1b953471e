"""The environment knobs the port reads.

Counterpart of ``mxnet_tpu/config.py`` (``declare``/``get``/``refresh``),
holding only the knobs that the port's code reads so far. Each keeps the
reference's name, type and default. A knob is read from the environment on
first use and cached until :func:`refresh`.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple, Optional

__all__ = ["VARIABLES", "get", "refresh"]


class EnvVar(NamedTuple):
    name: str
    type: Callable
    default: Any
    doc: str


VARIABLES: Dict[str, EnvVar] = {v.name: v for v in (
    EnvVar("MXNET_FUSED_EPILOGUE", int, 0,
           "Fused conv/BN/ReLU epilogue for the model-zoo ResNet bottleneck "
           "1x1 convs (ops/cuda_kernels.py matmul_stats + matmul_epilogue "
           "through conv1x1_bn_act_train) under hybridized training: 0 = "
           "off, 1 = on where the input lies on a CUDA device, 2 = also on "
           "the CPU through the kernels' plain versions (tests)."),
    EnvVar("MXNET_FUSED_CONV_BN", int, 0,
           "Fusion of conv + BatchNorm(training) pairs into the conv + "
           "batch-statistics kernels (ops/cuda_kernels.py matmul_bn_stats "
           "for 1x1 convs at any stride, convkxk_bn_stats for KxK stride-1 "
           "convs) under hybridized training: 0 = off, 1 = on where the "
           "input lies on a CUDA device, 2 = also on the CPU through the "
           "kernels' plain versions (tests)."),
    EnvVar("MXNET_FUSED_CONV_BN_KINDS", str, "1x1,kxk",
           "Which conv + BatchNorm fusion kinds MXNET_FUSED_CONV_BN admits: "
           "a comma-separated set of '1x1' (any-stride 1x1) and 'kxk' "
           "(KxK stride-1). Another kind raises ValueError."),
    EnvVar("MXNET_BN_TWO_PASS_VAR", bool, False,
           "BatchNorm batch variance by the two-pass shifted formula instead "
           "of the single-pass E[x^2] - E[x]^2 (one extra pass; use when "
           "activation |mean| >> std makes the single pass cancel)."),
    EnvVar("MXNET_INT8_PALLAS", int, 0,
           "The retired route of quantized convs through the int8 matmul "
           "kernel, kept as the reference keeps it: quantized convs always "
           "run the exact s8 -> s32 convolution (contrib/quantization.py). "
           "0 (the only valid value) counts each conv that the route would "
           "have claimed (quantization.pallas_skipped_count, logged once); "
           "nonzero refuses with MXNetError."),
)}

_CACHE: Dict[str, Any] = {}


def _parse(var: EnvVar, raw: str) -> Any:
    if var.type is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return var.type(raw)


def get(name: str) -> Any:
    """The knob's value: the environment's, parsed and cached, else its
    default. Unknown names raise ``KeyError``."""
    if name not in VARIABLES:
        raise KeyError(f"undeclared env var {name}")
    if name in _CACHE:
        return _CACHE[name]
    var = VARIABLES[name]
    raw = os.environ.get(name)
    if raw is None:
        return var.default
    val = _CACHE[name] = _parse(var, raw)
    return val


def refresh(name: Optional[str] = None) -> None:
    """Drop cached reads (all, or one knob's)."""
    if name is None:
        _CACHE.clear()
    else:
        _CACHE.pop(name, None)
