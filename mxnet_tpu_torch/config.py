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
    EnvVar("MXNET_COMPILED_STEP", int, 1,
           "Compiled whole train step (cached_step.TrainStep through "
           "Trainer.compile_step, and models.make_train_step): forward, "
           "backward and optimizer update captured as one CUDA graph over "
           "fixed buffers, cached by input shapes and dtypes, the route "
           "knobs and the parameters' storage, and replayed: 1 dispatch a "
           "step. 1 = on (the setups TrainStep cannot capture run the eager "
           "tape and name their reason), 0 = the eager tape everywhere: "
           "also parallel.ShardedTrainer's step and the recorded forward "
           "of a hybridized block run eagerly."),
    EnvVar("MXNET_COMPILED_STEP_CACHE", int, 16,
           "Per-owner cap of the program store's 'train_step' namespace "
           "(LRU over program keys); a new key past the cap evicts the "
           "oldest program and frees its graph."),
    EnvVar("MXNET_FORWARD_CACHE", int, 32,
           "Per-owner cap of the program store's 'hybrid_forward' namespace "
           "(the captured forwards of a hybridized block, LRU)."),
    EnvVar("MXNET_BACKWARD_DO_MIRROR", bool, False,
           "Recompute the forward during the backward (torch.utils."
           "checkpoint) instead of keeping activations alive: about one "
           "extra forward of work for less peak memory (the reference's "
           "mirror path); ShardedTrainer(remat=None) follows it."),
    EnvVar("MXNET_SHAPE_BUCKETS", str, "pow2",
           "Shape-bucket grid for padded programs (serving.BucketPolicy): "
           "'pow2' (round a dynamic axis up to the next power of two), "
           "'none' (exact shapes, bucketing off), or an ascending comma "
           "list '8,16,32,64' (a length above the largest bucket keeps its "
           "exact shape). Used by Trainer.compile_step(bucket=True) and "
           "hybridize(bucket=True), which verify the padded result against "
           "the unpadded one once per bucket."),
    EnvVar("MXNET_SERVE_VERIFY", int, 1,
           "hybridize(bucket=True) and compile_step(bucket=True): verify "
           "the first padded call per signature against the unpadded one. "
           "1 = bit-exact passes, and for a forward a last-ulp difference "
           "(rtol 1e-5, atol 1e-6) too; anything larger refuses bucketing. "
           "2 = strict: bit-exact or refuse. 0 = trust padding unchecked."),
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
