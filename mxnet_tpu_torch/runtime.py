"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``,
reference ``python/mxnet/runtime.py:75-89``).

Features reflect what this process can use: the reference's names where
their meaning carries over (``CPU``, ``GPU``, ``CUDA``, ``CUDNN``,
``NCCL``, ``BF16``, ``INT64_TENSOR_SIZE``, ``DIST_KVSTORE``, ``OPENCV``,
``SIGNAL_HANDLER``, ``PROFILER``), and the port's own: ``NVCC`` (the CUDA
compiler that builds the hand-written kernels), ``TRITON``, and
``SM_90A`` (a Hopper card, which the kernels are built for). ``TPU``,
``XLA`` and ``PALLAS`` are listed and off.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
from typing import Dict, List

import torch

__all__ = ["Feature", "feature_list", "Features"]


class Feature:
    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _nvcc() -> bool:
    if shutil.which("nvcc"):
        return True
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.exists(os.path.join(home, "bin", "nvcc"))


def _detect() -> Dict[str, bool]:
    cuda = torch.cuda.is_available()
    sm90 = cuda and any(torch.cuda.get_device_capability(i) == (9, 0)
                        for i in range(torch.cuda.device_count()))
    dist = torch.distributed.is_available()
    return {
        "TPU": False,
        "GPU": cuda,
        "CPU": True,
        "XLA": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": dist and cuda and torch.distributed.is_nccl_available(),
        "NVCC": _nvcc(),
        "TRITON": importlib.util.find_spec("triton") is not None,
        "SM_90A": sm90,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "PALLAS": False,
        "DIST_KVSTORE": dist,
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "BLAS_OPEN": True,
        "SIGNAL_HANDLER": False,
        "PROFILER": True,
    }


class Features(dict):
    """Mapping of feature name -> Feature (reference ``runtime.Features``)."""

    instance = None

    def __init__(self):
        super().__init__(
            (k, Feature(k, v)) for k, v in _detect().items())

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name: str) -> bool:
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"feature '{feature_name}' does not exist")
        return self[feature_name].enabled


def feature_list() -> List[Feature]:
    """List of runtime features (reference ``runtime.feature_list``)."""
    if Features.instance is None:
        Features.instance = Features()
    return list(Features.instance.values())
