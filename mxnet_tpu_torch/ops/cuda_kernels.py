"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel here
replaces one Pallas TPU kernel there; its CUDA source lives in ``csrc/`` and
is built by :mod:`._build` at first use.

Dispatch is by the device of the tensors: a wrapper given CUDA tensors
launches its kernel (or raises), and given CPU tensors runs the kernel's
plain PyTorch version, which is also what the tests and ``chip_smoke.py``
compare the kernel against. A failed build or launch raises; nothing falls
back from a kernel to its plain version.

Every wrapper adds one to its entry in :func:`launch_counts` where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_reference",
           "flash_head_dim_ok", "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}

# csrc/flash_attention_fwd.cu dtype codes
_FLASH_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def flash_head_dim_ok(head_dim: int) -> bool:
    """Whether the flash-attention kernel takes this head dim: a multiple of
    8 (rows are read as 16-byte vectors) and at most 128 (the Q fragments and
    the output accumulator of a warp's 16 rows stay in registers). Any
    sequence length is taken: the kernel masks the ragged last tile."""
    return head_dim % 8 == 0 and 8 <= head_dim <= 128


# ---------------------------------------------------------------------------
# flash attention, forward (replaces pallas_kernels._fwd_kernel)
# ---------------------------------------------------------------------------


def flash_attention_fwd_reference(q, k, v, causal: bool, sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: a dense fp32 softmax.
    q, k, v (bh, s, d) -> out (bh, s, d) in q's dtype, lse (bh, s, 1) fp32."""
    s = (q.float() * sm_scale) @ k.float().transpose(-1, -2)
    if causal:
        n = q.shape[-2]
        above = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.exp(s - lse) @ v.float()
    return out.to(q.dtype), lse


def _flash_fwd_fn():
    fn = _build.load("flash_attention_fwd").mxt_flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci,
                       ci, vp]
        fn.restype = ci
    return fn


def _launch_fwd(q, k, v, causal, sm_scale):
    bh, s, d = q.shape
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash attention kernel takes float32, float16 or "
                        f"bfloat16, not {q.dtype}")
    if not flash_head_dim_ok(d):
        raise ValueError(f"flash attention kernel needs head_dim % 8 == 0 "
                         f"and 8 <= head_dim <= 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel needs contiguous "
                             f"inputs; {name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel needs 16-byte aligned "
                             f"inputs; {name} is not")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    fn = _flash_fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, s, d, float(sm_scale), int(bool(causal)),
                _FLASH_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"cudaError_t {rc} (bh={bh}, s={s}, d={d}, "
                           f"{q.dtype})")
    _LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _fwd(q3, k3, v3, causal: bool, sm_scale: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (bh, s, d) tensors -> (out (bh, s, d), lse (bh, s, 1) fp32),
    like ``pallas_kernels._fwd``. CUDA tensors launch the kernel; CPU tensors
    run :func:`flash_attention_fwd_reference`."""
    if q3.dim() != 3 or q3.shape != k3.shape or q3.shape != v3.shape:
        raise ValueError(f"q, k, v must share one (bh, s, d) shape, got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype) or not q3.is_floating_point():
        raise TypeError(f"q, k, v must share one float dtype, got "
                        f"{q3.dtype}, {k3.dtype}, {v3.dtype}")
    if not (q3.device == k3.device == v3.device):
        raise ValueError(f"q, k, v on different devices: {q3.device}, "
                         f"{k3.device}, {v3.device}")
    if q3.device.type == "cuda":
        return _launch_fwd(q3, k3, v3, causal, sm_scale)
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, causal, sm_scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q3.device}")


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Tiled attention: softmax(q kᵀ · scale [+ causal mask]) v.

    q/k/v: (..., num_heads, seq, head_dim); leading dims are flattened into
    the kernel grid. Forward only: the backward kernels come with the LM
    train step, so inputs that require grad raise ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the PyTorch port: its "
            "backward kernels (pallas_kernels._bwd_dq_kernel and "
            "_bwd_dkv_kernel) are ported with the LM train step "
            "(make_train_step). Call it under torch.no_grad() or with "
            "inputs that do not require grad.")
    orig_shape = q.shape
    *lead, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bh = math.prod(lead)
    q3, k3, v3 = (t.reshape(bh, s, d) for t in (q, k, v))
    out, _ = _fwd(q3, k3, v3, causal, sm_scale)
    return out.reshape(orig_shape)
