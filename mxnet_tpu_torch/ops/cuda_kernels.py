"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel here
replaces one Pallas TPU kernel there; its CUDA source lives in ``csrc/`` and
is built by :mod:`._build` at first use. So far: flash attention, forward
(``csrc/flash_attention_fwd.cu``) and backward (``csrc/flash_attention_bwd.cu``,
a dq kernel and a dk/dv kernel), joined in one ``torch.autograd.Function``.

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
from torch.autograd.function import once_differentiable

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_reference",
           "flash_attention_bwd_reference", "flash_head_dim_ok",
           "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0}

# dtype codes of csrc/flash_attention_{fwd,bwd}.cu
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


def _c_fn(source: str, symbol: str, n_ptr: int):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``: ``n_ptr``
    pointers, then (bh, s, d, sm_scale, causal, dtype, stream)."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [ci, ci, ci, ctypes.c_float, ci, ci, vp]
        fn.restype = ci
    return fn


def _check_kernel_inputs(what: str, d: int, dtype, **tensors) -> None:
    if dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash attention {what} kernel takes float32, "
                        f"float16 or bfloat16, not {dtype}")
    if not flash_head_dim_ok(d):
        raise ValueError(f"flash attention {what} kernel needs head_dim % 8 "
                         f"== 0 and 8 <= head_dim <= 128, got {d}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"flash attention {what} kernel needs "
                             f"contiguous inputs; {name} has strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention {what} kernel needs 16-byte "
                             f"aligned inputs; {name} is not")


def _launch(source: str, symbol: str, ptrs, q, causal, sm_scale) -> None:
    """Launch a flash-attention kernel on q's device and current stream;
    raise on a non-zero cudaError_t."""
    bh, s, d = q.shape
    fn = _c_fn(source, symbol, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), bh, s, d, float(sm_scale),
                int(bool(causal)), _FLASH_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel {symbol} launch failed: "
                           f"cudaError_t {rc} (bh={bh}, s={s}, d={d}, "
                           f"{q.dtype})")


def _launch_fwd(q, k, v, causal, sm_scale):
    bh, s, d = q.shape
    _check_kernel_inputs("forward", d, q.dtype, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "mxt_flash_attention_fwd",
            (q, k, v, out, lse), q, causal, sm_scale)
    _LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _check_qkv(q3, k3, v3) -> None:
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


def _fwd(q3, k3, v3, causal: bool, sm_scale: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (bh, s, d) tensors -> (out (bh, s, d), lse (bh, s, 1) fp32),
    like ``pallas_kernels._fwd``. CUDA tensors launch the kernel; CPU tensors
    run :func:`flash_attention_fwd_reference`."""
    _check_qkv(q3, k3, v3)
    if q3.device.type == "cuda":
        return _launch_fwd(q3, k3, v3, causal, sm_scale)
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, causal, sm_scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q3.device}")


# ---------------------------------------------------------------------------
# flash attention, backward (replaces pallas_kernels._bwd_dq_kernel and
# _bwd_dkv_kernel)
# ---------------------------------------------------------------------------


def _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """p and ds (fp32) of the backward, by the TPU kernels' formulas."""
    qf, kf = q.float(), k.float()
    s = (qf @ kf.transpose(-1, -2)) * sm_scale
    if causal:
        n = q.shape[-2]
        above = torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.exp(s - lse)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta) * sm_scale
    return p, ds


def _bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of the dq kernel: dq = ds k, in q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return (ds @ k.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of the dk/dv kernel: dk = dsᵀ q, dv = pᵀ do."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ do.float()
    return dk.to(q.dtype), dv.to(q.dtype)


def _delta(o, do) -> torch.Tensor:
    """rowsum(do * o) in fp32, (bh, s, 1), as ``pallas_kernels._bwd``
    computes it outside the kernels."""
    return (do.float() * o.float()).sum(-1, keepdim=True)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool,
                                  sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: dense fp32, the
    formulas of the TPU kernels (``p = exp(s * scale - lse)``,
    ``ds = p * (do vᵀ - δ) * scale`` with ``δ = rowsum(do * o)``).
    (bh, s, d) tensors and lse (bh, s, 1) -> (dq, dk, dv) in q's dtype."""
    delta = _delta(o, do)
    dq = _bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale))


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd", "mxt_flash_attention_bwd_dq",
            (q, k, v, do, lse, delta, dq), q, causal, sm_scale)
    _LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd", "mxt_flash_attention_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, causal, sm_scale)
    _LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal, sm_scale):
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward kernels need do in q's "
                        f"dtype {q.dtype} and lse in float32, got "
                        f"{do.dtype} and {lse.dtype}")
    _check_kernel_inputs("backward", q.shape[-1], q.dtype, q=q, k=k, v=v,
                         do=do, lse=lse)
    delta = _delta(o, do)
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *_launch_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale))


def _bwd(q3, k3, v3, o3, lse, do3, causal: bool, sm_scale: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward on (bh, s, d) tensors -> (dq, dk, dv) in q's dtype, like
    ``pallas_kernels._bwd``: ``o3`` and ``lse`` (bh, s, 1) fp32 are the
    forward's outputs, ``do3`` the gradient of ``o3``. CUDA tensors launch
    the dq and dk/dv kernels; CPU tensors run
    :func:`flash_attention_bwd_reference`."""
    _check_qkv(q3, k3, v3)
    if o3.shape != q3.shape or do3.shape != q3.shape or \
            lse.shape != (*q3.shape[:2], 1):
        raise ValueError(f"o and do must have q's shape {tuple(q3.shape)} "
                         f"and lse {(*q3.shape[:2], 1)}, got "
                         f"{tuple(o3.shape)}, {tuple(do3.shape)}, "
                         f"{tuple(lse.shape)}")
    if q3.device.type == "cuda":
        # the gradient of a transposed view arrives non-contiguous
        return _launch_bwd(q3, k3, v3, o3, lse, do3.contiguous(), causal,
                           sm_scale)
    if q3.device.type == "cpu":
        return flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3,
                                             causal, sm_scale)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q3.device}")


class _Flash(torch.autograd.Function):
    """Flash attention with its backward, in place of the JAX package's
    ``_flash`` custom VJP: the forward saves (q, k, v, out, lse), the
    backward runs :func:`_bwd`. Like the reference, it has no double
    backward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, sm_scale):
        out, lse = _fwd(q3, k3, v3, causal, sm_scale)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q3, k3, v3, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q3, k3, v3, out, lse, dout, ctx.causal,
                          ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Tiled attention: softmax(q kᵀ · scale [+ causal mask]) v.

    q/k/v: (..., num_heads, seq, head_dim); leading dims are flattened into
    the kernel grid. Differentiable: where grad is enabled and an input
    requires it, the forward saves its inputs, output and lse, and the
    backward launches the dq and dk/dv kernels. Otherwise only the forward
    runs and nothing is saved.
    """
    orig_shape = q.shape
    *lead, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bh = math.prod(lead)
    q3, k3, v3 = (t.reshape(bh, s, d) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _Flash.apply(q3, k3, v3, causal, sm_scale)
    else:
        out, _ = _fwd(q3, k3, v3, causal, sm_scale)
    return out.reshape(orig_shape)
