"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``. Each kernel here
replaces one Pallas TPU kernel there; its CUDA source lives in ``csrc/`` and
is built by :mod:`._build` at first use. So far: flash attention, forward
(``csrc/flash_attention_fwd.cu``) and backward (``csrc/flash_attention_bwd.cu``,
a dq kernel that also computes δ, and a dk/dv kernel), joined in one
``torch.autograd.Function``; the fused 1x1-conv / batch-norm epilogue pair
(``csrc/conv_bn_epilogue.cu``: ``matmul_stats`` and ``matmul_epilogue``),
joined in :func:`conv1x1_bn_act_train`, the counterpart of
``pallas_kernels.py:485-728``;
and the conv + batch-norm statistics kernels, ``matmul_bn_stats`` (in the
same source) and ``convkxk_bn_stats`` (``csrc/convkxk_bn_stats.cu``), behind
:func:`conv1x1_bn_stats_train` and :func:`convkxk_bn_stats_train`, the
counterparts of ``pallas_kernels.py:316-481`` and ``:847-1047``; and the
int8 matmul (``csrc/int8_matmul.cu``), :func:`int8_matmul`, the counterpart
of ``pallas_kernels.py:752-829``.

Dispatch is by the device of the tensors: a wrapper given CUDA tensors
launches its kernel (or raises), and given CPU tensors runs the kernel's
plain PyTorch version, which is also what the tests and ``chip_smoke.py``
compare the kernel against. A failed build or launch raises; nothing falls
back from a kernel to its plain version.

Every wrapper adds one to its entry in :func:`launch_counts` where it
launches its kernel, and nowhere else: under stream capture that is the
launch the graph records, so a replayed graph, which runs no Python, moves
no count. :func:`kernel_of` names the wrapper of a kernel in a profiler
trace, where a replay's kernels appear one by one.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_reference",
           "flash_attention_bwd_reference", "flash_head_dim_ok",
           "flash_fwd_q_tile", "epilogue_tile_n",
           "matmul_stats", "matmul_stats_reference", "matmul_epilogue",
           "matmul_epilogue_reference", "epilogue_fits",
           "conv1x1_bn_act_train", "matmul_bn_stats",
           "matmul_bn_stats_reference", "conv1x1_bn_stats_train",
           "convkxk_fits", "convkxk_bn_stats", "convkxk_bn_stats_reference",
           "convkxk_bn_stats_train", "int_mm_fits", "s8_matmul_s32",
           "int8_fits", "int8_matmul", "int8_matmul_reference",
           "launch_counts", "reset_launch_counts", "kernel_of"]

_LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0,
                             "matmul_stats": 0,
                             "matmul_epilogue": 0,
                             "matmul_bn_stats": 0,
                             "convkxk_bn_stats": 0,
                             "int8_matmul": 0}

# dtype codes of csrc/flash_attention_{fwd,bwd}.cu
_FLASH_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# The csrc kernels' names as a trace shows them, demangled ("void
# gemm_wgmma<128, 2, 1>(...)") or mangled ("_Z10gemm_wgmmaILi128ELi2ELi1E..."),
# by the wrapper that launches them. gemm_wgmma's KIND and stats_fp32's
# operand and STORE flag tell its four users apart.
_NOT_AFTER = r"(?<![A-Za-z])"
_TRACE_NAMES = (
    (re.compile(_NOT_AFTER + r"fwd_(?:wgmma|fp32)(?![a-z])"),
     "flash_attention_fwd"),
    (re.compile(_NOT_AFTER + r"dq_(?:wgmma|fp32)(?![a-z])"),
     "flash_attention_bwd_dq"),
    (re.compile(_NOT_AFTER + r"dkv_(?:wgmma|fp32)(?![a-z])"),
     "flash_attention_bwd_dkv"),
    (re.compile(_NOT_AFTER + r"epilogue_fp32(?![a-z])"), "matmul_epilogue"),
    (re.compile(_NOT_AFTER + r"int8_wgmma(?![a-z])"), "int8_matmul"),
)
_GEMM_NAME = re.compile(r"(?<![A-Za-z])gemm_wgmma(?:<\s*\d+\s*,\s*\d+\s*,"
                        r"\s*(\d)\s*>|ILi\d+ELi\d+ELi(\d)E)")
_GEMM_KINDS = {"0": "matmul_epilogue", "1": "matmul_stats",
               "2": "matmul_bn_stats", "3": "convkxk_bn_stats"}
_STATS_FP32_NAME = re.compile(
    r"(?<![A-Za-z])stats_fp32(?:<\s*(Dense32|Conv32)\s*,\s*(true|false)"
    r"|I\d+(Dense32|Conv32)Lb([01]))")


def kernel_of(name: str) -> Optional[str]:
    """The :func:`launch_counts` entry of the kernel a profiler trace names
    ``name``, or None for a kernel that is not the port's own."""
    m = _GEMM_NAME.search(name)
    if m:
        return _GEMM_KINDS.get(m[1] or m[2])
    m = _STATS_FP32_NAME.search(name)
    if m:
        if (m[1] or m[3]) == "Conv32":
            return "convkxk_bn_stats"
        return ("matmul_bn_stats" if (m[2] or m[4]) in ("true", "1")
                else "matmul_stats")
    for pattern, wrapper in _TRACE_NAMES:
        if pattern.search(name):
            return wrapper
    return None


def flash_head_dim_ok(head_dim: int) -> bool:
    """Whether the flash-attention kernels take this head dim: a multiple of
    8 (a TMA map's row stride is a multiple of 16 bytes; the fp32 kernels
    read 16-byte vectors) and at most 128 (two 64-column TMA boxes, and the
    output accumulator of a warpgroup's 64 rows stays in registers). Any
    sequence length is taken: the copies zero-fill the ragged last tile and
    the kernels mask it."""
    return head_dim % 8 == 0 and 8 <= head_dim <= 128


def flash_fwd_q_tile(bh: int, s: int, dtype, sm_count: int) -> int:
    """Query rows per CTA of the forward kernel on a card with ``sm_count``
    SMs, as ``q_rows`` in ``csrc/flash_attention_fwd.cu`` chooses them (its
    ``mxt_flash_attention_fwd_q_tile`` reports the choice on the card): 64
    for float32; for 16-bit inputs 128 (two consumer warpgroups) where
    bh * ceil(s / 128) such CTAs fill every SM, else 64, so that a small
    request still spreads over the card."""
    if dtype == torch.float32:
        return 64
    return 128 if bh * -(-s // 128) >= sm_count else 64


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
    computes it outside the kernels: the plain version's δ. On CUDA the dq
    kernel computes it."""
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


def _launch_bwd_dq(q, k, v, o, do, lse, causal, sm_scale):
    """The dq kernel: (dq, δ). It computes δ = rowsum(do * o) in fp32 for
    its rows, uses it, and stores it to a (bh, s, 1) scratch that the dk/dv
    kernel reads."""
    dq = torch.empty_like(q)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd", "mxt_flash_attention_bwd_dq",
            (q, k, v, o, do, lse, delta, dq), q, causal, sm_scale)
    _LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd", "mxt_flash_attention_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, causal, sm_scale)
    _LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, causal, sm_scale):
    if do.dtype != q.dtype or o.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward kernels need o and do in "
                        f"q's dtype {q.dtype} and lse in float32, got "
                        f"{o.dtype}, {do.dtype} and {lse.dtype}")
    _check_kernel_inputs("backward", q.shape[-1], q.dtype, q=q, k=k, v=v,
                         o=o, do=do, lse=lse)
    # dq first: it writes the δ that the dk/dv kernel reads (same stream)
    dq, delta = _launch_bwd_dq(q, k, v, o, do, lse, causal, sm_scale)
    return (dq, *_launch_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale))


def _bwd(q3, k3, v3, o3, lse, do3, causal: bool, sm_scale: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward on (bh, s, d) tensors -> (dq, dk, dv) in q's dtype, like
    ``pallas_kernels._bwd``: ``o3`` and ``lse`` (bh, s, 1) fp32 are the
    forward's outputs, ``do3`` the gradient of ``o3``. CUDA tensors launch
    the dq kernel (which also computes δ) and then the dk/dv kernel, nothing
    else; CPU tensors run :func:`flash_attention_bwd_reference`."""
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


# ---------------------------------------------------------------------------
# fused 1x1-conv / batch-norm epilogue (replaces pallas_kernels.
# _mm_statsonly_kernel and _mm_epilogue_kernel)
# ---------------------------------------------------------------------------

# dtype codes of csrc/conv_bn_epilogue.cu
_MM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def epilogue_fits(m: int, k: int, n: int, dtype) -> bool:
    """Whether the matmul-stats and matmul-epilogue kernels take an (m, k) x
    (k, n) product: fp32 or bf16, k and n multiples of 8 (the TMA maps' row
    strides are multiples of 16 bytes; the other kernels read 16-byte
    vectors), any m >= 1 (the copies zero-fill the ragged last m-tile and
    the stores clip it). A Hopper rule of the port's own: the TPU's
    ``fused_blocks`` models Mosaic's (8, 128) tiling instead."""
    return (dtype in _MM_DTYPES and m >= 1 and k >= 8 and n >= 8
            and k % 8 == 0 and n % 8 == 0)


def epilogue_tile_n(n: int) -> int:
    """Output columns per tile of the bf16 matmul-epilogue kernel, as
    ``wg::tile_n`` in ``csrc/conv_bn_epilogue.cu`` chooses them (its
    ``mxt_matmul_epilogue_tile_n`` reports the choice): the least of 64, 128
    and 256 that covers n, so that one tile spans the whole of n up to 256
    and x is read once; 256 for wider n, whose tiles of one row block run
    next to each other."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def matmul_stats_reference(x, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the matmul-stats kernel: z = x @ w in fp32 (exact
    products, fp32 sums), then per-column (Σz, Σz²). x (M, K), w (K, N)."""
    z = x.float() @ w.float()
    return z.sum(0), (z * z).sum(0)


def matmul_epilogue_reference(x, w, scale, shift, residual=None,
                              relu: bool = False) -> torch.Tensor:
    """Plain version of the matmul-epilogue kernel: act((x @ w) · scale +
    shift [+ residual]) in fp32, rounded once to x's dtype."""
    out = (x.float() @ w.float()) * scale.float() + shift.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype)


def _check_mm(what: str, x, w, **vectors) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: x (M, K) and w (K, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if w.dtype != x.dtype or not epilogue_fits(m, k, n, x.dtype):
        raise ValueError(f"{what} takes fp32 or bf16 x and w of one dtype "
                         f"with K and N multiples of 8, got ({m}, {k}) x "
                         f"({k}, {n}) {x.dtype}/{w.dtype}")
    for name, v in vectors.items():
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{what}: {name} must be ({n},), got "
                             f"{tuple(v.shape)}")
    devs = {t.device for t in (x, w, *vectors.values()) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on different devices {devs}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def _mm_fn(source: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``: ``n_ptr``
    pointers, ``n_int`` ints, then the stream."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
        fn.restype = ci
    return fn


def _kernel_operands(what: str, x, w, **more) -> torch.Tensor:
    """Check what the CUDA kernels need and return w^T as the contiguous
    (N, K) operand they read (a view where w is the transpose of a
    contiguous (N, K) weight, as at every conv site)."""
    wt = w.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    for name, t in (("x", x), ("w", wt), *more.items()):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous inputs; {name} "
                             f"has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned inputs; "
                             f"{name} is not")
    return wt


def _run(what: str, symbol: str, ptrs, ints, device,
         source: str = "conv_bn_epilogue") -> None:
    fn = _mm_fn(source, symbol, len(ptrs), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(0 if t is None else t.data_ptr() for t in ptrs), *ints,
                stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc} "
                           f"(M, N, K, ... = {ints})")


def _stat_parts(source: str, symbol: str, code: int, m: int, n: int,
                device) -> torch.Tensor:
    """The (2, m_tiles, n) fp32 scratch for a kernel's per-CTA partial
    sums of z and z², m_tiles from the kernel's rows per CTA (the C entry
    point ``symbol`` of ``csrc/<source>.cu``)."""
    bm = getattr(_build.load(source), symbol)(code)
    return torch.empty((2, -(-m // bm), n), dtype=torch.float32,
                       device=device)


def _launch_stats_wgmma(what: str, x, wt, y, relu: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 statistics kernel (y None: matmul_stats): (s, ss) summed on
    the card, by the last CTA of each n-tile, from the per-CTA rows."""
    (m, k), n = x.shape, wt.shape[0]
    with torch.cuda.device(x.device):
        rows = _build.load("conv_bn_epilogue").mxt_stats_rows(m, n)
    if rows < 1:
        raise RuntimeError(f"{what}: mxt_stats_rows({m}, {n}) failed")
    # the launch's own scratch: 2 x rows x n partial sums, then a counter
    # per n-tile of at least 64 columns, which the launch zeroes
    scratch = torch.empty(2 * rows * n + -(-n // 64), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((2, n), dtype=torch.float32, device=x.device)
    if y is None:
        _run(what, "mxt_matmul_stats_wgmma", (x, wt, scratch, sums),
             (m, n, k, rows), x.device)
    else:
        _run(what, "mxt_matmul_bn_stats_wgmma", (x, wt, y, scratch, sums),
             (m, n, k, rows, int(bool(relu))), x.device)
    return sums[0], sums[1]


def _launch_matmul_stats(x, w) -> Tuple[torch.Tensor, torch.Tensor]:
    wt = _kernel_operands("matmul_stats", x, w)
    if x.dtype == torch.bfloat16:
        s, ss = _launch_stats_wgmma("matmul_stats", x, wt, None, False)
        _LAUNCHES["matmul_stats"] += 1
        return s, ss
    (m, k), n = x.shape, w.shape[1]
    code = _MM_DTYPES[x.dtype]
    parts = _stat_parts("conv_bn_epilogue", "mxt_conv_bn_m_tile", code, m,
                        n, x.device)
    _run("matmul_stats", "mxt_matmul_stats", (x, wt, parts[0], parts[1]),
         (m, n, k, code), x.device)
    _LAUNCHES["matmul_stats"] += 1
    # the second pass: the per-m-tile partials summed in a fixed order
    s, ss = parts.sum(1)
    return s, ss


def matmul_stats(x, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column ``(Σ(x@w), Σ(x@w)²)`` in fp32 without writing the
    product, like ``pallas_kernels.matmul_stats``: x (M, K), w (K, N) ->
    (s (N,), ss (N,)). CUDA tensors launch the kernel; CPU tensors run
    :func:`matmul_stats_reference`."""
    _check_mm("matmul_stats", x, w)
    if x.device.type == "cuda":
        return _launch_matmul_stats(x, w)
    return matmul_stats_reference(x, w)


def _launch_matmul_epilogue(x, w, scale, shift, residual, relu
                            ) -> torch.Tensor:
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"matmul_epilogue kernel reads the residual in x's "
                        f"dtype {x.dtype}, got {residual.dtype}")
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    wt = _kernel_operands("matmul_epilogue", x, w, scale=scale, shift=shift,
                          residual=residual)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _run("matmul_epilogue", "mxt_matmul_epilogue",
         (x, wt, scale, shift, residual, out),
         (m, n, k, int(bool(relu)), _MM_DTYPES[x.dtype]), x.device)
    _LAUNCHES["matmul_epilogue"] += 1
    return out


def matmul_epilogue(x, w, scale, shift, residual=None,
                    relu: bool = False) -> torch.Tensor:
    """``act((x @ w) · scale + shift [+ residual])`` in one pass, like
    ``pallas_kernels.matmul_epilogue``: x (M, K), w (K, N), scale and shift
    per-column fp32 (N,), residual (M, N) in x's dtype, added before the
    relu. Returns (M, N) in x's dtype. CUDA tensors launch the kernel; CPU
    tensors run :func:`matmul_epilogue_reference`."""
    _check_mm("matmul_epilogue", x, w, scale=scale, shift=shift)
    if residual is not None and (
            tuple(residual.shape) != (x.shape[0], w.shape[1])
            or residual.device != x.device):
        raise ValueError(f"matmul_epilogue: residual must be "
                         f"{(x.shape[0], w.shape[1])} on {x.device}, got "
                         f"{tuple(residual.shape)} on {residual.device}")
    if x.device.type == "cuda":
        return _launch_matmul_epilogue(x, w, scale, shift, residual, relu)
    return matmul_epilogue_reference(x, w, scale, shift, residual, relu)


class _Conv1x1BnAct(torch.autograd.Function):
    """1x1 NHWC conv + train-mode batch norm + optional residual + optional
    ReLU, in place of the JAX package's ``_c1x1_act_train_for`` custom VJP.
    The forward runs the two kernels; the backward recomputes z in fp32 with
    one dense matmul and runs the batch-norm chain in plain torch, by the
    reference's formulas. Like the reference, it has no double backward."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, residual, bias, eps, relu,
                fix_gamma):
        n, h, wd, cin = x.shape
        cout = w.shape[0]
        m = n * h * wd
        x2 = x.reshape(m, cin)
        w2 = w.reshape(cout, cin).t()          # (K, N) view of OHWI memory
        s, ss = matmul_stats(x2, w2)
        mean = s / m
        var = torch.clamp_min(ss / m - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        g = torch.ones_like(inv) if fix_gamma else gamma.float()
        sc = inv * g
        bi = beta.float() - mean * sc
        r2 = None if residual is None else residual.reshape(m, cout)
        out = matmul_epilogue(x2, w2, sc, bi, residual=r2, relu=relu)
        ctx.save_for_backward(x, w, gamma, beta, residual, mean, var)
        ctx.eps, ctx.relu, ctx.fix_gamma = eps, relu, fix_gamma
        ctx.bias_dtype = None if bias is None else bias.dtype
        if bias is not None:
            mean = mean + bias.float()
        return out.reshape(n, h, wd, cout), mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gout, gmean, gvar):
        x, w, gamma, beta, r, mean, var = ctx.saved_tensors
        n, h, wd, cin = x.shape
        cout = w.shape[0]
        m = n * h * wd
        x2 = x.reshape(m, cin)
        w2 = w.reshape(cout, cin)
        # z recomputed in fp32 (the reference's preferred_element_type)
        z = x2.float() @ w2.float().t()
        inv = torch.rsqrt(var + ctx.eps)
        g = torch.ones_like(inv) if ctx.fix_gamma else gamma.float()
        sc = inv * g
        ga = gout.reshape(m, cout)        # exact in fp32 wherever it enters
        if ctx.relu:
            a = torch.addcmul(beta.float() - mean * sc, z, sc)  # bn output
            if r is not None:
                a += r.reshape(m, cout)
            ga = torch.where(a > 0, ga, 0.0)
            del a
        # the residual adds under the relu, so it shares ga
        dr = None if r is None else ga.to(r.dtype).reshape(r.shape)
        xhat = z.sub_(mean).mul_(inv)
        dbeta_f = ga.sum(0, dtype=torch.float32)
        dgamma_f = (ga * xhat).sum(0)
        # the reference's
        #   dz = sc (ga - dbeta/m - xhat dgamma/m)          (the BN chain)
        #        + gmean/m + gvar 2 (z - mean)/m            (direct cotangents)
        # regrouped per column, with z - mean = xhat / inv, so that the
        # (m, cout) operands take two passes: dz = ga sc + c0 + xhat c1
        c0 = (gmean.float() - sc * dbeta_f) / m
        c1 = (2.0 * gvar.float() / inv - sc * dgamma_f) / m
        dz = torch.addcmul(c0, ga, sc).addcmul_(xhat, c1)
        del xhat
        dz = dz.to(x.dtype)
        dx = dz @ w2.to(dz.dtype)
        dw = dz.t() @ x2
        dgamma = (torch.zeros_like(gamma) if ctx.fix_gamma
                  else dgamma_f.to(gamma.dtype))
        # the bias reaches the returned mean only
        dbias = None if ctx.bias_dtype is None else gmean.to(ctx.bias_dtype)
        return (dx.reshape(x.shape).to(x.dtype),
                dw.reshape(w.shape).to(w.dtype), dgamma,
                dbeta_f.to(beta.dtype), dr, dbias, None, None, None)


def conv1x1_bn_act_train(x, w, gamma, beta, residual=None, eps: float = 1e-5,
                         relu: bool = True, fix_gamma: bool = False,
                         bias=None) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Differentiable fused 1x1 conv + train-mode batch norm + residual add
    + ReLU, like ``pallas_kernels.conv1x1_bn_act_train``: x (N, H, W, Cin)
    NHWC, w (Cout, 1, 1, Cin) OHWI, residual (N, H, W, Cout) added before
    the relu -> ``(out, mean, var)``, the stats fp32. The conv output is
    never written: :func:`matmul_stats` gives the batch statistics and
    :func:`matmul_epilogue` the normalised output. The caller checks
    :func:`epilogue_fits` first.

    ``bias``, a conv bias, shifts z and the batch mean equally, so the
    output does not depend on it: it is added to the returned mean only,
    as the reference's op adds it, and its gradient is the mean's
    cotangent. Passing it here keeps it in the graph, so a backward writes
    that gradient (zero where only the running statistics read the mean)
    as the reference's does."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:3] != (1, 1) or \
            w.shape[3] != x.shape[3]:
        raise ValueError(f"conv1x1_bn_act_train: x (N, H, W, Cin) and w "
                         f"(Cout, 1, 1, Cin) expected, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if residual is not None and tuple(residual.shape) != \
            (*x.shape[:3], w.shape[0]):
        raise ValueError(f"conv1x1_bn_act_train: residual must be "
                         f"{(*x.shape[:3], w.shape[0])}, got "
                         f"{tuple(residual.shape)}")
    return _Conv1x1BnAct.apply(x.contiguous(), w, gamma, beta, residual,
                               bias, float(eps), bool(relu),
                               bool(fix_gamma))


# ---------------------------------------------------------------------------
# conv + batch-norm statistics (replaces pallas_kernels._mm_stats_kernel and
# _ckxk_kernel)
# ---------------------------------------------------------------------------


def _mean_var(s, ss, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch mean and variance from fp32 column sums over m rows, as the
    reference forms them: ``s / m`` and ``max(ss / m - mean², 0)``."""
    mean = s / m
    return mean, torch.clamp_min(ss / m - mean * mean, 0.0)


def matmul_bn_stats_reference(x, w, relu: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the matmul-bn-stats kernel: z = act(x @ w) in fp32
    (exact products, fp32 sums), rounded once to x's dtype, and per-column
    (Σz, Σz²) of the fp32 z."""
    z = x.float() @ w.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype), z.sum(0), (z * z).sum(0)


def _launch_matmul_bn_stats(x, w, relu):
    wt = _kernel_operands("matmul_bn_stats", x, w)
    (m, k), n = x.shape, w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        s, ss = _launch_stats_wgmma("matmul_bn_stats", x, wt, y, relu)
        _LAUNCHES["matmul_bn_stats"] += 1
        return y, s, ss
    code = _MM_DTYPES[x.dtype]
    parts = _stat_parts("conv_bn_epilogue", "mxt_conv_bn_m_tile", code, m,
                        n, x.device)
    _run("matmul_bn_stats", "mxt_matmul_bn_stats",
         (x, wt, y, parts[0], parts[1]), (m, n, k, int(bool(relu)), code),
         x.device)
    _LAUNCHES["matmul_bn_stats"] += 1
    s, ss = parts.sum(1)
    return y, s, ss


def matmul_bn_stats(x, w, relu: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = act(x @ w)`` in x's dtype plus per-column ``Σy`` and ``Σy²``
    in fp32, taken before y's rounding, in one pass, like
    ``pallas_kernels.matmul_bn_stats``: x (M, K), w (K, N) -> (y (M, N),
    s (N,), ss (N,)). CUDA tensors launch the kernel; CPU tensors run
    :func:`matmul_bn_stats_reference`."""
    _check_mm("matmul_bn_stats", x, w)
    if x.device.type == "cuda":
        return _launch_matmul_bn_stats(x, w, relu)
    return matmul_bn_stats_reference(x, w, relu)


def _stats_cotangent(z, mean, gz, gmean, gvar) -> torch.Tensor:
    """The whole cotangent into z, fp32 (M, C), of ``(z, mean, var)``:
    ``gz + gmean / M + gvar · 2 (z - mean) / M``, since d mean_j / d z_ij =
    1 / M and d var_j / d z_ij = 2 (z_ij - mean_j) / M (the reference's
    ``_c1x1_bwd`` and KxK backward)."""
    c = z.shape[-1]
    m = z.numel() // c
    g = z.reshape(m, c).to(torch.float32, copy=True).sub_(mean)
    g.mul_(gvar.float() * (2.0 / m)).add_(gz.reshape(m, c))
    return g.add_(gmean.float() / m)


class _ConvBnStats(torch.autograd.Function):
    """``(z, mean, var)`` of a conv with the batch statistics from the conv's
    own kernel, in place of the JAX package's ``conv1x1_bn_stats_train`` and
    ``convkxk_bn_stats_train`` custom VJPs. ``pad`` is None for a 1x1 conv
    (through :func:`matmul_bn_stats`), else a KxK stride-1 conv's padding
    (through :func:`convkxk_bn_stats`). The forward saves z as stored, in
    x's dtype; the backward forms the whole cotangent into z in fp32
    (:func:`_stats_cotangent`), casts it to x's dtype and takes the conv's
    VJP in that dtype: two products (``torch.matmul``) for a 1x1, torch's
    convolution backward for a KxK (XLA's own transposed convs in the
    reference).

    ``bias``, a conv bias, is an input the outputs do not depend on (the
    caller adds it to the returned mean): it is taken only so that a
    backward reaches it and writes its gradient, 0 from here plus what the
    caller's add gives it, as the reference's op writes it. Like the
    reference, no double backward."""

    @staticmethod
    def forward(ctx, x, w, bias, pad):
        n, h, wd, cin = x.shape
        cout = w.shape[0]
        if pad is None:
            m = n * h * wd
            z, s, ss = matmul_bn_stats(x.reshape(m, cin),
                                       w.reshape(cout, cin).t())
            mean, var = _mean_var(s, ss, m)
            z = z.reshape(n, h, wd, cout)
        else:
            z, mean, var = convkxk_bn_stats(x, w, pad)
        ctx.save_for_backward(x, w, z, mean)
        ctx.pad = pad
        ctx.bias = None if bias is None else (bias.shape, bias.dtype,
                                               bias.device)
        return z, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gz, gmean, gvar):
        x, w, z, mean = ctx.saved_tensors
        g = _stats_cotangent(z, mean, gz, gmean, gvar).to(x.dtype)
        if ctx.pad is None:
            cout, cin = w.shape[0], x.shape[3]
            dx = g @ w.reshape(cout, cin).to(g.dtype)
            dw = g.t() @ x.reshape(-1, cin)
        else:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.reshape(z.shape).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                w.permute(0, 3, 1, 2), None, [1, 1], list(ctx.pad), [1, 1],
                False, [0, 0], 1, [True, True, False])
            dx, dw = dx.permute(0, 2, 3, 1), dw.permute(0, 2, 3, 1)
        dbias = None if ctx.bias is None else torch.zeros(
            ctx.bias[0], dtype=ctx.bias[1], device=ctx.bias[2])
        return (dx.reshape(x.shape).to(x.dtype).contiguous(),
                dw.reshape(w.shape).to(w.dtype).contiguous(), dbias, None)


def conv1x1_bn_stats_train(x, w, bias=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Differentiable ``(z, mean, var)`` of a 1x1 NHWC conv with its batch
    statistics from the matmul-bn-stats kernel, like
    ``pallas_kernels.conv1x1_bn_stats_train``: x (N, H, W, Cin), w (Cout, 1,
    1, Cin) OHWI -> z (N, H, W, Cout) in x's dtype, mean and var (Cout,)
    fp32. The caller checks :func:`epilogue_fits` first. ``bias``: see
    :class:`_ConvBnStats`."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:3] != (1, 1) or \
            w.shape[3] != x.shape[3]:
        raise ValueError(f"conv1x1_bn_stats_train: x (N, H, W, Cin) and w "
                         f"(Cout, 1, 1, Cin) expected, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    return _ConvBnStats.apply(x.contiguous(), w, bias, None)


def convkxk_fits(xshape, cout: int, kernel=(3, 3), pad=(1, 1),
                 dtype=torch.bfloat16) -> bool:
    """Whether the convkxk-bn-stats kernel takes a stride-1 conv of an NHWC
    input of shape ``xshape`` to ``cout`` channels: fp32 or bf16, Cin and
    Cout multiples of 8 (a TMA map's strides are multiples of 16 bytes; the
    fp32 kernel reads 16-byte vectors of one tap), 0 <= pad < kernel per
    dim, a non-empty output, and output pixels and K = kh·kw·Cin below 2³¹.
    Any image size: the copies zero-fill the padding and the ragged last
    tile, and the stores clip it. A Hopper rule of the port's own: the
    TPU's ``convkxk_fits`` models Mosaic's VMEM instead."""
    n, h, w, cin = xshape
    kh, kw = kernel
    ph, pw = pad
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    return (dtype in _MM_DTYPES and cin >= 8 and cin % 8 == 0 and cout >= 8
            and cout % 8 == 0 and 0 <= ph < kh and 0 <= pw < kw and ho > 0
            and wo > 0 and n * ho * wo < 2 ** 31
            and kh * kw * cin < 2 ** 31)


def convkxk_bn_stats_reference(x, w, pad=(1, 1)
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of the convkxk-bn-stats kernel: the stride-1 conv in
    fp32 (``F.conv2d`` on channels_last views), rounded once to x's dtype,
    and the batch mean and variance from the fp32 z's channel sums."""
    z = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(0, 3, 1, 2),
                 padding=tuple(pad)).permute(0, 2, 3, 1)
    z2 = z.reshape(-1, z.shape[-1])
    mean, var = _mean_var(z2.sum(0), (z2 * z2).sum(0), z2.shape[0])
    return z.to(x.dtype).contiguous(), mean, var


def _launch_convkxk_bn_stats(x, w, pad):
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"convkxk_bn_stats kernel needs contiguous "
                             f"16-byte aligned inputs; {name} is not")
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ph, pw = pad
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    m = n * ho * wo
    geometry = (n, h, wd, cin, cout, kh, kw, ph, pw)
    lib = _build.load("convkxk_bn_stats")
    if x.dtype == torch.bfloat16:
        if lib.mxt_convkxk_tma_fits(kh, kw, ph, pw):
            z = torch.empty((n, ho, wo, cout), dtype=x.dtype,
                            device=x.device)
            with torch.cuda.device(x.device):
                rows = lib.mxt_convkxk_stats_rows(m, cout)
            if rows < 1:
                raise RuntimeError(f"convkxk_bn_stats: "
                                   f"mxt_convkxk_stats_rows({m}, {cout}) "
                                   f"failed")
            # the launch's own scratch: 2 x rows x cout partial sums, then
            # a counter per n-tile of at least 64 columns, which the launch
            # zeroes
            scratch = torch.empty(2 * rows * cout + -(-cout // 64),
                                  dtype=torch.float32, device=x.device)
            sums = torch.empty((2, cout), dtype=torch.float32,
                               device=x.device)
            _run("convkxk_bn_stats", "mxt_convkxk_bn_stats_wgmma",
                 (x, w, z, scratch, sums), (*geometry, rows), x.device,
                 source="convkxk_bn_stats")
            _LAUNCHES["convkxk_bn_stats"] += 1
            return (z, *_mean_var(sums[0], sums[1], m))
        # a kernel or pad beyond the im2col map's reach: the fp32 kernel,
        # whose fp32 sums of the exact bf16 products are the bf16 kernel's
        # arithmetic, z rounded once to bf16
        z, mean, var = _launch_convkxk_bn_stats(x.float(), w.float(), pad)
        return z.to(x.dtype), mean, var
    z = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    parts = _stat_parts("convkxk_bn_stats", "mxt_convkxk_m_tile",
                        _MM_DTYPES[x.dtype], m, cout, x.device)
    _run("convkxk_bn_stats", "mxt_convkxk_bn_stats",
         (x, w, z, parts[0], parts[1]), (*geometry, _MM_DTYPES[x.dtype]),
         x.device, source="convkxk_bn_stats")
    _LAUNCHES["convkxk_bn_stats"] += 1
    # the second pass: the per-m-tile partials summed in a fixed order
    s, ss = parts.sum(1)
    return (z, *_mean_var(s, ss, m))


def convkxk_bn_stats(x, w, pad=(1, 1)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stride-1 KxK NHWC conv with symmetric zero padding and its batch
    statistics in one pass, like ``pallas_kernels.convkxk_bn_stats``: x (N,
    H, W, Cin), w (Cout, kh, kw, Cin) OHWI -> (z (N, Ho, Wo, Cout) in x's
    dtype, mean, var (Cout,) fp32 from the fp32 sums). CUDA tensors launch
    the kernel; CPU tensors run :func:`convkxk_bn_stats_reference`."""
    pad = (int(pad[0]), int(pad[1]))
    if x.dim() != 4 or w.dim() != 4 or w.shape[3] != x.shape[3]:
        raise ValueError(f"convkxk_bn_stats: x (N, H, W, Cin) and w (Cout, "
                         f"kh, kw, Cin) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or not convkxk_fits(
            x.shape, w.shape[0], tuple(w.shape[1:3]), pad, x.dtype):
        raise ValueError(f"convkxk_bn_stats takes fp32 or bf16 x and w of "
                         f"one dtype, Cin and Cout multiples of 8 and pad < "
                         f"kernel, got x {tuple(x.shape)} {x.dtype}, w "
                         f"{tuple(w.shape)} {w.dtype}, pad {pad}")
    if w.device != x.device:
        raise ValueError(f"convkxk_bn_stats: inputs on different devices "
                         f"{x.device}, {w.device}")
    if x.device.type == "cuda":
        return _launch_convkxk_bn_stats(x, w, pad)
    if x.device.type == "cpu":
        return convkxk_bn_stats_reference(x, w, pad)
    raise ValueError(f"convkxk_bn_stats runs on cuda or cpu, not {x.device}")


def convkxk_bn_stats_train(x, w, pad=(1, 1), bias=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Differentiable ``(z, mean, var)`` of a stride-1 KxK NHWC conv with its
    batch statistics from the convkxk-bn-stats kernel, like
    ``pallas_kernels.convkxk_bn_stats_train``. The caller checks
    :func:`convkxk_fits` first. ``bias``: see :class:`_ConvBnStats`."""
    return _ConvBnStats.apply(x.contiguous(), w.contiguous(), bias,
                              (int(pad[0]), int(pad[1])))


# ---------------------------------------------------------------------------
# int8 matmul (replaces pallas_kernels._int8_mm_kernel)
# ---------------------------------------------------------------------------


def int_mm_fits(m: int, k: int, n: int) -> bool:
    """Whether ``torch._int_mm`` takes an (m, k) x (k, n) s8 product on every
    device: m > 16, k and n positive multiples of 8 (its CUDA rule; on the
    CPU it takes any shape)."""
    return m > 16 and k > 0 and n > 0 and k % 8 == 0 and n % 8 == 0


def s8_matmul_s32(a, b) -> torch.Tensor:
    """The exact s32 product of s8 matrices a (M, K) and b (K, N), in plain
    torch on a's device: ``torch._int_mm`` where :func:`int_mm_fits`, with b
    column major (cuBLASLt refuses some shapes with a row-major b, e.g.
    (100, 24, 40) on an H100; a transposed view of an (N, K) weight is
    already column major), else a float64 product, which is exact too
    (every partial sum is an integer of magnitude at most 2^14 K, far below
    2^53). The route depends on the shape alone, so both devices take the
    same one."""
    (m, k), n = a.shape, b.shape[1]
    if int_mm_fits(m, k, n):
        return torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return (a.double() @ b.double()).to(torch.int32)


def _f32(v: float) -> float:
    """v rounded to fp32 (as JAX takes a Python float into an fp32 op),
    kept as a Python float so that a multiply by it copies nothing to the
    device."""
    return ctypes.c_float(float(v)).value


def int8_fits(m: int, k: int, n: int) -> bool:
    """Whether the int8 matmul kernel takes an (m, k) x (k, n) product: any
    m >= 1 (the copies zero-fill the ragged last m-tile and the stores clip
    it), k and n multiples of 16 (a TMA map's row stride is a multiple of 16
    bytes), and k <= 131071, so that no s32 sum of products |x w| <= 2^14
    can overflow.
    A Hopper rule of the port's own: the TPU's ``int8_blocks`` models
    Mosaic's tiling and refuses an m that its tiles do not divide."""
    return (m >= 1 and k >= 16 and n >= 16 and k % 16 == 0 and n % 16 == 0
            and k * 2 ** 14 < 2 ** 31)


def int8_matmul_reference(x, w, scale, relu: bool = False, out_scale=None
                          ) -> torch.Tensor:
    """Plain version of the int8 matmul kernel: the exact s32 product
    (:func:`s8_matmul_s32`), then ``f32(acc) · f32(scale)``, the relu, and
    ``clip(round(· f32(out_scale)), −127, 127)`` as s8, each an fp32 tensor
    op, as the TPU kernel's epilogue on its last k step."""
    out = s8_matmul_s32(x, w).to(torch.float32) * _f32(scale)
    if relu:
        out = torch.clamp_min(out, 0.0)
    if out_scale is None:
        return out
    return torch.clamp(torch.round(out * _f32(out_scale)), -127.0,
                       127.0).to(torch.int8)


def _launch_int8_matmul(x, w, scale, relu, out_scale) -> torch.Tensor:
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul kernel needs contiguous 16-byte "
                             f"aligned inputs; {name} is not")
    (m, k), n = x.shape, w.shape[1]
    requant = out_scale is not None
    out = torch.empty((m, n), device=x.device,
                      dtype=torch.int8 if requant else torch.float32)
    lib = _build.load("int8_matmul")
    fn = lib.mxt_int8_matmul
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, cf, ci, ci, cf, vp]
        fn.restype = ci
    # where K is too long for the CTA to keep w's panel, the kernel reads a
    # K-major copy of w (8-bit wgmma takes no transposed operand)
    wt = w.t().contiguous() if lib.mxt_int8_matmul_needs_wt(k) else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(),
                None if wt is None else wt.data_ptr(), out.data_ptr(), m, n,
                k, float(scale), int(bool(relu)), int(requant),
                float(out_scale) if requant else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError_t "
                           f"{rc} (M, K, N = {m}, {k}, {n})")
    _LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(x, w, scale, relu: bool = False, out_scale=None
                ) -> torch.Tensor:
    """``dequant(x_s8 @ w_s8)`` in one pass, like
    ``pallas_kernels.int8_matmul``: x (M, K) s8, w (K, N) s8, the s32 sum
    times ``scale`` (= data_scale · w_scale) in fp32, an optional relu, and
    an optional s8 requantize at ``out_scale`` (an fp32 multiplier): (M, N)
    fp32, or s8 with ``out_scale``. CUDA tensors launch the kernel; CPU
    tensors run :func:`int8_matmul_reference`. Raises ``ValueError`` for a
    shape that :func:`int8_fits` refuses."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: x (M, K) and w (K, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    (m, k), n = x.shape, w.shape[1]
    if not int8_fits(m, k, n):
        raise ValueError(f"int8_matmul takes K and N multiples of 16 and K <= "
                         f"131071, got (M, K, N) = ({m}, {k}, {n})")
    if w.device != x.device:
        raise ValueError(f"int8_matmul: inputs on different devices "
                         f"{x.device}, {w.device}")
    if x.device.type == "cuda":
        return _launch_int8_matmul(x, w, scale, relu, out_scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w, scale, relu, out_scale)
    raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
