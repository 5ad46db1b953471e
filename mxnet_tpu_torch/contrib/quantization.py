"""INT8 quantized operators on tensors.

Counterpart of the op level of ``mxnet_tpu/contrib/quantization.py``:
``quantize``/``dequantize``/``requantize``, the quantized fully connected
and convolution ops with their fused relu / requantize epilogue, the
quantized activation, pooling, flatten, concat, elementwise add and mul,
batch norm and embedding, the entropy calibration and the ``intgemm_*``
family. They are plain functions on ``torch.Tensor``s and run on the device
their inputs lie on. The graph half of the reference module
(``collect_calib_ranges``, ``quantize_symbol``, ``QuantizedNet``,
``quantize_net``) waits for the port's ``symbol``; the ``_contrib_*``
aliases wait for its op registry.

Arithmetic follows the reference op by op, so that s8 and s32 outputs are
bitwise equal to it:

- Scales are computed where the reference computes them: in fp32 from the
  ranges as fp32 tensors (``quantize``, ``dequantize``, ``requantize``'s
  input scale, ``quantize_v2`` without a range, ``quantized_concat``,
  ``quantized_elemwise_add``, ``quantized_batch_norm``'s input scale), or in
  Python float64 and rounded to fp32 at the multiply (the fused epilogue,
  ``requantize``'s output scale, ``quantize_v2`` with a range,
  ``data_scale · w_scale``). ``round`` is half to even, as ``jnp.round``.
- Integer products and convolutions are exact s32. Products go through
  ``ops.cuda_kernels.s8_matmul_s32`` (``torch._int_mm`` where it takes the
  shape, else float64). Convolutions run in float64 on the s8 values: every
  partial sum is an integer of magnitude at most 2^14 · K, far below 2^53,
  so the result is exact on any device (an s8 ``F.conv2d`` returns s8 and
  wraps, and an fp32 one rounds once sums pass 2^24); the result is
  rounded before its cast to s32, which also absorbs the last-bit error
  of a transform-based convolution algorithm.
- Max pooling pads with -128 (the reference's ``reduce_window`` init) and
  runs in fp32, which holds every s8 value exactly; average pooling sums
  each window exactly in fp32 and divides by the whole window, padding
  included.

The reference routes no quantized op through a Pallas kernel: it retired
that route and refuses ``MXNET_INT8_PALLAS``. So does the port. The int8
matmul kernel (``ops.cuda_kernels.int8_matmul``) is held and timed by
``chip_smoke.py``'s int8 phase.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as _config
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..ops.cuda_kernels import _f32, s8_matmul_s32

__all__ = ["quantize", "dequantize", "requantize", "quantized_fully_connected",
           "quantized_conv", "quantize_v2", "quantized_act",
           "quantized_pooling", "quantized_flatten", "quantized_concat",
           "quantized_elemwise_add", "quantized_elemwise_mul",
           "quantized_batch_norm", "quantized_embedding", "calibrate_entropy",
           "intgemm_maxabsolute", "intgemm_prepare_data",
           "intgemm_prepare_weight", "intgemm_take_weight",
           "intgemm_fully_connected", "pallas_skipped_count"]

INT8_MIN, INT8_MAX = -127.0, 127.0       # symmetric, as the reference

_PALLAS_SKIPPED = _telemetry.counter(
    "quantization.pallas_skipped",
    "quantized convs that the retired route through the int8 matmul kernel "
    "would have claimed")
_PALLAS_SKIP_LOGGED = False

_INT8_ROUTE_VERDICT = (
    "the route of quantized convs through the int8 matmul kernel is retired "
    "in the reference and refused in the port: quantized convs always run "
    "the exact s8 -> s32 convolution in plain PyTorch. The kernel "
    "(ops/cuda_kernels.py int8_matmul, ops/csrc/int8_matmul.cu) is held "
    "against its plain version and timed on the card by chip_smoke.py's "
    "phase 9 (int8); its times are in PERF.md's B7 row.")


def pallas_skipped_count() -> int:
    """Quantized convs that the retired kernel route would have claimed.
    View over the ``quantization.pallas_skipped`` counter."""
    return int(_PALLAS_SKIPPED.value)


def _count_pallas_skip() -> None:
    global _PALLAS_SKIP_LOGGED
    _PALLAS_SKIPPED.inc()
    if not _PALLAS_SKIP_LOGGED:
        _PALLAS_SKIP_LOGGED = True
        logging.getLogger("mxnet_tpu_torch.quantization").warning(
            "quantized convs use the plain s8 convolution: %s [logged once; "
            "convs counted in quantization.pallas_skipped_count()]",
            _INT8_ROUTE_VERDICT)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _t32(v, device) -> torch.Tensor:
    """v (a number or a tensor) as a 0-dim fp32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _amax(lo, hi, device) -> torch.Tensor:
    """fp32 ``max(|lo|, |hi|)``."""
    return torch.maximum(_t32(lo, device).abs(), _t32(hi, device).abs())


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t``, correctly rounded: torch computes ``num / t`` as a
    reciprocal times ``num``, two roundings."""
    return torch.full_like(t, num) / t


def _over(t: torch.Tensor, den: float) -> torch.Tensor:
    """``t / den``, correctly rounded on every device: on CUDA, torch
    divides by a Python number as a multiply by its reciprocal."""
    return t / torch.full_like(t, den)


def _q8(f: torch.Tensor) -> torch.Tensor:
    """``clip(round(f), -127, 127)`` as s8."""
    return torch.clamp(torch.round(f), INT8_MIN, INT8_MAX).to(torch.int8)


def _tup(v, n):
    if v is None:
        return (0,) * n if n else ()
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _s32_dot(qd: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Exact s32 contraction of qd's last axis with axis 1 of the (N, K)
    weight qw."""
    lead = qd.shape[:-1]
    acc = s8_matmul_s32(qd.reshape(-1, qd.shape[-1]), qw.t())
    return acc.reshape(*lead, qw.shape[0])


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _s32_conv(qd, qw, layout: str, stride, dilate, pad, groups
              ) -> torch.Tensor:
    """Exact s32 convolution of s8 qd and qw in ``layout`` (weights OI... for
    a channels-first layout, O...I for channels-last), in float64."""
    c_axis = layout.index("C")
    if layout[0] != "N" or c_axis not in (1, len(layout) - 1):
        raise ValueError(f"quantized_conv takes a layout with N first and C "
                         f"second or last, got {layout!r}")
    last = c_axis != 1
    x = qd.movedim(-1, 1) if last else qd
    w = qw.movedim(-1, 1) if last else qw
    out = _CONV[len(layout) - 2](x.double(), w.double(), stride=stride,
                                 padding=pad, dilation=dilate, groups=groups)
    out = out.round().to(torch.int32)
    return out.movedim(1, -1).contiguous() if last else out


# ---------------------------------------------------------------------------
# quantize / dequantize / requantize (reference 87-120)
# ---------------------------------------------------------------------------


def quantize(data, min_range=-1.0, max_range=1.0, out_type="int8"):
    """fp32 -> s8 with the symmetric scale of the calibrated range ->
    ``(q, min, max)``."""
    m = max(np.float32(abs(float(min_range))),
            np.float32(abs(float(max_range))), np.float32(1e-12))
    scale = np.float32(INT8_MAX) / m                      # fp32
    q = _q8(data * float(scale))
    return (q, _t32(min_range, data.device), _t32(max_range, data.device))


def dequantize(qdata, min_range, max_range, out_type="float32"):
    scale = _over(torch.clamp_min(_amax(min_range, max_range,
                                        qdata.device), 1e-12), INT8_MAX)
    return qdata.to(torch.float32) * scale


def requantize(qdata32, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """s32 accumulator -> s8 at the calibrated output range ->
    ``(q, min, max)``."""
    dev = qdata32.device
    in_scale = _over(torch.clamp_min(_amax(min_range, max_range, dev),
                                     1e-12), INT8_MAX * INT8_MAX)
    f = qdata32.to(torch.float32) * in_scale
    lo = float(min_calib_range if min_calib_range is not None else -1.0)
    hi = float(max_calib_range if max_calib_range is not None else 1.0)
    out_scale = INT8_MAX / max(abs(lo), abs(hi), 1e-12)
    return (_q8(f * _f32(out_scale)), _t32(lo, dev), _t32(hi, dev))


def _sym_scale(lo: float, hi: float) -> float:
    return max(abs(lo), abs(hi), 1e-12) / INT8_MAX


def _quantized_epilogue(out, fused_relu, out_min, out_max):
    """The fused relu, then the fused requantize to s8 at the consumer's
    calibrated range when one is given."""
    if fused_relu:
        out = torch.clamp_min(out, 0)
    if out_min is not None and out_max is not None:
        scale = INT8_MAX / max(abs(float(out_min)), abs(float(out_max)),
                               1e-12)
        out = _q8(out * _f32(scale))
    return out


# ---------------------------------------------------------------------------
# quantized fully connected and convolution (reference 144-234)
# ---------------------------------------------------------------------------


def quantized_fully_connected(arrays, num_hidden=0, no_bias=False,
                              flatten=True, data_scale=1.0, w_scale=1.0,
                              fused_relu=False, out_min=None, out_max=None):
    """s8 data x s8 weight (N, K) -> exact s32, then the fp32 epilogue.
    arrays = [qdata, qweight, (bias fp32)]."""
    qd, qw = arrays[0], arrays[1]
    if flatten and qd.dim() > 2:
        qd = qd.reshape(qd.shape[0], -1)
    acc = _s32_dot(qd, qw)
    out = acc.to(torch.float32) * _f32(float(data_scale) * float(w_scale))
    if not no_bias and len(arrays) > 2:
        out = out + arrays[2]
    return _quantized_epilogue(out, fused_relu, out_min, out_max)


def _refuse_pallas_int8(kernel, stride, dilate, pad, num_group, layout):
    """The retired route's gate: geometries the route would have claimed
    (NHWC 1x1 any stride, 3x3 stride 1 pad 1) count a skip and log once; a
    nonzero ``MXNET_INT8_PALLAS`` refuses."""
    mode = _config.get("MXNET_INT8_PALLAS")
    if mode:
        raise MXNetError(
            f"MXNET_INT8_PALLAS={mode} refused: " + _INT8_ROUTE_VERDICT)
    if (tuple(dilate) == (1, 1) and num_group == 1 and layout == "NHWC"
            and (tuple(kernel) == (1, 1) and tuple(pad) == (0, 0)
                 or tuple(kernel) == (3, 3) and tuple(stride) == (1, 1)
                 and tuple(pad) == (1, 1))):
        _count_pallas_skip()


def quantized_conv(arrays, kernel=(1, 1), stride=(1, 1), dilate=(1, 1),
                   pad=(0, 0), num_filter=1, num_group=1, no_bias=False,
                   layout=None, data_scale=1.0, w_scale=1.0,
                   fused_relu=False, out_min=None, out_max=None):
    """s8 convolution with exact s32 sums, then the fp32 epilogue. Any
    layout with N first and C second (NCW, NCHW, NCDHW; OI... weights) or
    last (NWC, NHWC, NDHWC; O...I weights). arrays = [qdata, qweight, (bias
    fp32 (Cout,))]."""
    qd, qw = arrays[0], arrays[1]
    nsp = len(kernel)
    if layout is None:
        layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nsp]
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    dilate = _tup(dilate, nsp) if dilate else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp

    _refuse_pallas_int8(kernel, stride, dilate, pad, num_group, layout)
    c_axis = layout.index("C")
    acc = _s32_conv(qd.to(torch.int8), qw.to(torch.int8), layout, stride,
                    dilate, pad, num_group)
    out = acc.to(torch.float32) * _f32(float(data_scale) * float(w_scale))
    if not no_bias and len(arrays) > 2:
        shape = [1] * out.dim()
        shape[c_axis] = arrays[2].shape[0]
        out = out + arrays[2].reshape(shape)
    return _quantized_epilogue(out, fused_relu, out_min, out_max)


# ---------------------------------------------------------------------------
# the rest of the quantized op surface (reference 655-801)
# ---------------------------------------------------------------------------


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """Quantize at the calibrated range, or without one at the data's own
    max |x| -> ``(q, min, max)``."""
    if min_calib_range is None or max_calib_range is None:
        amax = torch.clamp_min(data.abs().max().to(torch.float32), 1e-12)
        q = _q8(data * _div(INT8_MAX, amax))
        return (q, -amax, amax)
    lo, hi = float(min_calib_range), float(max_calib_range)
    scale = INT8_MAX / max(abs(lo), abs(hi), 1e-12)
    q = _q8(data * _f32(scale))
    return (q, _t32(lo, data.device), _t32(hi, data.device))


def quantized_act(qdata, min_range, max_range, act_type="relu"):
    """s8 relu: ``max(q, 0)`` keeps the scale."""
    if act_type != "relu":
        raise NotImplementedError(
            f"quantized_act supports relu (got {act_type}); dequantize for "
            "other activations")
    dev = qdata.device
    return (torch.clamp_min(qdata, 0), _t32(min_range, dev),
            _t32(max_range, dev))


def quantized_pooling(qdata, min_range, max_range, kernel=(2, 2),
                      stride=None, pad=(0, 0), pool_type="max",
                      global_pool=False):
    """s8 pooling of NCHW data: max stays s8 (padding reads -128); avg sums
    each window exactly and divides by kh·kw, padding included, then
    rounds to s8."""
    n, c, h, w = qdata.shape
    if global_pool:
        kernel, stride, pad = (h, w), (1, 1), (0, 0)
    kernel = tuple(kernel)
    stride = tuple(stride or kernel)
    pads = (pad[1], pad[1], pad[0], pad[0])
    if pool_type == "max":
        x = F.pad(qdata.to(torch.float32), pads, value=-128.0)
        out = F.max_pool2d(x, kernel, stride).to(torch.int8)
    else:
        x = F.pad(qdata.to(torch.float32), pads, value=0.0)
        acc = F.avg_pool2d(x, kernel, stride, divisor_override=1)
        out = _q8(_over(acc, float(kernel[0] * kernel[1])))
    dev = qdata.device
    return (out, _t32(min_range, dev), _t32(max_range, dev))


def quantized_flatten(qdata, min_range, max_range):
    dev = qdata.device
    return (qdata.reshape(qdata.shape[0], -1), _t32(min_range, dev),
            _t32(max_range, dev))


def quantized_concat(arrays, num_args=0, dim=1):
    """Concat s8 inputs, each rescaled to the widest input range, so that one
    output scale is exact. arrays = [q0..qn-1, min0, max0, min1, max1, ...]
    -> ``(q, -amax, amax)``."""
    n = num_args or len(arrays) // 3
    qs = arrays[:n]
    dev = qs[0].device
    amaxs = [_amax(lo, hi, dev)
             for lo, hi in zip(arrays[n::2][:n], arrays[n + 1::2][:n])]
    out_amax = amaxs[0]
    for a in amaxs[1:]:
        out_amax = torch.maximum(out_amax, a)
    scaled = [_q8(q.to(torch.float32) * (a / out_amax))
              for q, a in zip(qs, amaxs)]
    return (torch.cat(scaled, dim=dim), -out_amax, out_amax)


def quantized_elemwise_add(qa, qb, a_min, a_max, b_min, b_max):
    """s8 + s8 through fp32 at each input's scale, requantized to the sum's
    range -> ``(q, -amax, amax)``."""
    dev = qa.device
    sa = _over(torch.clamp_min(_amax(a_min, a_max, dev), 1e-12), INT8_MAX)
    sb = _over(torch.clamp_min(_amax(b_min, b_max, dev), 1e-12), INT8_MAX)
    f = qa.to(torch.float32) * sa + qb.to(torch.float32) * sb
    out_amax = torch.maximum(_t32(a_min, dev).abs() + _t32(b_min, dev).abs(),
                             _t32(a_max, dev).abs() + _t32(b_max, dev).abs())
    q = _q8(f * _div(INT8_MAX, torch.clamp_min(out_amax, 1e-12)))
    return (q, -out_amax, out_amax)


def quantized_elemwise_mul(qa, qb, a_min, a_max, b_min, b_max):
    """s8 · s8 -> exact s32; the ranges multiply -> ``(acc, -amax, amax)``."""
    dev = qa.device
    acc = qa.to(torch.int32) * qb.to(torch.int32)
    sa = torch.clamp_min(_amax(a_min, a_max, dev), 1e-12)
    sb = torch.clamp_min(_amax(b_min, b_max, dev), 1e-12)
    out_amax = sa * sb
    return (acc, -out_amax, out_amax)


def quantized_batch_norm(qdata, gamma, beta, moving_mean, moving_var,
                         min_range, max_range, eps=1e-3,
                         min_calib_range=None, max_calib_range=None):
    """Inference batch norm over s8 (channel axis 1): the folded per-channel
    affine in fp32, requantized to the calibrated output range ->
    ``(q, min, max)``."""
    dev = qdata.device
    in_scale = _over(torch.clamp_min(_amax(min_range, max_range, dev),
                                     1e-12), INT8_MAX)
    inv = gamma / torch.sqrt(moving_var + eps)
    shape = (1, -1) + (1,) * (qdata.dim() - 2)
    f = (qdata.to(torch.float32) * in_scale - moving_mean.reshape(shape)) \
        * inv.reshape(shape) + beta.reshape(shape)
    lo = float(min_calib_range if min_calib_range is not None else -1.0)
    hi = float(max_calib_range if max_calib_range is not None else 1.0)
    out_scale = INT8_MAX / max(abs(lo), abs(hi), 1e-12)
    return (_q8(f * _f32(out_scale)), _t32(lo, dev), _t32(hi, dev))


def quantized_embedding(indices, qweight, min_range, max_range,
                        input_dim=0, output_dim=0):
    """Gather s8 rows; a gather keeps the scale."""
    dev = qweight.device
    return (qweight[indices.long()], _t32(min_range, dev),
            _t32(max_range, dev))


def calibrate_entropy(hist_and_edges, num_quantized_bins=255):
    """KL-divergence threshold selection over a histogram, on the host in
    numpy (calibration is offline): the clip threshold (in bins) whose
    quantized distribution minimises KL against the clipped reference
    distribution -> ``(threshold int32, kl fp32)``, CPU tensors."""
    if isinstance(hist_and_edges, torch.Tensor):
        hist_and_edges = hist_and_edges.detach().cpu().numpy()
    hist = np.asarray(hist_and_edges, dtype=np.float64)
    nbins = hist.size
    best_kl, best_t = np.inf, nbins
    for t in range(num_quantized_bins, nbins + 1, 2):
        p = hist[:t].copy()
        p[t - 1] += hist[t:].sum()          # clip mass into the last bin
        p_sum = p.sum()
        if p_sum == 0:
            continue
        # quantize t bins down to num_quantized_bins, then expand back
        factor = t / num_quantized_bins
        q = np.zeros(t)
        for j in range(num_quantized_bins):
            lo = int(np.floor(j * factor))
            hi = int(np.ceil((j + 1) * factor))
            mass = hist[lo:hi].sum()
            nz = (hist[lo:hi] > 0).sum()
            if nz:
                q[lo:hi] = np.where(hist[lo:hi] > 0, mass / nz, 0)
        q_sum = q.sum()
        if q_sum == 0:
            continue
        pn, qn = p / p_sum, q / q_sum
        mask = (pn > 0) & (qn > 0)
        kl = float(np.sum(pn[mask] * np.log(pn[mask] / qn[mask])))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return (torch.tensor(best_t, dtype=torch.int32),
            torch.tensor(best_kl, dtype=torch.float32))


# ---------------------------------------------------------------------------
# intgemm family (reference 850-908): the int8 GEMM pre/post-processing ops.
# The reference's prepare_* permute into a CPU register layout; here, as in
# the JAX package, they quantize and keep row major.
# ---------------------------------------------------------------------------


def intgemm_maxabsolute(data):
    return data.abs().max()


def _prepare(data, maxabs):
    scale = _div(INT8_MAX, torch.clamp_min(_t32(maxabs, data.device),
                                           1e-12))
    return _q8(data * scale)


def intgemm_prepare_data(data, maxabs):
    """fp32 -> s8 at the scale 127 / maxabs."""
    return _prepare(data, maxabs)


def intgemm_prepare_weight(arrays, already_quantized=False):
    """The weight pre-pass: quantize (unless already s8), row major."""
    if already_quantized or len(arrays) == 1:
        return arrays[0].to(torch.int8)
    return _prepare(*arrays)


def intgemm_take_weight(qweight, indices):
    """Gather rows of a prepared weight (vocabulary shortlisting)."""
    return qweight[indices.long()]


def intgemm_fully_connected(arrays, num_hidden=0, no_bias=True, flatten=True,
                            out_type="float32"):
    """s8 x s8 (N, K) -> exact s32, or fp32 times the scale. arrays =
    [data s8, weight s8, scale (fp32, the product of the two quantization
    scales), (bias)]."""
    qd, qw = arrays[0], arrays[1]
    if flatten and qd.dim() > 2:
        qd = qd.reshape(qd.shape[0], -1)
    acc = _s32_dot(qd.to(torch.int8), qw.to(torch.int8))
    if out_type == "int32":
        return acc
    scale = arrays[2] if len(arrays) > 2 else 1.0
    out = acc.to(torch.float32) * _t32(scale, acc.device)
    if not no_bias and len(arrays) > 3:
        out = out + arrays[3]
    return out
