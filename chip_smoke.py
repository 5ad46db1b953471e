#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card and build: print the card's name and power limit (nvidia-smi), build
   every CUDA kernel from ``mxnet_tpu_torch/ops/csrc`` and print the seconds.
2. Forward kernel vs. plain version on the card: the flash-attention
   forward's ``out`` and ``lse`` against ``flash_attention_fwd_reference`` on
   the same inputs, at the LM's shapes and at ragged / fp32 / fp16 / other
   head-dim / sharp-softmax cases, each within its stated tolerance. This
   phase is the gate on the kernel: its inputs give scores of std 1 (or 8),
   where a wrong q k^T or a wrong rescale across k-tiles shows. 16-bit cases
   are also held to the rounding the kernel's design allows (``check_p16``).
2b. Backward kernels vs. plain version: ``dq``, ``dk``, ``dv`` of ``_bwd``
   (the dq and dk/dv kernels) against ``flash_attention_bwd_reference`` on
   the same (q, k, v, out, lse, do), out and lse from the forward kernel, at
   the train path's shapes and at causal / sharp / fp16 / d=128 / ragged
   fp32 cases. 16-bit cases are also held to the rounding of p and ds
   (``check_bwd16``). The plain backward is itself held against autograd
   through the plain forward.
3. The forward path: the BERT-base-width LM (vocab 30528, 12 x 768, 12
   heads, MLP 3072, bf16; random weights from a seeded generator) serves
   requests of tokens (4, 128) and (8, 512) through ``forward`` and
   ``loss_fn``, with the launch counts zeroed just before and read just
   after. Each forward must launch the kernel once per layer with no
   fallback and agree with the einsum attention path; ``loss_fn`` must match
   a plain masked NLL (``F.cross_entropy``) of the einsum path's logits. At
   random init the scores are near zero, so this phase checks the model
   around the kernel, not the kernel.
3b. The train path at the same width: ``make_train_step`` takes 5 Adam and 5
   LAMB steps on a fixed batch of tokens (32, 128) (``bench.py``'s bert
   lane), with the counts zeroed just before and read just after: falling
   finite loss, exactly one launch of each of the three kernels per layer per
   step, no fallback. Then single steps: attention's gradients through the
   kernels against the einsum path, ``grad_accum=2``, ``remat=True``, and a
   step at tokens (8, 512).
4. Timings: each kernel, its plain version and the library call that
   computes the same function (``scaled_dot_product_attention`` and its
   backward; never called by the port) at the main paths' shapes, each
   timed as interleaved replays of a CUDA graph, beside its bound; median
   forward time per request shape and median train-step time;
   ``torch.profiler`` traces of a few forwards and train steps (device-busy
   time, idle share, top kernels).
5. Epilogue kernels vs. plain version: ``matmul_stats`` and
   ``matmul_epilogue`` (``conv_bn_epilogue.cu``) against their plain
   versions, bf16 and fp32, ragged M, K in {64, 256, 1024}, N in {64, 256,
   2048}, with and without the residual and the ReLU, and at every distinct
   site shape of the ResNet-50 step (bf16 at batch 128, fp32 at batch 32);
   the statistics must also be bitwise repeatable.
5b. Conv + batch-norm statistics kernels vs plain version: ``matmul_bn_stats``
   (``conv_bn_epilogue.cu``) and ``convkxk_bn_stats``
   (``convkxk_bn_stats.cu``) against their plain versions, bf16 and fp32,
   ragged M, the ``KXK_CASES`` geometries with the image border scaled by
   ``BORDER``, and every distinct site shape of the ResNet-50 step; the
   statistics must also be bitwise repeatable.
6. The ResNet train path (``MXNET_FUSED_EPILOGUE=1``): the Gluon
   ResNet-50 v1 (NHWC, 1000 classes, Xavier from a seeded generator) takes
   5 SGD-momentum steps (momentum 0.9, wd 1e-4: ``bench.py``'s ResNet lane,
   at RESNET_LR) in pure bf16 on a fixed batch of 128 images of 224 x 224,
   with the counts zeroed just before and read just after: falling finite
   loss, exactly 36 launches of each epilogue kernel per step, no site
   refused. Then in fp32 at batch 32: 3 steps fused, then the same 3 steps
   unfused from the same weights, held to the distance between two
   equivalent unfused runs. Step-1 gradients of every leaf at batch 128
   from the same weights: fp32 fused vs unfused, held to the distance
   between two unfused formulations; bf16 fused and unfused, each against
   the fp32 gradients. Then the lane's own lr (REFERENCE_LR), recorded and
   not gated.
6b. The fused op's backward at every distinct site shape, bf16 and fp32:
   its gradients and the unfused layers' against a plain fp64 conv + batch
   norm on the same values.
6c-6f. The ResNet train path under ``MXNET_FUSED_CONV_BN=1`` (epilogue
   off): 5 bf16 steps at batch 128 with 36 + 16 launches and 52 fused + 1
   refused sites per step; fp32 fused vs unfused at batch 32; step-1
   gradients; each fused op's backward at every site shape against fp64;
   one step with both knobs on.
7. ResNet timings: both epilogue kernels, their plain versions and
   ``torch.matmul`` of the same product at two site shapes, timed as CUDA
   graph replays, each beside its bound; the bf16 step fused and unfused
   (10 interleaved steps after 3 warm-up); a profile of each.
7b. The same for the conv + batch-norm kernels (library: ``torch.matmul``,
   cuDNN ``F.conv2d``) and for the step on that route.
9. int8: the path of ``benchmark/microbench_tpu.py`` ``section_int8_pallas``
   and the int8 op surface. (a) ``int8_matmul`` (``int8_matmul.cu``) at
   (M, K, N) = (25088, 512, 128) (ResNet-50's 1x1 conv at batch 32, 28x28,
   512 -> 128), dequant and relu + requantize rows; at M = 392 with N = 2048
   (ragged); at K = 2048; at K and N that end inside the kernel's tiles;
   at every distinct 1x1 site shape of ResNet-50 at
   batch 32; and with constant +-127 operands, whose s32 sums are the
   largest. The counts are zeroed just before and read just after: one
   launch per call. Each output is held against ``int8_matmul_reference``
   bitwise (s8 and fp32 outputs alike: the kernel does the plain version's
   fp32 operations in the same order). (b) The int8 ops
   (``contrib.quantization``) on the card against the same ops on the CPU
   with the same inputs, at ResNet-50's widths, batch ``INT8_OPS_BATCH``
   (``quantize`` and the fully connected layer at batch 32):
   ``quantize``, ``quantized_conv`` at every 1x1 and 3x3 site and the 7x7/2
   stem (bias, fused relu, requantize), max and global-average pooling,
   ``quantized_fully_connected`` 2048 -> 1000, ``quantized_elemwise_add``,
   ``quantized_batch_norm``; every output bitwise equal. (c) Timings as
   CUDA-graph replays beside their bounds: the kernel's dequant and requant
   rows against ``torch._int_mm`` plus the same epilogue, the bf16 matmul of
   the dequantized operands, and the plain version; the kernel at two 1x1
   site shapes.
10. The kernels' JSON line, then the result line.

Exits non-zero without a result when no CUDA device is available, and when
the ``mxnet_tpu_torch`` package is not beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor-core / fp32 CUDA-core

# (bh, s, d, dtype, causal, q scale); the first three are the forward
# path's shapes. q, k, v are standard normal, so the scores have std q scale:
# 8 makes the softmax sharp, and its max move between k-tiles.
ATTN_CASES = [
    (48, 128, 64, torch.bfloat16, False, 1.0),   # tokens (4, 128), 12 heads
    (96, 512, 64, torch.bfloat16, False, 1.0),   # tokens (8, 512)
    (96, 512, 64, torch.bfloat16, True, 1.0),
    (96, 512, 64, torch.bfloat16, False, 8.0),
    (6, 200, 64, torch.float32, False, 1.0),     # ragged s, fp32
    (6, 200, 64, torch.float32, True, 1.0),
    (6, 200, 64, torch.float32, True, 8.0),
    (4, 200, 128, torch.float16, True, 1.0),
    (4, 200, 128, torch.float16, False, 8.0),
    (4, 77, 32, torch.bfloat16, False, 1.0),
    (3, 65, 16, torch.float32, True, 1.0),
    (2, 1000, 128, torch.float32, False, 1.0),
]
# max |kernel - plain| <= atol + rtol * |plain|, per output and dtype. 16-bit:
# the kernel rounds p to 16 bits before p v and both round out to 16 bits.
OUT_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float16: (4e-3, 4e-3),
           torch.float32: (2e-5, 1e-4)}
LSE_TOL = {torch.bfloat16: (1e-4, 1e-5), torch.float16: (1e-4, 1e-5),
           torch.float32: (1e-4, 1e-5)}
# 16-bit inputs: the kernel rounds p to the input dtype before p v (the TPU
# kernel keeps p in fp32). Its out may then differ from the exact fp32 out by
# half an ulp of out (the final rounding) plus P16_GAP_FACTOR times the gap
# that rounding p alone makes in a plain fp32 computation of the same inputs.
P16_GAP_FACTOR = 2.0
# Backward cases, (bh, s, d, dtype, causal, q scale); the first two are the
# train path's shapes: tokens (32, 128) and (8, 512), 12 heads. do is
# standard normal too.
BWD_CASES = [
    (384, 128, 64, torch.bfloat16, False, 1.0),
    (96, 512, 64, torch.bfloat16, False, 1.0),
    (96, 512, 64, torch.bfloat16, True, 1.0),
    (96, 512, 64, torch.bfloat16, False, 8.0),   # sharp scores
    (8, 256, 64, torch.float16, False, 1.0),
    (8, 256, 64, torch.float16, True, 8.0),
    (4, 200, 128, torch.bfloat16, True, 1.0),    # d = 128, ragged s
    (4, 200, 128, torch.float16, False, 1.0),
    (2, 77, 32, torch.bfloat16, False, 1.0),
    (6, 200, 64, torch.float32, False, 1.0),     # ragged s, fp32
    (6, 200, 64, torch.float32, True, 8.0),
    (3, 65, 16, torch.float32, True, 1.0),
    (2, 200, 128, torch.float32, False, 1.0),
]
# max |kernel - plain| <= BWD_TOL * max |plain|, per gradient and dtype. The
# gradients are small (|dq| ~ 0.05 at s 512), so the bound is relative to
# each gradient's largest entry. 16-bit: the final rounding (2^-9 relative
# for bf16, 2^-12 for fp16) and the 16-bit p and ds, whose share
# check_bwd16 pins separately. fp32: summation order only.
BWD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}
# 16-bit backward: p (into p^T do) and ds (into ds k and ds^T q) are
# rounded to the input dtype, where the TPU kernels keep them in fp32. Each
# gradient may differ from the exact fp32 one by half an ulp of itself plus
# BWD16_GAP_FACTOR times the gap that rounding p and ds alone makes in a
# plain fp32 computation, plus BWD16_SLACK of its largest entry for fp32
# summation order.
BWD16_GAP_FACTOR = 2.0
BWD16_SLACK = 1e-5
# The plain backward against autograd through the plain forward, fp32:
# the same math in another order.
PLAIN_BWD_TOL = 1e-5
# flash vs einsum logits of the bf16 BERT-base forward: both round the
# residual stream to bf16 at every layer, the einsum path also rounds the
# scores to bf16 before the softmax (as the JAX package does)
LOGITS_ATOL = 0.1
LOGITS_MEAN_ATOL = 1e-2
# loss_fn vs F.cross_entropy(ignore_index=-1) of the einsum path's logits:
# a position's NLL moves by at most 2 max|dz| when its logits move by dz, so
# the bound is twice the measured max |flash - einsum| logits, plus LOSS_SLACK
# for fp32 reduction order. The wide range around ln(V) is a sanity check.
LOSS_SLACK = 1e-3
LOSS_RANGE = (0.5, 1.5)   # x ln(vocab)
REQUESTS = [(4, 128), (8, 512)]
# The train path: bench.py's bert lane (batch, sequence, lr). Adam's first
# steps move each weight by about lr = 1e-4, more than half a bf16 ulp of a
# weight below 0.031 in magnitude, so most updates survive the cast back.
# At lr 1e-3 Adam overshoots at this width within 5 steps (9.32, 8.89, 8.41,
# 8.89, 9.66 on the H100), and LAMB's first step moves every
# zero-initialised bias by 3.16 * lr (no bias correction, trust ratio 1
# where |w| = 0), which can raise the loss.
TRAIN_TOKENS = (32, 128)
TRAIN_LONG_TOKENS = (8, 512)
TRAIN_LR = 1e-4
TRAIN_STEPS = 5
# Relative L2 error of each layer's attn.qkv.weight gradient (which flows
# only through attention's backward), flash kernels vs the einsum path, bf16:
# both paths round activations and gradients to bf16 (2^-8) at every layer,
# and the einsum path also rounds the scores; over 12 layers that stays far
# below 5%.
QKV_GRAD_REL_L2 = 5e-2
# |loss - loss of the plain step| for grad_accum=2 and remat=True, bf16: the
# micro-batches run the same per-sample math under other GEMM tilings, and
# remat recomputes the same forward.
TRAIN_LOSS_ATOL = 1e-2
TIMING_ROUNDS = 5     # interleaved replays of a graph of TIMING_ITERS calls
TIMING_ITERS = 50
PROFILE_FORWARDS = 5
PROFILE_STEPS = 3
# -- the ResNet path --
# (M, K, N) cases of the epilogue kernels vs their plain versions: M ragged
# (not a multiple of either m-tile, 128 rows for bf16 and 64 for fp32)
EPI_MS = (1000, 3001)
EPI_KS = (64, 256, 1024)
EPI_NS = (64, 256, 2048)
# the ResNet-50 bf16 batch-128 sites that are timed: stage-1 conv3 and
# stage-4 conv3, both with the residual
EPI_SITES = [(401408, 64, 256), (6272, 512, 2048)]
# matmul_stats vs plain: fp32 sums of the same exact products in another
# order. |Δ Σz_j| <= STATS_RTOL * Σ|z_ij| and |Δ Σz²_j| <= STATS_RTOL * Σz²_j:
# an order-of-summation error is a few hundred ulps (2^-24) of the sum of
# magnitudes at most.
STATS_RTOL = 1e-5
# matmul_epilogue vs plain, max |kernel - plain| <= atol + rtol * |plain|.
# bf16: each side rounds once to bf16 from fp32 values that differ in the
# last fp32 bits, so the outputs may be one bf16 ulp (2^-7 relative) apart.
# fp32: z sums K products in another order, ~sqrt(K) * 2^-24 * Σ|x w|,
# about 1e-5 at K 1024, then scale (< 1.5) and shift.
EPI_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 128, 224, 5
# bench.py's lane_train recipe is SGD at lr 0.1. With the reference's
# Xavier fans on OHWI weights (kh*kw*Cin in, Cout*kw*Cin out) the conv
# weights start several times smaller than true fans would make them, and
# every conv feeds a train-mode BN, whose gradient scales as 1/|w|: the
# first lr-0.1 step moves a conv weight by several times its own norm, and
# on a fixed batch the loss jumps about (PERF.md, the ResNet findings).
# So the recipe's
# lr is run and recorded ungated (REFERENCE_LR), and the gated run takes
# RESNET_LR, where the first steps stay small against the weights.
REFERENCE_LR = 0.1
RESNET_LR = 1e-3
RESNET_OPT = {"learning_rate": RESNET_LR, "momentum": 0.9, "wd": 1e-4}
RESNET_SITES = 36          # fused 1x1 sites per ResNet-50 step
FP32_BATCH, FP32_STEPS = 32, 3
# Every distinct fused 1x1 site of ResNet-50 v1 as (side of the square
# output, K, N, residual, relu), stage by stage: the first block's conv1
# (strided from stage 2 on) and downsample, conv3 with the residual, and
# the other blocks' conv1 (their conv3 repeats the first's). M is the batch
# times side². 16 shapes for the 36 sites.
RESNET_SITE_SHAPES = [
    site for st, mid in enumerate((64, 128, 256, 512))
    for side, cin in [(56 >> st, 64 if st == 0 else 2 * mid)]
    for site in ((side, cin, mid, False, True),
                 (side, cin, 4 * mid, False, False),
                 (side, mid, 4 * mid, True, True),
                 (side, 4 * mid, mid, False, True))]
BN_EPS = 1e-5              # the zoo's BatchNorm epsilon
# The fp32 fused-vs-unfused steps run at FP32_LR, where the first update
# moves a 1x1 conv weight by about 1% of its norm: there the steps stay
# close to linear, and a rounding difference stays small instead of being
# amplified as at larger lr.
FP32_LR = 1e-4
# fused vs unfused fp32 steps. Step 1's loss is a forward of the same
# weights: relative 1e-5 (fp32 sums in another order through 50 layers).
# After an update the difference is set by how far fp32 rounding moves
# this net's gradients, which is far: at this init, two equivalent unfused
# formulations (single-pass and two-pass BN variance) already give
# gradients measurably apart (PERF.md, the ResNet findings). So the later
# losses and the
# running statistics are held to FUSED_SPREAD times the distance between
# those two unfused runs, measured in the same call, plus 1e-5 of the
# value.
FIRST_LOSS_RTOL = 1e-5
FUSED_SPREAD = 3.0
FUSED_SLACK = 1e-5
# Gradients of the fused path and of the unfused layers are each held
# against a more exact reference on the same values (fp64 at one site, the
# fp32 unfused net for the bf16 net): the fused distance (relative L2 per
# gradient) within FUSED_SPREAD x the unfused one plus a slack, FUSED_SLACK
# in fp32 and BF16_SLACK in bf16, half a bf16 ulp (2^-8 relative), which a
# correct backward that rounds dz to bf16 once may add on its own. At one
# site the distances are set by rounding alone; through the whole net this
# init amplifies them (to order 1 in bf16, PERF.md), so the net-level bf16
# gate is weak and the per-site one is the strong check of the backward.
BF16_SLACK = 2.0 ** -8
RESNET_TIMED_STEPS = 10
# -- the fused conv + batch-norm path (MXNET_FUSED_CONV_BN) --
CONV_BN_KERNELS = ("matmul_bn_stats", "convkxk_bn_stats")
# every distinct 1x1 conv + BN site of the ResNet-50 step as (side of the
# square output, K, N): RESNET_SITE_SHAPES without the epilogue's residual
# and relu (stage 1's conv3 and downsample share one), 15 shapes for 36
# sites; and every 3x3 site as (side, channels), 4 shapes for 16 sites
C1X1_SITE_SHAPES = list(dict.fromkeys(
    (side, k, n) for side, k, n, _res, _relu in RESNET_SITE_SHAPES))
KXK_SITE_SHAPES = [(56 >> st, 64 << st) for st in range(4)]
# convkxk_bn_stats vs plain beyond the sites, (x shape, Cout, kernel, pad):
# M not a multiple of either m-tile, rectangular images, the s2d stem's
# 4x4/pad 0, non-square kernels with unequal padding, a 5x5/pad 2, and
# Cout not a multiple of the 64-wide n-tile
KXK_CASES = [((3, 13, 11, 16), 24, (3, 3), (1, 1)),
             ((2, 17, 9, 32), 64, (4, 4), (0, 0)),
             ((1, 9, 23, 8), 16, (3, 5), (1, 2)),
             ((5, 7, 7, 64), 8, (1, 3), (0, 1)),
             ((2, 30, 30, 128), 136, (3, 3), (1, 1)),
             ((1, 11, 10, 24), 40, (5, 5), (2, 2)),
             ((7, 5, 6, 16), 72, (2, 2), (1, 0))]
# the inputs' image border is scaled by BORDER, so that a tap read from the
# wrong side of the padding, or a missing zero-fill, shows
BORDER = 10.0
# z of a statistics kernel vs its plain version: |Δz| <= STATS_RTOL x the
# same product or conv of |x| and |w| (fp32 sums in another order) + Z_ULP
# x |z|: in bf16 each side rounds its fp32 z once, so the two may land one
# bf16 ulp (2^-7 relative at most) apart
Z_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 0.0}


# -- the int8 path --
# benchmark/microbench_tpu.py section_int8_pallas: ResNet-50's 1x1 conv at
# batch 32 and 28x28, 512 -> 128, as a matmul; its scale and requantize
# multiplier
INT8_MICRO = (32 * 28 * 28, 512, 128)
INT8_SCALE, INT8_OUT_SCALE = 3e-4, 31.0
INT8_BATCH = 32
# int8_matmul vs plain beyond the microbench shape, (M, K, N): a ragged M
# (batch 8 at 7x7, which the TPU's tiles refuse), K = 2048 (32 k-tiles),
# and K and N that end inside the kernel's 64-wide k- and n-tiles
INT8_CASES = [(392, 512, 2048), (INT8_BATCH * 7 * 7, 2048, 512),
              (1000, 48, 80), (77, 208, 16)]
# the 1x1 sites timed beside the microbench shape: stage-1 conv3 and
# stage-4 conv3 at batch 32
INT8_TIMED_SITES = [(INT8_BATCH * 56 * 56, 64, 256),
                    (INT8_BATCH * 7 * 7, 512, 2048)]
# the int8 ops, card vs CPU, run at batch 8: ResNet-50's widths, a quarter
# of the batch, so that the CPU's float64 convolutions stay within seconds
INT8_OPS_BATCH = 8
INT8_TOPS = 1979e12                # H100 SXM data sheet, int8 dense


@dataclasses.dataclass(frozen=True)
class Route:
    """A fused route of the ResNet step: its knob, the resnet module's site
    counter, and the kernel launches and site counts of one fused step
    (36 1x1 and 16 3x3 conv + BN pairs; the stem is refused)."""
    knob: str
    sites: str
    launches: dict
    fused_sites: dict
    unfused_sites: dict


EPILOGUE = Route("MXNET_FUSED_EPILOGUE", "fused_epilogue_counts",
                 {"matmul_stats": RESNET_SITES,
                  "matmul_epilogue": RESNET_SITES},
                 {"fused": RESNET_SITES, "refused": 0},
                 {"fused": 0, "refused": 0})
CONV_BN = Route("MXNET_FUSED_CONV_BN", "fused_conv_bn_counts",
                {"matmul_bn_stats": 36, "convkxk_bn_stats": 16},
                {"1x1": 36, "kxk": 16, "refused": 1},
                {"1x1": 0, "kxk": 0, "refused": 0})


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def port():
    """(models, cuda_kernels, _build) of the mxnet_tpu_torch beside this
    file."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    return models, ck, _build


def attn_inputs(bh, s, d, dtype, seed, q_scale=1.0, n=3):
    """q (times q_scale), k, v (and, with n=4, do): standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = [torch.randn(bh, s, d, generator=g, device="cuda") for _ in range(n)]
    t[0] = t[0] * q_scale
    return [x.to(dtype) for x in t]


def causal_mask(n, device):
    return torch.ones(n, n, dtype=torch.bool, device=device).triu(1)


def half_ulp(x):
    """Half an ulp of each entry of the 16-bit tensor x, in fp32."""
    got = x.float()
    _, e = torch.frexp(got)
    return torch.ldexp(torch.full_like(got, torch.finfo(x.dtype).eps), e - 2)


def check_p16(out, q, k, v, causal, scale):
    """Hold a 16-bit kernel ``out`` to its design's rounding. Returns (max
    |out - exact|, the p-rounding gap, the largest excess over half an ulp).

    exact: the fp32 attention of the same inputs. p16: the same with p
    rounded to the input dtype before p v, the row sum l still over the
    unrounded p, as in the kernel's tensor-core path."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(causal_mask(s.shape[-1], s.device), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = (p @ vf) / l
    gap = ((p.to(q.dtype).float() @ vf) / l - exact).abs().max().item()
    err = (out.float() - exact).abs()
    excess = (err - half_ulp(out)).max().item()
    if excess > P16_GAP_FACTOR * gap + 1e-6:
        fail(f"16-bit out exceeds its rounding: max excess over half an ulp "
             f"{excess:.3e} > {P16_GAP_FACTOR} x p-rounding gap {gap:.3e}")
    return err.max().item(), gap, excess


def check_bwd16(grads, q, k, v, out, lse, do, causal, scale):
    """Hold 16-bit kernel gradients (dq, dk, dv) to their design's rounding.
    Returns [(max |g - exact|, gap, largest excess over half an ulp)] per
    gradient.

    exact: the fp32 backward of the same inputs by the TPU kernels'
    formulas. gap: how far that moves when p and ds are rounded to the input
    dtype where they enter a product, as in the kernels' tensor-core
    path."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(causal_mask(s.shape[-1], s.device), float("-inf"))
    p = torch.exp(s - lse)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    p16, ds16 = p.to(q.dtype).float(), ds.to(q.dtype).float()
    pairs = ((ds @ kf, ds16 @ kf),
             (ds.transpose(-1, -2) @ qf, ds16.transpose(-1, -2) @ qf),
             (p.transpose(-1, -2) @ dof, p16.transpose(-1, -2) @ dof))
    res = []
    for name, g, (exact, rounded) in zip(("dq", "dk", "dv"), grads, pairs):
        gap = (rounded - exact).abs().max().item()
        err = (g.float() - exact).abs()
        excess = (err - half_ulp(g)).max().item()
        lim = BWD16_GAP_FACTOR * gap + BWD16_SLACK * exact.abs().max().item()
        if excess > lim:
            fail(f"16-bit {name} exceeds its rounding: max excess over half "
                 f"an ulp {excess:.3e} > {BWD16_GAP_FACTOR} x p/ds-rounding "
                 f"gap {gap:.3e} + slack")
        res.append((err.max().item(), gap, excess))
    return res


def attn_bound_ms(bh, s, d, dtype, causal, products=2, tensors=4,
                  vectors=1):
    """Least time for the work: ``tensors`` (bh, s, d) tensors and
    ``vectors`` fp32 (bh, s) vectors read or written once; 2*d flops per
    (query, key) pair that the mask keeps for each of ``products`` matrix
    products. Defaults: the forward (q, k, v, out; lse; q k^T and p v)."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = tensors * bh * s * d * esz + vectors * 4 * bh * s
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * products * bh * pairs * d
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


# bound arguments of the backward kernels: dq reads q, k, v, do and writes
# dq (3 products); dk/dv reads q, k, v, do and writes dk, dv (4 products);
# both read lse and delta
BWD_BOUND = {"flash_attention_bwd_dq": dict(products=3, tensors=5, vectors=2),
             "flash_attention_bwd_dkv": dict(products=4, tensors=6,
                                             vectors=2)}


_CAPTURE_STREAM = []


def capture_stream() -> torch.cuda.Stream:
    """The side stream every timing graph is captured on. A backward timed
    as a graph has its forward run on this stream, since autograd runs each
    backward op on its forward op's stream."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    return _CAPTURE_STREAM[0]


def time_ms(fns) -> dict:
    """CUDA-event ms per call of each ``fns[name]``: its TIMING_ITERS
    back-to-back calls are captured once into a CUDA graph, and
    TIMING_ROUNDS rounds replay every graph, in an order that alternates
    between rounds, so a slow host adds no gaps between launches. Returns
    {name: sorted per-round times}."""
    names = list(fns)
    for name in names:
        for _ in range(5):
            fns[name]()
    graphs = {}
    for name in names:
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], stream=capture_stream()):
            for _ in range(TIMING_ITERS):
                fns[name]()
    times = {name: [] for name in names}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for rnd in range(TIMING_ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            start.record()
            graphs[name].replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / TIMING_ITERS)
    return {name: sorted(t) for name, t in times.items()}


def spread(times) -> str:
    return (f"median {statistics.median(times):.4f} ms (min {times[0]:.4f}, "
            f"max {times[-1]:.4f})")


def profile(fn, n: int, what: str, card_line: str) -> None:
    """Trace n calls of fn: wall and device-busy ms per call, the device's
    idle share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile as trace
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n_t = kernels.setdefault(evt.name, [0, 0.0])
            n_t[0] += 1
            n_t[1] += evt.time_range.elapsed_us() / 1e3
    busy = sum(t for _, t in kernels.values()) / n
    if not busy:
        print(f"profile {what}: the trace holds no device time; device busy "
              f"and idle share not measured")
        return
    print(f"profile {what}, traced over {n}: wall {wall:.3f} ms/call, "
          f"device busy {busy:.3f} ms/call, idle share "
          f"{1 - busy / wall:.1%} [{card_line}]")
    for name, (cnt, t) in sorted(kernels.items(),
                                 key=lambda kv: -kv[1][1])[:8]:
        t /= n
        print(f"  {t:8.4f} ms/call {cnt // n:4d} launches/call "
              f"{t / busy:6.1%}  {name[:90]}")


def bert_base(models):
    """The BERT-base-width config (``__graft_entry__.py`` entry())."""
    return models.TransformerLMConfig(
        vocab_size=30528, num_layers=12, num_heads=12, hidden=768,
        mlp_hidden=3072, max_len=512, dtype=torch.bfloat16)


def batch(rng, cfg, B, S):
    """Tokens (B, S) and labels with ~15% of positions set, on the card."""
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.where(rng.rand(B, S) < 0.15, tokens, -1)
    return (torch.as_tensor(tokens, device="cuda"),
            torch.as_tensor(labels, device="cuda"))


# -- 1. ----------------------------------------------------------------------


def build_phase(_build) -> str:
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_src = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(per_src)} "
          f"source(s) " + json.dumps({k: round(v, 1)
                                      for k, v in per_src.items()}))
    for name in per_src:
        print(f"  ptxas {name}: {ptxas_summary(_build.build_log(name))}")
    return card_line


def ptxas_summary(log: str) -> str:
    """One line from a build's ``-Xptxas -v`` report: kernels, registers,
    spills and stack frames."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in
              re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    if not regs:
        return "no report (library was already built)"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{sum(spills)} bytes of spill stores and loads, stack frames "
            f"up to {max(stack, default=0)} bytes")


# -- 2. ----------------------------------------------------------------------


def fwd_kernel_phase(ck) -> float:
    """Phase 2; returns the max abs err of out at the forward path's
    shapes."""
    main_err = 0.0
    for i, (bh, s, d, dtype, causal, q_scale) in enumerate(ATTN_CASES):
        q, k, v = attn_inputs(bh, s, d, dtype, seed=i, q_scale=q_scale)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = ck.flash_attention_fwd_reference(q, k, v, causal,
                                                             scale)
        if out.shape != ref_out.shape or out.dtype != ref_out.dtype or \
                lse.shape != ref_lse.shape or lse.dtype != torch.float32:
            fail(f"case {i}: shape/dtype {out.shape} {out.dtype} "
                 f"{lse.shape} {lse.dtype}")
        errs = []
        for what, got, want, (atol, rtol) in (
                ("out", out, ref_out, OUT_TOL[dtype]),
                ("lse", lse, ref_lse, LSE_TOL[dtype])):
            got, want = got.float(), want.float()
            err = (got - want).abs()
            lim = atol + rtol * want.abs()
            if not torch.isfinite(got).all() or bool((err > lim).any()):
                fail(f"case {i} {(bh, s, d, str(dtype), causal)} {what}: "
                     f"max abs err {err.max().item():.3e} "
                     f"(atol {atol}, rtol {rtol})")
            errs.append(err.max().item())
        if i < 3:
            main_err = max(main_err, errs[0])
        p16 = ""
        if dtype != torch.float32:
            exact_err, gap, excess = check_p16(out, q, k, v, causal, scale)
            p16 = (f"; vs exact fp32 {exact_err:.3e}, p-rounding gap "
                   f"{gap:.3e}, max excess over half an ulp {excess:.3e}")
        print(f"kernel vs plain: bh={bh} s={s} d={d} {str(dtype)[6:]} "
              f"causal={causal} q*{q_scale:g}: max abs err out {errs[0]:.3e} "
              f"lse {errs[1]:.3e}{p16}  ok")
    torch.cuda.synchronize()
    return main_err


# -- 2b. ---------------------------------------------------------------------


def bwd_kernel_phase(ck) -> dict:
    """Phase 2b; returns the max abs err of (dq, dk/dv) at the train path's
    shapes, by kernel name."""
    main_err = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for i, (bh, s, d, dtype, causal, q_scale) in enumerate(BWD_CASES):
        q, k, v, do = attn_inputs(bh, s, d, dtype, seed=100 + i,
                                  q_scale=q_scale, n=4)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        grads = ck._bwd(q, k, v, out, lse, do, causal, scale)
        torch.cuda.synchronize()
        refs = ck.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                causal, scale)
        errs = []
        for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
            if got.shape != want.shape or got.dtype != dtype:
                fail(f"bwd case {i}: {name} {got.shape} {got.dtype}")
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            lim = BWD_TOL[dtype] * want.abs().max().item()
            if not torch.isfinite(got).all() or not err <= lim:
                fail(f"bwd case {i} {(bh, s, d, str(dtype), causal, q_scale)}"
                     f" {name}: max abs err {err:.3e} > {BWD_TOL[dtype]} x "
                     f"max |plain| = {lim:.3e}")
            errs.append((err, want.abs().max().item()))
        if i < 2:
            main_err["flash_attention_bwd_dq"] = max(
                main_err["flash_attention_bwd_dq"], errs[0][0])
            main_err["flash_attention_bwd_dkv"] = max(
                main_err["flash_attention_bwd_dkv"], errs[1][0], errs[2][0])
        r16 = ""
        if dtype != torch.float32:
            r16 = "; 16-bit rounding (vs exact, gap, excess): " + ", ".join(
                f"{n} {a:.2e} {b:.2e} {c:.2e}" for n, (a, b, c) in zip(
                    ("dq", "dk", "dv"),
                    check_bwd16(grads, q, k, v, out, lse, do, causal,
                                scale)))
        print(f"bwd kernels vs plain: bh={bh} s={s} d={d} {str(dtype)[6:]} "
              f"causal={causal} q*{q_scale:g}: max abs err " + ", ".join(
                  f"{n} {e:.3e} (max |plain| {m:.3e})"
                  for n, (e, m) in zip(("dq", "dk", "dv"), errs))
              + f"{r16}  ok")
    for causal in (False, True):
        check_plain_bwd(ck, causal)
    torch.cuda.synchronize()
    return main_err


def check_plain_bwd(ck, causal, bh=6, s=200, d=64) -> None:
    """The plain backward against autograd through the plain forward, fp32,
    so that a formula error shared by the kernels and the plain version
    shows."""
    q, k, v, do = attn_inputs(bh, s, d, torch.float32, seed=300, n=4)
    scale = 1.0 / math.sqrt(d)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out, lse = ck.flash_attention_fwd_reference(*leaves, causal, scale)
    want = torch.autograd.grad(out, leaves, do)
    got = ck.flash_attention_bwd_reference(q, k, v, out.detach(),
                                           lse.detach(), do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g - w).abs().max().item()
        lim = PLAIN_BWD_TOL * w.abs().max().item()
        if not err <= lim:
            fail(f"plain backward vs autograd {name}: {err:.3e} > {lim:.3e}")
    print(f"plain backward vs autograd through the plain forward (fp32, "
          f"bh={bh} s={s} d={d} causal={causal}): within {PLAIN_BWD_TOL} x "
          f"max |grad|  ok")


# -- 3. ----------------------------------------------------------------------


def forward_path(models, ck, cfg, params, requests):
    """Phase 3; returns the launch counts of the forward path."""
    fallback0 = models.flash_fallback_count()
    results = []
    ck.reset_launch_counts()
    with torch.inference_mode():
        for tokens, labels in requests:
            n0 = ck.launch_counts()["flash_attention_fwd"]
            logits, _aux = models.forward(params, tokens, cfg)
            n1 = ck.launch_counts()["flash_attention_fwd"]
            loss = models.loss_fn(params, tokens, labels, cfg)
            n2 = ck.launch_counts()["flash_attention_fwd"]
            results.append((logits, loss, n1 - n0, n2 - n1))
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    fallbacks = models.flash_fallback_count() - fallback0
    print(f"forward path launch counts: {counts}, flash fallbacks "
          f"{fallbacks}")
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks on the forward path")
    if counts["flash_attention_fwd"] == 0:
        fail(f"the forward kernel never launched on the forward path: "
             f"{counts}")

    cfg_einsum = dataclasses.replace(cfg, use_flash_attention=False)
    for (tokens, labels), (logits, loss, n_fwd, n_loss) in zip(requests,
                                                               results):
        B, S = tokens.shape
        if n_fwd != cfg.num_layers or n_loss != cfg.num_layers:
            fail(f"request {(B, S)}: {n_fwd} / {n_loss} kernel launches per "
                 f"forward, want {cfg.num_layers}")
        if logits.shape != (B, S, cfg.vocab_size) or \
                logits.dtype != torch.float32:
            fail(f"request {(B, S)}: logits {logits.shape} {logits.dtype}")
        if not torch.isfinite(logits).all():
            fail(f"request {(B, S)}: non-finite logits")
        with torch.inference_mode():
            ref, _ = models.forward(params, tokens, cfg_einsum)
            ref_loss = torch.nn.functional.cross_entropy(
                ref.view(-1, cfg.vocab_size), labels.view(-1),
                ignore_index=-1).item()
        diff = (logits - ref).abs()
        max_diff = diff.max().item()
        loss_bound = 2 * max_diff + LOSS_SLACK
        ln_v = math.log(cfg.vocab_size)
        print(f"request {(B, S)}: logits max |flash - einsum| "
              f"{max_diff:.3e} mean {diff.mean().item():.3e} "
              f"(max |logit| {ref.abs().max().item():.3f}); loss_fn "
              f"{loss.item():.6f} vs cross_entropy of einsum logits "
              f"{ref_loss:.6f}: |diff| {abs(loss.item() - ref_loss):.3e} "
              f"(bound {loss_bound:.3e}); ln V - loss "
              f"{ln_v - loss.item():.4f}")
        if max_diff > LOGITS_ATOL or diff.mean().item() > LOGITS_MEAN_ATOL:
            fail(f"request {(B, S)}: flash and einsum logits disagree "
                 f"(bound max {LOGITS_ATOL}, mean {LOGITS_MEAN_ATOL})")
        if not abs(loss.item() - ref_loss) <= loss_bound:
            fail(f"request {(B, S)}: loss_fn {loss.item()} vs plain masked "
                 f"NLL {ref_loss} (bound {loss_bound:.3e})")
        if not LOSS_RANGE[0] * ln_v < loss.item() < LOSS_RANGE[1] * ln_v:
            fail(f"request {(B, S)}: loss {loss.item()} outside "
                 f"{LOSS_RANGE} x ln({cfg.vocab_size})")
    return counts


# -- 3b. ---------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def run_steps(models, ck, step, params, tokens, labels, n):
    """n train steps from fresh moments; returns (losses, launch counts of
    each step)."""
    m, v = models.init_opt_state(params)
    losses, per_step = [], []
    for t in range(1, n + 1):
        c0 = ck.launch_counts()
        params, m, v, loss = step(params, m, v, tokens, labels, t)
        c1 = ck.launch_counts()
        losses.append(loss)
        per_step.append({k: c1[k] - c0[k] for k in TRAIN_KERNELS})
    return [x.item() for x in losses], per_step


def check_launches(what, per_step, want: dict) -> None:
    for i, got in enumerate(per_step):
        if got != want:
            fail(f"{what}, step {i + 1}: launches {got}, want {want}")


def train_path(models, ck, cfg, init, rng):
    """Phase 3b; returns the launch counts of the train path's main run (5
    Adam and 5 LAMB steps at TRAIN_TOKENS)."""
    L = cfg.num_layers
    per_layer = {k: L for k in TRAIN_KERNELS}
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    fallback0 = models.flash_fallback_count()
    ck.reset_launch_counts()
    runs = {}
    for opt in ("adam", "lamb"):
        step = models.make_train_step(cfg, optimizer=opt, lr=TRAIN_LR)
        runs[opt] = run_steps(models, ck, step, init(), tokens, labels,
                              TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    fallbacks = models.flash_fallback_count() - fallback0
    print(f"train path launch counts ({TRAIN_STEPS} adam + {TRAIN_STEPS} "
          f"lamb steps, tokens {TRAIN_TOKENS}): {counts}, flash fallbacks "
          f"{fallbacks}")
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks on the train path")
    if any(counts[k] == 0 for k in TRAIN_KERNELS):
        fail(f"a kernel of the train path never launched: {counts}")
    for opt, (losses, per_step) in runs.items():
        print(f"train {opt}, lr {TRAIN_LR}, tokens {TRAIN_TOKENS}: losses "
              + " ".join(f"{x:.6f}" for x in losses)
              + f"; launches per step {per_step[0]}")
        check_launches(opt, per_step, per_layer)
        if not all(math.isfinite(x) for x in losses):
            fail(f"{opt}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{opt}: loss did not fall over {TRAIN_STEPS} steps: "
                 f"{losses}")

    # attention's gradients: flash kernels vs the einsum path
    params = init()
    names = [f"layer{i}.attn.qkv.weight" for i in range(L)]
    grads = {}
    for path, use in (("flash", None), ("einsum", False)):
        c = dataclasses.replace(cfg, use_flash_attention=use)
        leaves = {n: (w.detach().requires_grad_() if n in names else w)
                  for n, w in params.items()}
        loss = models.loss_fn(leaves, tokens, labels, c)
        grads[path] = torch.autograd.grad(loss, [leaves[n] for n in names])
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(grads["flash"], grads["einsum"])]
    print(f"attn.qkv.weight gradients, flash vs einsum (bf16): relative L2 "
          f"error max {max(rel):.3e} over {L} layers (bound "
          f"{QKV_GRAD_REL_L2}): " + " ".join(f"{x:.2e}" for x in rel))
    if not max(rel) <= QKV_GRAD_REL_L2:
        fail(f"flash and einsum attention gradients disagree: {rel}")

    # single steps from the same params: plain, grad_accum=2, remat
    single = {}
    for what, c, accum in (("plain", cfg, 1), ("grad_accum=2", cfg, 2),
                           ("remat", dataclasses.replace(cfg, remat=True),
                            1)):
        step = models.make_train_step(c, lr=TRAIN_LR, grad_accum=accum)
        p = {n: w.clone() for n, w in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (loss,), (n,) = run_steps(models, ck, step, p, tokens, labels, 1)
        torch.cuda.synchronize()
        single[what] = (loss, n, torch.cuda.max_memory_allocated())
        del p
    want = {"plain": per_layer,
            "grad_accum=2": {k: 2 * L for k in TRAIN_KERNELS},
            "remat": {"flash_attention_fwd": 2 * L,
                      "flash_attention_bwd_dq": L,
                      "flash_attention_bwd_dkv": L}}
    base = single["plain"][0]
    for what, (loss, n, mem) in single.items():
        print(f"one adam step, {what}: loss {loss:.6f} (|diff| to plain "
              f"{abs(loss - base):.3e}, bound {TRAIN_LOSS_ATOL}), launches "
              f"{n}, peak memory {mem / 2**30:.3f} GiB")
        check_launches(what, [n], want[what])
        if not abs(loss - base) <= TRAIN_LOSS_ATOL:
            fail(f"{what}: loss {loss} vs {base} of the plain step")

    # the multi-tile backward inside the model
    tokens_l, labels_l = batch(rng, cfg, *TRAIN_LONG_TOKENS)
    step = models.make_train_step(cfg, lr=TRAIN_LR)
    (loss,), per_step = run_steps(models, ck, step, params, tokens_l,
                                  labels_l, 1)
    print(f"one adam step, tokens {TRAIN_LONG_TOKENS}: loss {loss:.6f}, "
          f"launches {per_step[0]}")
    check_launches(f"tokens {TRAIN_LONG_TOKENS}", per_step, per_layer)
    if not math.isfinite(loss):
        fail(f"tokens {TRAIN_LONG_TOKENS}: non-finite loss {loss}")
    fallbacks = models.flash_fallback_count() - fallback0
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks in the train checks")
    return counts


# -- 4. ----------------------------------------------------------------------


def fwd_timings(ck, cfg, card_line) -> dict:
    attn_times = {}
    for bh, s, d, dtype, causal, _ in ATTN_CASES[:2]:
        q, k, v = attn_inputs(bh, s, d, dtype, seed=100)
        scale = 1.0 / math.sqrt(d)
        B = bh // cfg.num_heads
        q4, k4, v4 = (t.view(B, cfg.num_heads, s, d) for t in (q, k, v))
        plain = lambda: ck.flash_attention_fwd_reference(q, k, v, causal,
                                                         scale)
        kern = lambda: ck._fwd(q, k, v, causal, scale)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal)
        times = time_ms({"ms": kern, "plain_ms": plain, "library_ms": lib})
        bound, bound_by = attn_bound_ms(bh, s, d, dtype, causal)
        attn_times[(bh, s)] = dict(bound_ms=bound, bound_by=bound_by, **{
            key: statistics.median(t) for key, t in times.items()})
        print(f"flash fwd bh={bh} s={s} d={d} bf16, {TIMING_ROUNDS} "
              f"interleaved rounds of a CUDA graph of {TIMING_ITERS} calls: "
              + ", ".join(
                  f"{what} {spread(t)}" for what, t in zip(
                      ("kernel", "plain", "sdpa"), times.values()))
              + f"; bound {bound:.5f} ms ({bound_by}) [{card_line}]")
    return attn_times


def bwd_timings(ck, cfg, card_line) -> dict:
    """The dq and dk/dv kernels, their plain versions, the delta pass and
    the backward of scaled_dot_product_attention, at the train path's
    shapes."""
    out_times = {}
    for bh, s, d, dtype, causal, _ in BWD_CASES[:2]:
        q, k, v, do = attn_inputs(bh, s, d, dtype, seed=200, n=4)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        delta = ck._delta(out, do)
        args = (q, k, v, do, lse, delta, causal, scale)
        B = bh // cfg.num_heads
        leaves = [t.view(B, cfg.num_heads, s, d).detach().requires_grad_()
                  for t in (q, k, v)]
        with torch.cuda.stream(capture_stream()):
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal)
        torch.cuda.current_stream().wait_stream(capture_stream())
        do4 = do.view(B, cfg.num_heads, s, d)
        times = time_ms({
            "flash_attention_bwd_dq": lambda: ck._launch_bwd_dq(*args),
            "flash_attention_bwd_dkv": lambda: ck._launch_bwd_dkv(*args),
            "delta": lambda: ck._delta(out, do),
            "backward": lambda: ck._bwd(q, k, v, out, lse, do, causal,
                                        scale),
            "dq_plain": lambda: ck._bwd_dq_plain(*args),
            "dkv_plain": lambda: ck._bwd_dkv_plain(*args),
            "sdpa_backward": lambda: torch.autograd.grad(
                lib_out, leaves, do4, retain_graph=True),
        })
        med = {key: statistics.median(t) for key, t in times.items()}
        lib = med["sdpa_backward"]
        for name, plain in (("flash_attention_bwd_dq", "dq_plain"),
                            ("flash_attention_bwd_dkv", "dkv_plain")):
            bound, bound_by = attn_bound_ms(bh, s, d, dtype, causal,
                                            **BWD_BOUND[name])
            out_times[(name, bh, s)] = dict(
                ms=med[name], plain_ms=med[plain], library_ms=lib,
                bound_ms=bound, bound_by=bound_by)
            print(f"{name} bh={bh} s={s} d={d} bf16, {TIMING_ROUNDS} "
                  f"interleaved rounds of a CUDA graph of {TIMING_ITERS} "
                  f"calls: kernel "
                  f"{spread(times[name])}, plain {spread(times[plain])}; "
                  f"bound {bound:.5f} ms ({bound_by}) [{card_line}]")
        print(f"flash backward bh={bh} s={s}: delta pass "
              f"{spread(times['delta'])}, dq + dk/dv + delta as _bwd "
              f"{spread(times['backward'])}, sdpa backward (library) "
              f"{spread(times['sdpa_backward'])} [{card_line}]")
    return out_times


def host_ms(fn, n=10, warmup=3):
    """Host-clock ms of each of n calls of fn, each ended by a synchronise,
    after warmup calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def forward_timings(models, cfg, params, requests, attn_times,
                    card_line) -> None:
    with torch.inference_mode():
        for tokens, _labels in requests:
            B, S = tokens.shape
            times = host_ms(lambda: models.forward(params, tokens, cfg))
            med = statistics.median(times)
            bh = B * cfg.num_heads
            share = cfg.num_layers * attn_times[(bh, S)]["ms"] / med \
                if (bh, S) in attn_times else float("nan")
            print(f"forward tokens ({B}, {S}): median {med:.3f} ms over 10 "
                  f"(min {min(times):.3f}); flash kernel x{cfg.num_layers} "
                  f"~ {share:.1%} of it [{card_line}]")
        for tokens, _labels in requests:
            profile(lambda: models.forward(params, tokens, cfg),
                    PROFILE_FORWARDS, f"forward tokens {tuple(tokens.shape)}",
                    card_line)


def train_timings(models, cfg, params, rng, bwd_times, card_line) -> None:
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    step = models.make_train_step(cfg, lr=TRAIN_LR)
    m, v = models.init_opt_state(params)
    state = [params, m, v, 1]

    def one():
        p, m, v, t = state
        p, m, v, _loss = step(p, m, v, tokens, labels, t)
        state[:] = [p, m, v, t + 1]

    times = host_ms(one)
    med = statistics.median(times)
    n_tok = TRAIN_TOKENS[0] * TRAIN_TOKENS[1]
    bh = TRAIN_TOKENS[0] * cfg.num_heads
    kern = cfg.num_layers * sum(
        bwd_times[(k, bh, TRAIN_TOKENS[1])]["ms"]
        for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
    print(f"train step adam, tokens {TRAIN_TOKENS}: median {med:.3f} ms "
          f"over 10 after 3 warm-up (min {min(times):.3f}, max "
          f"{max(times):.3f}), {n_tok / med * 1e3:.0f} tokens/s; backward "
          f"kernels x{cfg.num_layers} ~ {kern / med:.1%} of it "
          f"[{card_line}]")
    profile(one, PROFILE_STEPS, f"train step tokens {TRAIN_TOKENS}",
            card_line)


# -- 5. ----------------------------------------------------------------------

EPI_KERNELS = ("matmul_stats", "matmul_epilogue")


def epi_inputs(m, k, n, dtype, seed):
    """x (m, k) standard normal, w (k, n) = the transpose of a contiguous
    (n, k) weight of std 1/sqrt(k) (as at a conv site), scale in [0.5, 1.5),
    shift and residual standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    w = (torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)) \
        .to(dtype).t()
    sc = torch.rand(n, generator=g, device="cuda") + 0.5
    sh = torch.randn(n, generator=g, device="cuda")
    r = torch.randn(m, n, generator=g, device="cuda").to(dtype)
    return x, w, sc, sh, r


def check_col_sums(what, name, s, ss, z) -> float:
    """A kernel's per-column (Σz, Σz²) against those of the plain fp32 z;
    returns max |Δ|."""
    rs, rss = z.sum(0), (z * z).sum(0)
    err_s, err_ss = (s - rs).abs(), (ss - rss).abs()
    lim_s, lim_ss = STATS_RTOL * z.abs().sum(0), STATS_RTOL * rss
    if not (torch.isfinite(s).all() and torch.isfinite(ss).all()) or \
            bool((err_s > lim_s).any()) or bool((err_ss > lim_ss).any()):
        fail(f"{what}: {name} vs plain: max |Δs| {err_s.max():.3e}, "
             f"max |Δss| {err_ss.max():.3e} (bound {STATS_RTOL} x sum of "
             f"magnitudes)")
    return max(err_s.max().item(), err_ss.max().item())


def check_stats(ck, x, w, what) -> float:
    """matmul_stats against its plain version; returns max |Δ| of (s, ss)."""
    s, ss = ck.matmul_stats(x, w)
    s2, ss2 = ck.matmul_stats(x, w)
    if not (torch.equal(s, s2) and torch.equal(ss, ss2)):
        fail(f"{what}: matmul_stats is not bitwise repeatable")
    return check_col_sums(what, "matmul_stats", s, ss, x.float() @ w.float())


def check_epilogue(ck, x, w, sc, sh, r, relu, what) -> float:
    out = ck.matmul_epilogue(x, w, sc, sh, r, relu)
    ref = ck.matmul_epilogue_reference(x, w, sc, sh, r, relu)
    if out.shape != ref.shape or out.dtype != x.dtype:
        fail(f"{what}: out {out.shape} {out.dtype}")
    atol, rtol = EPI_TOL[x.dtype]
    got, want = out.float(), ref.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all() or \
            bool((err > atol + rtol * want.abs()).any()):
        fail(f"{what}: matmul_epilogue vs plain: max abs err "
             f"{err.max().item():.3e} (atol {atol}, rtol {rtol})")
    return err.max().item()


def epilogue_kernel_phase(ck) -> dict:
    """Phase 5; returns the max abs err of each kernel at the timed
    sites."""
    seed = 0
    for dtype in (torch.bfloat16, torch.float32):
        worst_s = worst_e = (-1.0, None)
        first = lambda t: t[0]
        for m in EPI_MS:
            for k in EPI_KS:
                for n in EPI_NS:
                    seed += 1
                    x, w, sc, sh, r = epi_inputs(m, k, n, dtype, seed)
                    what = f"({m}, {k}, {n}) {str(dtype)[6:]}"
                    worst_s = max(worst_s, (check_stats(ck, x, w, what),
                                            (m, k, n)), key=first)
                    for res in (None, r):
                        for relu in (False, True):
                            worst_e = max(worst_e, (check_epilogue(
                                ck, x, w, sc, sh, res, relu, what),
                                (m, k, n, res is not None, relu)), key=first)
        print(f"epilogue kernels vs plain, {str(dtype)[6:]}: M {EPI_MS} x "
              f"K {EPI_KS} x N {EPI_NS}, epilogue with and without the "
              f"residual and the relu: all within bounds; largest stats "
              f"|Δ| {worst_s[0]:.3e} at {worst_s[1]}, largest epilogue abs "
              f"err {worst_e[0]:.3e} at (M, K, N, residual, relu) "
              f"{worst_e[1]}  ok")
    main_err = {k: 0.0 for k in EPI_KERNELS}
    for dtype, batch in ((torch.bfloat16, RESNET_BATCH),
                         (torch.float32, FP32_BATCH)):
        worst = {name: (-1.0, None) for name in EPI_KERNELS}
        for i, (side, k, n, res, relu) in enumerate(RESNET_SITE_SHAPES):
            m = batch * side * side
            x, w, sc, sh, r = epi_inputs(m, k, n, dtype, seed=500 + i)
            what = f"site ({m}, {k}, {n}) {str(dtype)[6:]}"
            errs = {"matmul_stats": check_stats(ck, x, w, what),
                    "matmul_epilogue": check_epilogue(
                        ck, x, w, sc, sh, r if res else None, relu, what)}
            for name, err in errs.items():
                worst[name] = max(worst[name], (err, (m, k, n)), key=first)
                if dtype is torch.bfloat16:
                    main_err[name] = max(main_err[name], err)
        print(f"epilogue kernels vs plain at all {len(RESNET_SITE_SHAPES)} "
              f"site shapes of the ResNet-50 step, {str(dtype)[6:]}, batch "
              f"{batch}: all within bounds; largest abs err " + ", ".join(
                  f"{name} {e:.3e} at (M, K, N) {at}"
                  for name, (e, at) in worst.items()) + "  ok")
    torch.cuda.synchronize()
    return main_err

# -- 5b. ---------------------------------------------------------------------


def kxk_inputs(xshape, cout, kernel, dtype, seed):
    """x standard normal with its image border scaled by BORDER, w (Cout,
    kh, kw, Cin) of std 1/sqrt(kh kw Cin)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*xshape, generator=g, device="cuda")
    x[:, [0, -1]] *= BORDER
    x[:, :, [0, -1]] *= BORDER
    w = torch.randn(cout, *kernel, xshape[3], generator=g, device="cuda") \
        / math.sqrt(kernel[0] * kernel[1] * xshape[3])
    return x.to(dtype), w.to(dtype)


def check_z(what, name, got, want, mag) -> float:
    """z (or y) of a statistics kernel against its plain version's, within
    STATS_RTOL x ``mag`` (the same product of |x| and |w|) + Z_ULP x |z|;
    returns the max abs err."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {name} z {got.shape} {got.dtype}, want {want.shape} "
             f"{want.dtype}")
    err = (got.float() - want.float()).abs()
    lim = STATS_RTOL * mag + Z_ULP[want.dtype] * want.float().abs()
    if not torch.isfinite(got).all() or bool((err > lim).any()):
        worst = int((err - lim).argmax())
        fail(f"{what}: {name} z vs plain: max abs err {err.max():.3e}; "
             f"worst against its bound at flat index {worst}: err "
             f"{err.flatten()[worst]:.3e} > {lim.flatten()[worst]:.3e}")
    return err.max().item()


def check_bn_stats(ck, x, w, relu, what) -> float:
    """matmul_bn_stats against its plain version: y within check_z's bound,
    the sums within STATS_RTOL, all bitwise repeatable; returns max |Δy|."""
    out = ck.matmul_bn_stats(x, w, relu)
    again = ck.matmul_bn_stats(x, w, relu)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"{what}: matmul_bn_stats is not bitwise repeatable")
    y, s, ss = out
    z = x.float() @ w.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    check_col_sums(what, "matmul_bn_stats", s, ss, z)
    return check_z(what, "matmul_bn_stats", y,
                   ck.matmul_bn_stats_reference(x, w, relu)[0],
                   x.float().abs() @ w.float().abs())


def check_convkxk(ck, x, w, pad, what) -> float:
    """convkxk_bn_stats against its plain version: z within check_z's
    bound; mean within STATS_RTOL Σ|z| / M and var within STATS_RTOL Σz² /
    M + 2 |mean| Δmean + Δmean² (the error of E[z²] - E[z]² when the sums
    are within STATS_RTOL); all bitwise repeatable. Returns max |Δz|."""
    out = ck.convkxk_bn_stats(x, w, pad)
    again = ck.convkxk_bn_stats(x, w, pad)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"{what}: convkxk_bn_stats is not bitwise repeatable")
    z, mean, var = out
    rz, rmean, rvar = ck.convkxk_bn_stats_reference(x, w, pad)
    z32 = ck.convkxk_bn_stats_reference(x.float(), w.float(), pad)[0]
    z32 = z32.reshape(-1, w.shape[0])
    m = z32.shape[0]
    dmean = STATS_RTOL * z32.abs().sum(0) / m
    dvar = STATS_RTOL * (z32 * z32).sum(0) / m + 2 * rmean.abs() * dmean \
        + dmean * dmean
    if not (torch.isfinite(mean).all() and torch.isfinite(var).all()) or \
            bool(((mean - rmean).abs() > dmean).any()) or \
            bool(((var - rvar).abs() > dvar).any()):
        fail(f"{what}: convkxk_bn_stats mean/var vs plain: max |Δmean| "
             f"{(mean - rmean).abs().max():.3e}, max |Δvar| "
             f"{(var - rvar).abs().max():.3e}")
    mag = ck.convkxk_bn_stats_reference(x.float().abs(), w.float().abs(),
                                        pad)[0]
    return check_z(what, "convkxk_bn_stats", z, rz, mag)


def conv_bn_kernel_phase(ck) -> dict:
    """Phase 5b; returns the max abs err of each kernel's z at the bf16
    site shapes."""
    first = lambda t: t[0]
    seed = 2000
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        worst_y = worst_z = (-1.0, None)
        for m in EPI_MS:
            for k in EPI_KS:
                for n in EPI_NS:
                    seed += 1
                    x, w = epi_inputs(m, k, n, dtype, seed)[:2]
                    for relu in (False, True):
                        worst_y = max(worst_y, (check_bn_stats(
                            ck, x, w, relu, f"({m}, {k}, {n}) relu {relu} "
                            f"{dt}"), (m, k, n, relu)), key=first)
        for i, (xshape, cout, kernel, pad) in enumerate(KXK_CASES):
            x, w = kxk_inputs(xshape, cout, kernel, dtype, seed=2100 + i)
            worst_z = max(worst_z, (check_convkxk(
                ck, x, w, pad, f"{xshape} -> {cout}, kernel {kernel}, pad "
                f"{pad}, {dt}"), (xshape, cout, kernel, pad)), key=first)
        print(f"conv + BN statistics kernels vs plain, {dt}: matmul_bn_stats"
              f" at M {EPI_MS} x K {EPI_KS} x N {EPI_NS}, with and without "
              f"the relu, largest y abs err {worst_y[0]:.3e} at (M, K, N, "
              f"relu) {worst_y[1]}; convkxk_bn_stats at {len(KXK_CASES)} "
              f"cases (border x {BORDER}), largest z abs err "
              f"{worst_z[0]:.3e} at {worst_z[1]}; statistics within bounds "
              f"and bitwise repeatable  ok")
    main_err = {k: 0.0 for k in CONV_BN_KERNELS}
    for dtype, batch in ((torch.bfloat16, RESNET_BATCH),
                         (torch.float32, FP32_BATCH)):
        dt = str(dtype)[6:]
        worst = {name: (-1.0, None) for name in CONV_BN_KERNELS}
        for i, (side, k, n) in enumerate(C1X1_SITE_SHAPES):
            m = batch * side * side
            x, w = epi_inputs(m, k, n, dtype, seed=2200 + i)[:2]
            err = check_bn_stats(ck, x, w, False, f"site ({m}, {k}, {n}) "
                                 f"{dt}")
            worst["matmul_bn_stats"] = max(worst["matmul_bn_stats"],
                                           (err, (m, k, n)), key=first)
        for i, (side, c) in enumerate(KXK_SITE_SHAPES):
            xshape = (batch, side, side, c)
            x, w = kxk_inputs(xshape, c, (3, 3), dtype, seed=2300 + i)
            err = check_convkxk(ck, x, w, (1, 1), f"site {xshape} -> {c} "
                                f"{dt}")
            worst["convkxk_bn_stats"] = max(worst["convkxk_bn_stats"],
                                            (err, xshape), key=first)
        if dtype is torch.bfloat16:
            main_err = {name: e for name, (e, _) in worst.items()}
        print(f"conv + BN statistics kernels vs plain at all "
              f"{len(C1X1_SITE_SHAPES)} 1x1 and {len(KXK_SITE_SHAPES)} 3x3 "
              f"site shapes of the ResNet-50 step, {dt}, batch {batch} "
              f"(3x3 inputs border x {BORDER}): all within bounds; largest "
              f"abs err " + ", ".join(f"{name} {e:.3e} at {at}"
                                      for name, (e, at) in worst.items())
              + "  ok")
    torch.cuda.synchronize()
    return main_err


# -- 6. ----------------------------------------------------------------------


def set_fused(config, mode: int, route=EPILOGUE) -> None:
    os.environ[route.knob] = str(mode)
    config.refresh(route.knob)


def resnet50(mx, probe):
    """The Gluon ResNet-50 v1 of ``bench.py``'s lane, NHWC, Xavier from a
    seeded generator on the card, probed once (deferred shapes), fp32."""
    net = mx.gluon.model_zoo.get_model("resnet50_v1", classes=1000,
                                       layout="NHWC", input_layout="NHWC")
    net.initialize(mx.initializer.Xavier(
        generator=torch.Generator().manual_seed(0)))
    with torch.no_grad():
        net(probe)
    return net


def image_batch(n, dtype):
    """n images (224 x 224 x 3, NHWC) and labels from numpy seed 0."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, RESNET_IMAGE, RESNET_IMAGE, 3).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    return (torch.as_tensor(x, device="cuda").to(dtype),
            torch.as_tensor(y, device="cuda"))


class ResNetStep:
    """One train step of ``lane_train``'s recipe: forward and loss under
    ``record``, backward with ones as the head gradient, ``step(batch)``."""

    def __init__(self, mx, net, x, y):
        self.mx, self.net, self.x, self.y = mx, net, x, y
        self.trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                        dict(RESNET_OPT))
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def __call__(self):
        with self.mx.autograd.record():
            logits = self.net(self.x)
            loss = self.loss_fn(logits, self.y)
        self.mx.autograd.backward(loss)
        self.trainer.step(self.x.shape[0])
        return logits, loss


def run_resnet_steps(ck, resnet, step, n, route=EPILOGUE):
    """n steps; returns (mean losses, per-step kernel launches, per-step
    counts of the route's sites)."""
    sites_of = getattr(resnet, route.sites)
    losses, launches, sites = [], [], []
    for _ in range(n):
        c0, s0 = ck.launch_counts(), sites_of()
        logits, loss = step()
        c1, s1 = ck.launch_counts(), sites_of()
        if logits.shape != (step.x.shape[0], 1000) or \
                logits.dtype != step.x.dtype:
            fail(f"resnet logits {logits.shape} {logits.dtype}")
        losses.append(loss.float().mean().item())
        launches.append({k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]})
        sites.append({k: s1[k] - s0[k] for k in s1})
    return losses, launches, sites


def resnet_train_path(mx, ck, resnet, config, card_line):
    """Phase 6; returns (launch counts of the bf16 main run, the bf16 net,
    its batch)."""
    set_fused(config, 1)
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    step = ResNetStep(mx, net, x, y)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    resnet.reset_fused_epilogue_counts()
    losses, launches, sites = run_resnet_steps(ck, resnet, step,
                                               RESNET_STEPS)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"resnet train path (ResNet-50 v1, bf16, batch {RESNET_BATCH}, "
          f"{RESNET_IMAGE}², {RESNET_STEPS} SGD-momentum steps, lr "
          f"{RESNET_OPT['learning_rate']}): losses " + " ".join(
              f"{v:.6f}" for v in losses) + f"; launch counts {counts}; "
          f"per step {launches[0]}, sites {sites[0]}")
    want = {k: RESNET_SITES for k in EPI_KERNELS}
    for i, (got, st) in enumerate(zip(launches, sites)):
        if got != want or st != {"fused": RESNET_SITES, "refused": 0}:
            fail(f"resnet step {i + 1}: launches {got}, sites {st}; want "
                 f"{want} and {RESNET_SITES} fused, 0 refused")
    if not all(math.isfinite(v) for v in losses):
        fail(f"resnet bf16: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"resnet bf16: loss did not fall over {RESNET_STEPS} steps: "
             f"{losses}")
    resnet_fused_vs_unfused(mx, ck, resnet, config)
    resnet_step1_grads(mx, ck, resnet, config)
    resnet_reference_recipe(mx, ck, resnet, config)
    return counts, net, step


def check_sites(what, mode, launches, sites, route=EPILOGUE) -> None:
    """A fused run (mode 1) launches the route's kernels once per site and
    counts its sites; an unfused run launches none."""
    if launches != (route.launches if mode else {}) or \
            sites != (route.fused_sites if mode else route.unfused_sites):
        fail(f"{what}: launches {launches}, sites {sites}")


def set_two_pass(config, on: bool) -> None:
    os.environ["MXNET_BN_TWO_PASS_VAR"] = "1" if on else "0"
    config.refresh("MXNET_BN_TWO_PASS_VAR")


def running_stats(net):
    return {k: p.data().float().clone()
            for k, p in net.collect_params().items() if "running" in k}


def resnet_fused_vs_unfused(mx, ck, resnet, config, route=EPILOGUE
                            ) -> None:
    """fp32, batch FP32_BATCH: FP32_STEPS steps fused, then the same steps
    from the same initial weights unfused, and unfused with the two-pass BN
    variance (the yardstick of how far rounding alone moves them)."""
    x, y = image_batch(FP32_BATCH, torch.float32)
    net = resnet50(mx, x[:2])
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    net.hybridize()
    res = {}
    for what, mode, two_pass in (("fused", 1, False), ("unfused", 0, False),
                                 ("unfused two-pass", 0, True)):
        set_fused(config, mode, route)
        set_two_pass(config, two_pass)
        net.load_dict(init)
        net.zero_grad()
        step = ResNetStep(mx, net, x, y)
        step.trainer.set_learning_rate(FP32_LR)
        losses, launches, sites = run_resnet_steps(ck, resnet, step,
                                                   FP32_STEPS, route)
        for got, st in zip(launches, sites):
            check_sites(f"fp32 resnet, {what}", mode, got, st, route)
        res[what] = (losses, running_stats(net))
    set_two_pass(config, False)
    set_fused(config, 1, route)
    (fl, fs), (ul, us), (tl, ts) = (res["fused"], res["unfused"],
                                    res["unfused two-pass"])
    print(f"resnet fp32, batch {FP32_BATCH}, {FP32_STEPS} steps, lr "
          f"{FP32_LR}, {route.knob}: losses " + "; ".join(
              f"{what} " + " ".join(f"{v:.6f}" for v in res[what][0])
              for what in res))
    if not abs(fl[0] - ul[0]) <= FIRST_LOSS_RTOL * abs(ul[0]):
        fail(f"fused vs unfused fp32 step-1 loss {fl[0]} vs {ul[0]}")
    for i in range(1, FP32_STEPS):
        lim = FUSED_SPREAD * abs(tl[i] - ul[i]) + FUSED_SLACK * abs(ul[i])
        if not abs(fl[i] - ul[i]) <= lim:
            fail(f"fused vs unfused fp32 loss at step {i + 1}: {fl[i]} vs "
                 f"{ul[i]}, bound {lim:.3e} ({FUSED_SPREAD} x the two-pass "
                 f"spread {abs(tl[i] - ul[i]):.3e})")
    worst = (0.0, "")
    for name, want in us.items():
        spread_ = (ts[name] - want).abs().max().item()
        lim = FUSED_SPREAD * spread_ + FUSED_SLACK * want.abs().max().item()
        err = (fs[name] - want).abs().max().item()
        worst = max(worst, (err / lim, name))
        if not err <= lim:
            fail(f"fused vs unfused fp32 {name}: max |Δ| {err:.3e} > "
                 f"{lim:.3e} ({FUSED_SPREAD} x the two-pass spread "
                 f"{spread_:.3e})")
    print(f"resnet fp32 {route.knob} fused vs unfused: losses and running "
          f"statistics "
          f"within {FUSED_SPREAD} x the two-pass spread; the closest call "
          f"at {worst[0]:.3f} of its bound ({worst[1]})  ok")


def rel(a, b) -> float:
    """Relative L2 distance of a from b."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def bn_fed_bias(params, name) -> bool:
    """A conv bias whose next layer in its sequence is a BatchNorm. The BN
    removes any shift, so its exact gradient is 0: the fused op's is 0
    exactly, as the reference's vjp gives, and the unfused layers' is
    rounding, so no relative distance of it means anything."""
    head, _, idx = name[:-len(".bias")].rpartition(".")
    return name.endswith(".bias") and idx.isdigit() and \
        f"{head}.{int(idx) + 1}.gamma" in params


def resnet_step1_grads(mx, ck, resnet, config, route=EPILOGUE,
                       batch=RESNET_BATCH) -> None:
    """Step-1 gradients of every leaf at ``batch``, before any
    update, from the same bf16-valued weights and batch: fp32 fused vs
    unfused, held per leaf to FUSED_SPREAD x the distance between the two
    unfused formulations (single- and two-pass BN variance); bf16 fused and
    unfused, each against the fp32 unfused gradients (see BF16_SLACK)."""
    x16, y = image_batch(batch, torch.bfloat16)
    net = resnet50(mx, x16[:2].float())
    params = net.collect_params()
    init = {k: p.data().to(torch.bfloat16) for k, p in params.items()}
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    grads = {}
    for what, mode, two_pass in (
            ("fp32 fused", 1, False), ("fp32 unfused", 0, False),
            ("fp32 two-pass", 0, True), ("bf16 fused", 1, False),
            ("bf16 unfused", 0, False), ("bf16 two-pass", 0, True)):
        dtype = torch.float32 if what.startswith("fp32") else torch.bfloat16
        if dtype is torch.bfloat16 and mode:
            net.cast("bfloat16")
        set_fused(config, mode, route)
        set_two_pass(config, two_pass)
        net.load_dict(init)
        net.zero_grad()
        sites_of = getattr(resnet, route.sites)
        c0, s0 = ck.launch_counts(), sites_of()
        with mx.autograd.record():
            loss = loss_fn(net(x16.to(dtype)), y)
        mx.autograd.backward(loss)
        c1, s1 = ck.launch_counts(), sites_of()
        check_sites(f"step-1 gradients, {what}", mode,
                    {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]},
                    {k: s1[k] - s0[k] for k in s1}, route)
        grads[what] = {k: p.grad().float().clone()
                       for k, p in params.items() if p.grad_req != "null"}
    set_two_pass(config, False)
    set_fused(config, 1, route)
    ref = grads["fp32 unfused"]
    biases = [k for k in ref if bn_fed_bias(params, k)]
    for what in ("fp32 fused", "bf16 fused"):
        nonzero = [k for k in biases if bool(grads[what][k].any())]
        if nonzero:
            fail(f"step-1 gradients, {what}: the biases before a BN "
                 f"{nonzero[:3]} have nonzero gradients")
    rows = {k: {what: rel(g[k], ref[k]) for what, g in grads.items()
                if what != "fp32 unfused"}
            for k in ref if k not in biases}
    worst32 = worst16 = (0.0, "")
    for k, d in rows.items():
        lim32 = FUSED_SPREAD * d["fp32 two-pass"] + FUSED_SLACK
        lim16 = FUSED_SPREAD * d["bf16 unfused"] + BF16_SLACK
        worst32 = max(worst32, (d["fp32 fused"] / lim32, k))
        worst16 = max(worst16, (d["bf16 fused"] / lim16, k))
        if not d["fp32 fused"] <= lim32:
            fail(f"step-1 gradient of {k}, fp32: fused vs unfused "
                 f"{d['fp32 fused']:.3e} > {lim32:.3e} ({FUSED_SPREAD} x "
                 f"the two-pass spread {d['fp32 two-pass']:.3e})")
        if not d["bf16 fused"] <= lim16:
            fail(f"step-1 gradient of {k}, bf16: fused {d['bf16 fused']:.3e}"
                 f" from fp32 > {lim16:.3e} ({FUSED_SPREAD} x the unfused "
                 f"bf16's {d['bf16 unfused']:.3e} + {BF16_SLACK})")
    med = {what: statistics.median(d[what] for d in rows.values())
           for what in next(iter(rows.values()))}
    # recorded, not gated: bf16 fused vs unfused, and the two unfused bf16
    # formulations, over all these leaves at once. The second is small (the
    # two variances differ in fp32 bits that the bf16 scale and shift round
    # away), the first is bf16 rounding of z, which the fused path skips.
    flat = {what: torch.cat([grads[what][k].flatten() for k in rows])
            for what in ("bf16 fused", "bf16 unfused", "bf16 two-pass")}
    d16 = {what: rel(flat[what], flat["bf16 unfused"])
           for what in ("bf16 fused", "bf16 two-pass")}
    bias_g = {what: max(grads[what][k].abs().max().item() for k in biases)
              for what in ("fp32 unfused", "bf16 unfused")}
    print(f"resnet step-1 gradients, {route.knob}, batch {batch}, "
          f"{len(rows)} "
          f"leaves (and {len(biases)} biases before a BN, 0 when fused; "
          f"unfused max |g| fp32 {bias_g['fp32 unfused']:.3e}, bf16 "
          f"{bias_g['bf16 unfused']:.3e}): median relative L2 from fp32 unfused " + ", ".join(
              f"{what} {v:.3e}" for what, v in med.items())
          + f"; fp32 fused within {FUSED_SPREAD} x the two-pass spread, "
          f"closest call {worst32[0]:.3f} of its bound ({worst32[1]}); bf16 "
          f"fused within {FUSED_SPREAD} x the unfused bf16 distance + "
          f"{BF16_SLACK}, closest call {worst16[0]:.3f} ({worst16[1]}); "
          f"recorded, not gated: relative L2 over these leaves from the "
          f"bf16 unfused gradients, bf16 fused {d16['bf16 fused']:.3e}, bf16 "
          f"two-pass {d16['bf16 two-pass']:.3e}  ok")


def site_backward_phase(ck, nn_ops) -> None:
    """The fused op's backward at every distinct site shape of the batch-128
    step, bf16 and fp32: dx, dw, dgamma, dbeta (and dresidual) of the fused
    op (kernels forward, plain backward) and of the unfused layers (the
    port's convolution and batch_norm, add, relu) in that dtype, each
    against a plain fp64 conv + batch norm on the same values and
    cotangent. The fused distance stays within FUSED_SPREAD x the unfused
    one plus the dtype's slack."""
    slack = {torch.bfloat16: BF16_SLACK, torch.float32: FUSED_SLACK}
    worst = {dtype: (0.0, None) for dtype in slack}
    for i, (side, k, n, res, relu) in enumerate(RESNET_SITE_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(900 + i)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * scale).to(torch.bfloat16)

        # the input is a relu's (or the max pool's) output, as at the sites
        x = torch.relu(rnd(RESNET_BATCH, side, side, k))
        w = rnd(n, 1, 1, k, scale=k ** -0.5)
        gamma = (torch.rand(n, generator=g, device="cuda") + 0.5).to(
            torch.bfloat16)
        beta = rnd(n)
        r = rnd(RESNET_BATCH, side, side, n) if res else None
        gout = rnd(RESNET_BATCH, side, side, n)
        stats = (torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"))

        def fused(x, w, gamma, beta, r):
            return ck.conv1x1_bn_act_train(x, w, gamma, beta, r, eps=BN_EPS,
                                           relu=relu)[0]

        def unfused(x, w, gamma, beta, r):
            z = nn_ops.convolution(x, w, kernel=(1, 1), layout="NHWC")
            out = nn_ops.batch_norm(z, gamma, beta, *stats, eps=BN_EPS,
                                    fix_gamma=False, axis=3,
                                    training=True)[0]
            if r is not None:
                out = out + r
            return torch.relu(out) if relu else out

        def exact(x, w, gamma, beta, r):
            z = x.reshape(-1, k) @ w.reshape(n, k).t()
            mean = z.mean(0)
            var = (z - mean).square().mean(0)
            out = ((z - mean) * torch.rsqrt(var + BN_EPS) * gamma
                   + beta).reshape(*x.shape[:3], n)
            if r is not None:
                out = out + r
            return torch.relu(out) if relu else out

        def grads(fn, dtype):
            args = [None if t is None else
                    t.detach().to(dtype).requires_grad_()
                    for t in (x, w, gamma, beta, r)]
            out = fn(*args)
            return torch.autograd.grad(out, [a for a in args
                                             if a is not None],
                                       gout.to(dtype))

        ref = grads(exact, torch.float64)
        for dtype in slack:
            got = zip(("dx", "dw", "dgamma", "dbeta", "dresidual"), ref,
                      grads(fused, dtype), grads(unfused, dtype))
            for name, want, fu, un in got:
                d_f, d_u = rel(fu, want), rel(un, want)
                lim = FUSED_SPREAD * d_u + slack[dtype]
                what = (f"{name} at (M, K, N) ({RESNET_BATCH * side * side},"
                        f" {k}, {n})")
                worst[dtype] = max(worst[dtype], (d_f / lim, what),
                                   key=lambda t: t[0])
                if not d_f <= lim:
                    fail(f"fused {str(dtype)[6:]} backward, {what}: relative "
                         f"L2 from fp64 {d_f:.3e} > {lim:.3e} (unfused "
                         f"{d_u:.3e})")
    for dtype, (ratio, what) in worst.items():
        print(f"fused {str(dtype)[6:]} backward vs the unfused layers at all "
              f"{len(RESNET_SITE_SHAPES)} site shapes, batch {RESNET_BATCH}: "
              f"relative L2 from fp64 within {FUSED_SPREAD} x the unfused "
              f"one + {slack[dtype]}; the closest call at {ratio:.3f} of "
              f"its bound ({what})  ok")


def resnet_reference_recipe(mx, ck, resnet, config) -> None:
    """bench.py's lr (REFERENCE_LR) on the bf16 batch: the first step's
    update against each weight, by kind, and 5 losses. Recorded, not
    gated (see REFERENCE_LR)."""
    set_fused(config, 1)
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    step = ResNetStep(mx, net, x, y)
    step.trainer.set_learning_rate(REFERENCE_LR)
    with mx.autograd.record():
        loss = step.loss_fn(net(x), y)
    mx.autograd.backward(loss)
    ratios = {}
    for name, p in net.collect_params().items():
        if p.grad_req == "null" or not name.endswith("weight"):
            continue
        w, g = p.data().float(), p.grad().float() / RESNET_BATCH
        upd = REFERENCE_LR * (g + RESNET_OPT["wd"] * w)
        kind = ("dense" if w.dim() == 2
                else f"{w.shape[1]}x{w.shape[2]} conv")
        ratios.setdefault(kind, []).append((upd.norm() / w.norm()).item())
    net.zero_grad()
    losses, _, _ = run_resnet_steps(ck, resnet, step, RESNET_STEPS)
    print(f"resnet reference recipe, lr {REFERENCE_LR} (recorded, not "
          f"gated): first-step |lr g| / |w| by kind: " + "; ".join(
              f"{k} median {statistics.median(v):.3f} max {max(v):.3f}"
              for k, v in sorted(ratios.items()))
          + "; losses " + " ".join(f"{v:.6f}" for v in losses))


# -- 7. ----------------------------------------------------------------------


def epi_bound_ms(m, k, n, with_out):
    """Least time: x and w read once, and (with_out) the residual read and
    the output written once (bf16), else 2N fp32 statistics written; 2MKN
    bf16 tensor-core operations of the product."""
    nbytes = 2 * (m * k + k * n) + (4 * m * n + 8 * n if with_out else 8 * n)
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / PEAK_FLOPS[torch.bfloat16]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def epilogue_timings(ck, card_line) -> dict:
    out = {}
    for m, k, n in EPI_SITES:
        x, w, sc, sh, r = epi_inputs(m, k, n, torch.bfloat16, seed=700)
        times = time_ms({
            "matmul_stats": lambda: ck.matmul_stats(x, w),
            "matmul_epilogue": lambda: ck.matmul_epilogue(x, w, sc, sh, r,
                                                          True),
            "stats_plain": lambda: ck.matmul_stats_reference(x, w),
            "epilogue_plain": lambda: ck.matmul_epilogue_reference(
                x, w, sc, sh, r, True),
            "torch.matmul": lambda: torch.matmul(x, w),
        })
        med = {key: statistics.median(t) for key, t in times.items()}
        for name, plain, with_out in (
                ("matmul_stats", "stats_plain", False),
                ("matmul_epilogue", "epilogue_plain", True)):
            bound, bound_by = epi_bound_ms(m, k, n, with_out)
            out[(name, m, k, n)] = dict(
                ms=med[name], plain_ms=med[plain],
                library_ms=med["torch.matmul"], bound_ms=bound,
                bound_by=bound_by)
            print(f"{name} ({m}, {k}, {n}) bf16, {TIMING_ROUNDS} interleaved "
                  f"rounds of a CUDA graph of {TIMING_ITERS} calls: kernel "
                  f"{spread(times[name])}, "
                  f"plain {spread(times[plain])}; bound {bound:.5f} ms "
                  f"({bound_by}) [{card_line}]")
        print(f"torch.matmul of the same bf16 product ({m}, {k}, {n}), which "
              f"computes neither the statistics nor the epilogue: "
              f"{spread(times['torch.matmul'])} [{card_line}]")
    return out


def resnet_timings(resnet, config, step, card_line,
                   route=EPILOGUE) -> None:
    """The bf16 step fused and unfused: 3 warm-up steps each, then
    RESNET_TIMED_STEPS rounds of one step each, the order alternating
    between rounds; median and range of each. Then a profile of each."""
    for mode in (1, 0):
        set_fused(config, mode, route)
        host_ms(step, n=0)
    times = {1: [], 0: []}
    for rnd in range(RESNET_TIMED_STEPS):
        for mode in ((1, 0) if rnd % 2 == 0 else (0, 1)):
            set_fused(config, mode, route)
            times[mode] += host_ms(step, n=1, warmup=0)
    for mode in (1, 0):
        med = statistics.median(times[mode])
        print(f"resnet-50 bf16 train step, batch {RESNET_BATCH}, "
              f"{route.knob}={mode}: median {med:.3f} ms over "
              f"{RESNET_TIMED_STEPS} interleaved steps after 3 warm-up (min "
              f"{min(times[mode]):.3f}, max {max(times[mode]):.3f}), "
              f"{RESNET_BATCH / med * 1e3:.1f} img/s [{card_line}]")
    for mode in (1, 0):
        set_fused(config, mode, route)
        profile(step, PROFILE_STEPS, f"resnet-50 bf16 train step, batch "
                f"{RESNET_BATCH}, {route.knob}={mode}", card_line)
    set_fused(config, 1, route)


# -- 6c-6f. ------------------------------------------------------------------


def resnet_conv_bn_path(mx, ck, resnet, config, nn_ops, card_line):
    """Phases 6c-6f, with MXNET_FUSED_EPILOGUE=0 and MXNET_FUSED_CONV_BN=1;
    returns (launch counts of the bf16 main run, its step)."""
    set_fused(config, 0)
    set_fused(config, 1, CONV_BN)
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    step = ResNetStep(mx, net, x, y)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    resnet.reset_fused_conv_bn_counts()
    losses, launches, sites = run_resnet_steps(ck, resnet, step,
                                               RESNET_STEPS, CONV_BN)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"resnet conv + BN path (ResNet-50 v1, MXNET_FUSED_CONV_BN=1, "
          f"bf16, batch {RESNET_BATCH}, {RESNET_IMAGE}², {RESNET_STEPS} "
          f"SGD-momentum steps, lr {RESNET_OPT['learning_rate']}): losses "
          + " ".join(f"{v:.6f}" for v in losses) + f"; launch counts "
          f"{counts}; per step {launches[0]}, sites {sites[0]}")
    for i, (got, st) in enumerate(zip(launches, sites)):
        check_sites(f"resnet conv + BN step {i + 1}", 1, got, st, CONV_BN)
    if not all(math.isfinite(v) for v in losses):
        fail(f"resnet conv + BN bf16: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"resnet conv + BN bf16: loss did not fall over {RESNET_STEPS} "
             f"steps: {losses}")
    resnet_fused_vs_unfused(mx, ck, resnet, config, CONV_BN)
    resnet_step1_grads(mx, ck, resnet, config, CONV_BN, batch=FP32_BATCH)
    conv_bn_site_backward_phase(nn_ops)
    both_knobs_step(ck, resnet, config, step)
    return counts, step


def conv_bn_site_backward_phase(nn_ops) -> None:
    """The fused conv + BN ops' backward (kernel forward, the reference's
    backward) at every distinct 1x1 and 3x3 site shape of the batch-128
    step, bf16 and fp32: dx, dw, dgamma, dbeta of the fused op and of the
    unfused layers (the port's convolution and batch_norm) in that dtype,
    each against a plain fp64 conv + batch norm on the same values and
    cotangent; the fused distance within FUSED_SPREAD x the unfused one
    plus the dtype's slack, as phase 6b holds the epilogue op."""
    slack = {torch.bfloat16: BF16_SLACK, torch.float32: FUSED_SLACK}
    worst = {dtype: (0.0, None) for dtype in slack}
    sites = [((1, 1), side, k, n) for side, k, n in C1X1_SITE_SHAPES] + \
        [((3, 3), side, c, c) for side, c in KXK_SITE_SHAPES]
    for i, (kernel, side, k, n) in enumerate(sites):
        g = torch.Generator(device="cuda").manual_seed(950 + i)

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * scale).to(torch.bfloat16)

        pad = (kernel[0] // 2, kernel[1] // 2)
        x = torch.relu(rnd(RESNET_BATCH, side, side, k))
        w = rnd(n, *kernel, k, scale=(k * kernel[0] * kernel[1]) ** -0.5)
        gamma = (torch.rand(n, generator=g, device="cuda") + 0.5).to(
            torch.bfloat16)
        beta = rnd(n)
        gout = rnd(RESNET_BATCH, side, side, n)
        stats = (torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"))

        def fused(x, w, gamma, beta):
            if kernel == (1, 1):
                return nn_ops.fused_conv1x1_bn(x, w, None, gamma, beta,
                                               eps=BN_EPS)[0]
            return nn_ops.fused_convkxk_bn(x, w, None, gamma, beta, pad=pad,
                                           eps=BN_EPS)[0]

        def unfused(x, w, gamma, beta):
            z = nn_ops.convolution(x, w, kernel=kernel, pad=pad,
                                   layout="NHWC")
            return nn_ops.batch_norm(z, gamma, beta, *stats, eps=BN_EPS,
                                     fix_gamma=False, axis=3,
                                     training=True)[0]

        def exact(x, w, gamma, beta):
            z = nn_ops.convolution(x, w, kernel=kernel, pad=pad,
                                   layout="NHWC")
            mean = z.mean((0, 1, 2))
            var = (z - mean).square().mean((0, 1, 2))
            return (z - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta

        def grads(fn, dtype):
            args = [t.detach().to(dtype).requires_grad_()
                    for t in (x, w, gamma, beta)]
            return torch.autograd.grad(fn(*args), args, gout.to(dtype))

        ref = grads(exact, torch.float64)
        for dtype in slack:
            got = zip(("dx", "dw", "dgamma", "dbeta"), ref,
                      grads(fused, dtype), grads(unfused, dtype))
            for name, want, fu, un in got:
                d_f, d_u = rel(fu, want), rel(un, want)
                lim = FUSED_SPREAD * d_u + slack[dtype]
                what = (f"{name} at {kernel[0]}x{kernel[1]} site "
                        f"({RESNET_BATCH}, {side}, {side}, {k}) -> {n}")
                worst[dtype] = max(worst[dtype], (d_f / lim, what),
                                   key=lambda t: t[0])
                if not d_f <= lim:
                    fail(f"fused conv + BN {str(dtype)[6:]} backward, {what}"
                         f": relative L2 from fp64 {d_f:.3e} > {lim:.3e} "
                         f"(unfused {d_u:.3e})")
    for dtype, (ratio, what) in worst.items():
        print(f"fused conv + BN {str(dtype)[6:]} backward vs the unfused "
              f"layers at all {len(sites)} site shapes, batch "
              f"{RESNET_BATCH}: relative L2 from fp64 within {FUSED_SPREAD} "
              f"x the unfused one + {slack[dtype]}; the closest call at "
              f"{ratio:.3f} of its bound ({what})  ok")


def both_knobs_step(ck, resnet, config, step) -> None:
    """One bf16 step of ``step`` with MXNET_FUSED_EPILOGUE=1 as well: the
    epilogue takes the 36 1x1 sites (36 + 36 launches of its two kernels),
    the 16 3x3 sites go through convkxk_bn_stats, matmul_bn_stats launches
    never. Leaves the epilogue off."""
    set_fused(config, 1)
    c0, e0 = ck.launch_counts(), resnet.fused_epilogue_counts()
    b0 = resnet.fused_conv_bn_counts()
    _logits, loss = step()
    torch.cuda.synchronize()
    c1, e1 = ck.launch_counts(), resnet.fused_epilogue_counts()
    b1 = resnet.fused_conv_bn_counts()
    set_fused(config, 0)
    launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    epi = {k: e1[k] - e0[k] for k in e1}
    cbn = {k: b1[k] - b0[k] for k in b1}
    want = dict(EPILOGUE.launches, convkxk_bn_stats=16)
    want_cbn = dict(CONV_BN.fused_sites, **{"1x1": 0})
    print(f"resnet step with both MXNET_FUSED_EPILOGUE=1 and "
          f"MXNET_FUSED_CONV_BN=1: launches {launches}, epilogue sites "
          f"{epi}, conv + BN sites {cbn}, loss "
          f"{loss.float().mean().item():.6f}")
    if launches != want or epi != EPILOGUE.fused_sites or cbn != want_cbn:
        fail(f"both knobs: want launches {want}, epilogue sites "
             f"{EPILOGUE.fused_sites}, conv + BN sites {want_cbn}")
    if not torch.isfinite(loss).all():
        fail("both knobs: non-finite loss")


# -- 7b. ---------------------------------------------------------------------


def conv_bn_bound_ms(nbytes, ops):
    """Least time for bf16 work: nbytes over HBM, ops over the tensor
    cores."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[torch.bfloat16]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def conv_bn_timings(ck, card_line) -> dict:
    """B4 at the stage-1 and stage-4 conv3 sites and B8 at the stage-1 and
    stage-4 3x3 sites (bf16, batch 128), their plain versions and the
    library call of the bare conv (``torch.matmul`` / cuDNN ``F.conv2d`` on
    channels_last views), which computes no statistics, each as CUDA-graph
    replays beside its bound: x and w read once, z (or y) written once, 2
    fp32 sums per channel; 2 M K N tensor-core operations."""
    import torch.nn.functional as F
    out = {}
    for m, k, n in EPI_SITES:
        x, w = epi_inputs(m, k, n, torch.bfloat16, seed=720)[:2]
        times = time_ms({
            "matmul_bn_stats": lambda: ck.matmul_bn_stats(x, w),
            "plain": lambda: ck.matmul_bn_stats_reference(x, w),
            "torch.matmul": lambda: torch.matmul(x, w),
        })
        bound, bound_by = conv_bn_bound_ms(
            2 * (m * k + k * n + m * n) + 8 * n, 2 * m * k * n)
        out[("matmul_bn_stats", (m, k, n))] = dict(
            shape=[m, k, n, "bf16"], ms=statistics.median(
                times["matmul_bn_stats"]),
            plain_ms=statistics.median(times["plain"]),
            library_ms=statistics.median(times["torch.matmul"]),
            bound_ms=bound, bound_by=bound_by)
        print(f"matmul_bn_stats ({m}, {k}, {n}) bf16, {TIMING_ROUNDS} "
              f"interleaved rounds of a CUDA graph of {TIMING_ITERS} calls: "
              f"kernel {spread(times['matmul_bn_stats'])}, plain "
              f"{spread(times['plain'])}, torch.matmul of the product (no "
              f"statistics) {spread(times['torch.matmul'])}; bound "
              f"{bound:.5f} ms ({bound_by}) [{card_line}]")
    for side, c in (KXK_SITE_SHAPES[0], KXK_SITE_SHAPES[-1]):
        xshape = (RESNET_BATCH, side, side, c)
        x, w = kxk_inputs(xshape, c, (3, 3), torch.bfloat16, seed=730)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        times = time_ms({
            "convkxk_bn_stats": lambda: ck.convkxk_bn_stats(x, w, (1, 1)),
            "plain": lambda: ck.convkxk_bn_stats_reference(x, w, (1, 1)),
            "F.conv2d": lambda: F.conv2d(xc, wc, padding=1),
        })
        m, kk = RESNET_BATCH * side * side, 9 * c
        bound, bound_by = conv_bn_bound_ms(
            2 * (2 * x.numel() + w.numel()) + 8 * c, 2 * m * kk * c)
        out[("convkxk_bn_stats", xshape)] = dict(
            shape=[*xshape, c, "bf16"], ms=statistics.median(
                times["convkxk_bn_stats"]),
            plain_ms=statistics.median(times["plain"]),
            library_ms=statistics.median(times["F.conv2d"]),
            bound_ms=bound, bound_by=bound_by)
        print(f"convkxk_bn_stats {xshape} -> {c}, 3x3 pad 1, bf16, "
              f"{TIMING_ROUNDS} interleaved rounds of a CUDA graph of "
              f"{TIMING_ITERS} calls: kernel "
              f"{spread(times['convkxk_bn_stats'])}, plain "
              f"{spread(times['plain'])}, cuDNN F.conv2d on channels_last "
              f"(no statistics) {spread(times['F.conv2d'])}; bound "
              f"{bound:.5f} ms ({bound_by}) [{card_line}]")
    return out


# -- 9. ----------------------------------------------------------------------


def int8_bound_ms(m, k, n, out_bytes):
    """Least time for an s8 (m, k) x (k, n) product: x and w read once, the
    output (out_bytes per element) written once, over HBM; 2 m k n
    operations over the int8 tensor cores."""
    t_mem = (m * k + k * n + out_bytes * m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / INT8_TOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def int8_operands(m, k, n, seed):
    """x (m, k) and w (k, n), s8 uniform in [-127, 127], on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8),
            torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8))


def int8_path(ck) -> tuple:
    """Phase 9a: every call of the int8 path through ``int8_matmul``, with
    the counts zeroed just before and read just after (one launch per call,
    nothing else launched), then each output against
    ``int8_matmul_reference`` on the same inputs, bitwise. Returns (the
    counts, the largest |kernel - plain| of an fp32 output)."""
    calls = []      # (what, x, w, relu, out_scale)
    x, w = int8_operands(*INT8_MICRO, seed=900)
    calls += [("microbench dequant", x, w, False, None),
              ("microbench relu + requant", x, w, True, INT8_OUT_SCALE)]
    for i, (m, k, n) in enumerate(INT8_CASES):
        x, w = int8_operands(m, k, n, seed=910 + i)
        calls += [(f"({m}, {k}, {n}) dequant", x, w, False, None),
                  (f"({m}, {k}, {n}) relu + requant", x, w, True,
                   INT8_OUT_SCALE)]
    for i, (side, k, n) in enumerate(C1X1_SITE_SHAPES):
        m = INT8_BATCH * side * side
        x, w = int8_operands(m, k, n, seed=920 + i)
        calls.append((f"site ({m}, {k}, {n}) relu + requant", x, w, True,
                      INT8_OUT_SCALE))
    # constant +-127 operands: |acc| near 127^2 K, the largest sums, past
    # 2^24 and not multiples of 4, so that their conversion to fp32 rounds
    m, k, n = 4096, 2048, 256
    x = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
    x[1::2] = -127
    x[:, 0] = 1
    w = torch.full((k, n), -127, dtype=torch.int8, device="cuda")
    w[:, ::3] = 127
    calls += [("+-127 dequant", x, w, False, None),
              ("+-127 relu + requant", x, w, True, 0.01)]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    outs = []
    for what, x, w, relu, out_scale in calls:
        before = ck.launch_counts()["int8_matmul"]
        outs.append(ck.int8_matmul(x, w, INT8_SCALE, relu=relu,
                                   out_scale=out_scale))
        if ck.launch_counts()["int8_matmul"] != before + 1:
            fail(f"int8 path, {what}: int8_matmul launched "
                 f"{ck.launch_counts()['int8_matmul'] - before} times, want 1")
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    want = {name: 0 for name in counts}
    want["int8_matmul"] = len(calls)
    if counts != want:
        fail(f"int8 path: launch counts {counts}, want {want}")
    worst = 0.0
    for (what, x, w, relu, out_scale), out in zip(calls, outs):
        ref = ck.int8_matmul_reference(x, w, INT8_SCALE, relu=relu,
                                       out_scale=out_scale)
        if out.dtype != ref.dtype or out.shape != ref.shape:
            fail(f"int8 path, {what}: out {out.dtype} {tuple(out.shape)}, "
                 f"plain {ref.dtype} {tuple(ref.shape)}")
        if not torch.equal(out, ref):
            err = (out.float() - ref.float()).abs()
            fail(f"int8 path, {what}: kernel vs plain not bitwise equal: "
                 f"{int((err > 0).sum())} entries differ, max |diff| "
                 f"{err.max().item():.3e}")
        if out.dtype == torch.float32:
            worst = max(worst, (out - ref).abs().max().item())
        if not torch.isfinite(out.float()).all():
            fail(f"int8 path, {what}: non-finite output")
    if outs[-2].abs().max().item() < 2 ** 24 * INT8_SCALE:
        fail("int8 path: the +-127 case did not reach |acc| > 2^24")
    print(f"int8_matmul vs plain: {len(calls)} calls (the microbench shape "
          f"{INT8_MICRO}, {INT8_CASES}, {len(C1X1_SITE_SHAPES)} 1x1 site "
          f"shapes at batch {INT8_BATCH}, +-127 operands), one launch each, "
          f"{counts['int8_matmul']} in all; all bitwise equal  ok")
    return counts, worst


def _to(args, device):
    """args with every tensor (also inside lists) moved to device."""
    if isinstance(args, torch.Tensor):
        return args.to(device)
    if isinstance(args, (list, tuple)):
        return type(args)(_to(a, device) for a in args)
    return args


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def int8_ops_phase(tq) -> int:
    """Phase 9b: each int8 op on the card against the same op on the CPU
    with the same inputs (numpy from a seed), at ResNet-50's widths, batch
    INT8_OPS_BATCH (``quantize`` and the fully connected layer at batch
    INT8_BATCH): every output (s8, s32, fp32 and the fp32 ranges) bitwise
    equal. Returns the number of outputs compared."""
    rng = np.random.RandomState(930)
    b = INT8_OPS_BATCH

    def s8(*shape):
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(
            np.int8))

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    compared = 0

    def same(what, fn, *args, **kw):
        nonlocal compared
        got = _outputs(fn(*_to(args, "cuda"), **kw))
        want = _outputs(fn(*args, **kw))
        for i, (g, w) in enumerate(zip(got, want)):
            if g.device.type != "cuda":
                fail(f"int8 op {what}: output {i} on {g.device}")
            g = g.cpu()
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.equal(g, w):
                diff = (g.double() - w.double()).abs().max().item() \
                    if g.shape == w.shape else float("nan")
                fail(f"int8 op {what}: output {i} on the card vs the CPU: "
                     f"{g.dtype} {tuple(g.shape)} vs {w.dtype} "
                     f"{tuple(w.shape)}, max |diff| {diff:.3e}")
            compared += 1

    epi = dict(data_scale=0.02, w_scale=0.003, fused_relu=True,
               out_min=-2.3, out_max=3.7)
    same(f"quantize ({INT8_BATCH}, 56, 56, 64)", tq.quantize,
         f32(INT8_BATCH, 56, 56, 64, scale=1.5), -2.3, 3.7)
    for side, k, n in C1X1_SITE_SHAPES:
        same(f"quantized_conv 1x1 {side}x{side} {k} -> {n}",
             tq.quantized_conv, [s8(b, side, side, k), s8(n, 1, 1, k),
                                 f32(n, scale=0.1)],
             kernel=(1, 1), num_filter=n, layout="NHWC", **epi)
    side, k, n = C1X1_SITE_SHAPES[-1]
    same(f"quantized_conv 1x1 {side}x{side} {k} -> {n}, fp32 out",
         tq.quantized_conv, [s8(b, side, side, k), s8(n, 1, 1, k),
                             f32(n, scale=0.1)],
         kernel=(1, 1), num_filter=n, layout="NHWC", data_scale=0.02,
         w_scale=0.003)
    for side, c in KXK_SITE_SHAPES:
        same(f"quantized_conv 3x3 {side}x{side} {c} -> {c}",
             tq.quantized_conv, [s8(b, side, side, c), s8(c, 3, 3, c),
                                 f32(c, scale=0.1)],
             kernel=(3, 3), pad=(1, 1), num_filter=c, layout="NHWC", **epi)
    same("quantized_conv stem 7x7/2 224x224 3 -> 64", tq.quantized_conv,
         [s8(b, 224, 224, 3), s8(64, 7, 7, 3), f32(64, scale=0.1)],
         kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
         layout="NHWC", **epi)
    same("quantized_pooling max 3x3/2 pad 1 (b, 64, 112, 112)",
         tq.quantized_pooling, s8(b, 64, 112, 112), -2.3, 3.7,
         kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")
    same("quantized_pooling global avg (b, 2048, 7, 7)",
         tq.quantized_pooling, s8(b, 2048, 7, 7), -2.3, 3.7,
         pool_type="avg", global_pool=True)
    for out in ({}, dict(fused_relu=True, out_min=-2.3, out_max=3.7)):
        same(f"quantized_fully_connected 2048 -> 1000, batch {INT8_BATCH}"
             f"{', relu + requant' if out else ''}",
             tq.quantized_fully_connected,
             [s8(INT8_BATCH, 2048), s8(1000, 2048), f32(1000)],
             num_hidden=1000, data_scale=0.02, w_scale=0.003, **out)
    same("quantized_elemwise_add (b, 56, 56, 256)",
         tq.quantized_elemwise_add, s8(b, 56, 56, 256), s8(b, 56, 56, 256),
         -2.3, 3.7, -0.1, 0.1)
    same("quantized_batch_norm (b, 64, 56, 56)", tq.quantized_batch_norm,
         s8(b, 64, 56, 56), f32(64) + 1.0, f32(64), f32(64, scale=0.3),
         f32(64).abs() + 0.1, -2.3, 3.7, min_calib_range=-3.7,
         max_calib_range=3.7)
    torch.cuda.synchronize()
    print(f"int8 ops on the card vs the CPU at ResNet-50's widths, batch "
          f"{b}: {compared} outputs bitwise equal (quantize, every 1x1 and "
          f"3x3 site and the stem, pooling, fully connected, elemwise add, "
          f"batch norm); pallas_skipped_count {tq.pallas_skipped_count()}  "
          f"ok")
    return compared


def int8_timings(ck, card_line) -> dict:
    """Phase 9c: at the microbench shape, the kernel's dequant and relu +
    requant rows, ``torch._int_mm`` plus the same epilogue (the library
    yardstick, never called by the port), the bf16 matmul of the
    dequantized operands (the microbench's bf16 row) and the plain version,
    as CUDA-graph replays beside their bounds; the dequant row also at the
    two timed 1x1 sites. ``_int_mm`` is also timed with w column major, the
    layout cuBLASLt's s8 kernels read natively, as information."""
    s, os_ = float(np.float32(INT8_SCALE)), float(np.float32(INT8_OUT_SCALE))

    def lib_dequant(x, w):
        return torch._int_mm(x, w).to(torch.float32) * s

    def lib_requant(x, w):
        out = torch.clamp_min(torch._int_mm(x, w).to(torch.float32) * s, 0.0)
        return torch.clamp(torch.round(out * os_), -127.0, 127.0).to(
            torch.int8)

    out = {}
    m, k, n = INT8_MICRO
    x, w = int8_operands(m, k, n, seed=950)
    wt = w.t().contiguous().t()       # the same w, column major
    bx = (x.float() * s).to(torch.bfloat16)
    bw = w.to(torch.bfloat16)
    times = time_ms({
        "int8_matmul": lambda: ck.int8_matmul(x, w, INT8_SCALE),
        "plain": lambda: ck.int8_matmul_reference(x, w, INT8_SCALE),
        "_int_mm + dequant": lambda: lib_dequant(x, w),
        "_int_mm, w col-major": lambda: lib_dequant(x, wt),
        "int8_matmul requant": lambda: ck.int8_matmul(
            x, w, INT8_SCALE, relu=True, out_scale=INT8_OUT_SCALE),
        "plain requant": lambda: ck.int8_matmul_reference(
            x, w, INT8_SCALE, relu=True, out_scale=INT8_OUT_SCALE),
        "_int_mm + relu + requant": lambda: lib_requant(x, w),
        "bf16 matmul": lambda: torch.matmul(bx, bw),
    })
    med = {name: statistics.median(t) for name, t in times.items()}
    b32, by32 = int8_bound_ms(m, k, n, 4)
    b8, by8 = int8_bound_ms(m, k, n, 1)
    t_mem = 2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / PEAK_FLOPS[torch.bfloat16]
    bbf, bybf = max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                          else "operations")
    print(f"int8 timings at {INT8_MICRO}, {TIMING_ROUNDS} interleaved rounds "
          f"of a CUDA graph of {TIMING_ITERS} calls [{card_line}]:")
    for name, bound, by in (
            ("int8_matmul", b32, by32), ("plain", b32, by32),
            ("_int_mm + dequant", b32, by32),
            ("_int_mm, w col-major", b32, by32),
            ("int8_matmul requant", b8, by8), ("plain requant", b8, by8),
            ("_int_mm + relu + requant", b8, by8),
            ("bf16 matmul", bbf, bybf)):
        print(f"  {name:26s} {spread(times[name])}; bound {bound:.5f} ms "
              f"({by}); {2 * m * k * n / med[name] / 1e9:.1f} TOP/s")
    out["micro"] = dict(
        shape=[m, k, n, "s8"], ms=med["int8_matmul"], plain_ms=med["plain"],
        library_ms=med["_int_mm + dequant"], bound_ms=b32, bound_by=by32,
        requant=dict(ms=med["int8_matmul requant"],
                     plain_ms=med["plain requant"],
                     library_ms=med["_int_mm + relu + requant"],
                     bound_ms=b8, bound_by=by8),
        library_w_col_major_ms=med["_int_mm, w col-major"],
        bf16_matmul_ms=med["bf16 matmul"], bf16_bound_ms=bbf)
    out["sites"] = []
    for i, (m, k, n) in enumerate(INT8_TIMED_SITES):
        x, w = int8_operands(m, k, n, seed=960 + i)
        times = time_ms({
            "int8_matmul": lambda: ck.int8_matmul(x, w, INT8_SCALE),
            "plain": lambda: ck.int8_matmul_reference(x, w, INT8_SCALE),
            "_int_mm + dequant": lambda: lib_dequant(x, w),
        })
        bound, by = int8_bound_ms(m, k, n, 4)
        out["sites"].append(dict(
            shape=[m, k, n, "s8"],
            ms=statistics.median(times["int8_matmul"]),
            plain_ms=statistics.median(times["plain"]),
            library_ms=statistics.median(times["_int_mm + dequant"]),
            bound_ms=bound, bound_by=by))
        print(f"int8_matmul site ({m}, {k}, {n}) dequant: kernel "
              f"{spread(times['int8_matmul'])}, plain "
              f"{spread(times['plain'])}, _int_mm + dequant "
              f"{spread(times['_int_mm + dequant'])}; bound {bound:.5f} ms "
              f"({by}) [{card_line}]")
    return out


def port_int8():
    """The port's contrib.quantization."""
    from mxnet_tpu_torch.contrib import quantization
    return quantization


def port_gluon():
    """(mxnet_tpu_torch, its config, the resnet module, its nn ops) beside
    this file."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.ops import nn as nn_ops
    return mx, config, resnet, nn_ops


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    models, ck, _build = port()
    mx, config, resnet, nn_ops = port_gluon()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = build_phase(_build)
    ck.reset_launch_counts()
    fwd_err = fwd_kernel_phase(ck)
    bwd_err = bwd_kernel_phase(ck)
    epi_err = epilogue_kernel_phase(ck)
    cbn_err = conv_bn_kernel_phase(ck)
    print(f"launch counts after the comparisons: {ck.launch_counts()}")

    # -- the LM paths -------------------------------------------------------
    cfg = bert_base(models)

    def init():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return models.init_params(cfg, gen, device="cuda")

    params = init()
    rng = np.random.RandomState(0)
    requests = [batch(rng, cfg, B, S) for B, S in REQUESTS]
    fwd_counts = forward_path(models, ck, cfg, params, requests)
    train_counts = train_path(models, ck, cfg, init, rng)

    attn_times = fwd_timings(ck, cfg, card_line)
    bwd_times = bwd_timings(ck, cfg, card_line)
    forward_timings(models, cfg, params, requests, attn_times, card_line)
    train_timings(models, cfg, init(), rng, bwd_times, card_line)
    del params, requests
    torch.cuda.empty_cache()

    # -- the ResNet train path ----------------------------------------------
    resnet_counts, _net, step = resnet_train_path(mx, ck, resnet, config,
                                                  card_line)
    site_backward_phase(ck, nn_ops)
    epi_times = epilogue_timings(ck, card_line)
    resnet_timings(resnet, config, step, card_line)
    del _net, step
    torch.cuda.empty_cache()

    # -- the fused conv + batch-norm path ------------------------------------
    cbn_counts, step = resnet_conv_bn_path(mx, ck, resnet, config, nn_ops,
                                           card_line)
    cbn_times = conv_bn_timings(ck, card_line)
    resnet_timings(resnet, config, step, card_line, CONV_BN)
    del step
    torch.cuda.empty_cache()

    # -- 9. int8 --------------------------------------------------------------
    int8_counts, int8_err = int8_path(ck)
    int8_ops_phase(port_int8())
    int8_times = int8_timings(ck, card_line)

    # -- 10. results --------------------------------------------------------
    paths = {"forward": fwd_counts, "train": train_counts,
             "resnet_train": resnet_counts, "resnet_conv_bn": cbn_counts,
             "int8": int8_counts}

    def launches(name):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    t = attn_times[(96, 512)]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:49",
        **launches("flash_attention_fwd"),
        "max_abs_err": fwd_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": [96, 512, 64, "bf16"],
    }]
    bh, s = TRAIN_TOKENS[0] * cfg.num_heads, TRAIN_TOKENS[1]
    for name, line in (("flash_attention_bwd_dq", 95),
                       ("flash_attention_bwd_dkv", 126)):
        t = bwd_times[(name, bh, s)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            **launches(name),
            "max_abs_err": bwd_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": "scaled_dot_product_attention backward, against "
                       "dq + dk/dv + delta",
            "shape": [bh, s, 64, "bf16"],
        })
    for name, line in (("matmul_stats", 512), ("matmul_epilogue", 574)):
        sites = [dict(shape=[m, k, n, "bf16"], **epi_times[(name, m, k, n)])
                 for m, k, n in EPI_SITES]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/conv_bn_epilogue.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            **launches(name), "max_abs_err": epi_err[name],
            **{k: sites[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "library": "torch.matmul of the same product, which computes "
                       "neither the statistics nor the epilogue",
            "shape": sites[0]["shape"], "sites": sites,
        })
    for name, line, src in (("matmul_bn_stats", 316, "conv_bn_epilogue"),
                            ("convkxk_bn_stats", 880, "convkxk_bn_stats")):
        sites = [t for (kname, _), t in cbn_times.items() if kname == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/ops/csrc/{src}.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            **launches(name), "max_abs_err": cbn_err[name],
            **{k: sites[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "library": ("torch.matmul of the same product"
                        if name == "matmul_bn_stats" else
                        "cuDNN F.conv2d of the same conv")
            + ", which computes no statistics",
            "shape": sites[0]["shape"], "sites": sites,
        })
    t = int8_times["micro"]
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:752",
        **launches("int8_matmul"), "max_abs_err": int8_err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        "library": "torch._int_mm plus the same fp32 dequant",
        "shape": t["shape"], "requant": t["requant"],
        "library_w_col_major_ms": t["library_w_col_major_ms"],
        "bf16_matmul_ms": t["bf16_matmul_ms"], "sites": int8_times["sites"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
