#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card and build: print the card's name and power limit (nvidia-smi), build
   every CUDA kernel from ``mxnet_tpu_torch/ops/csrc`` and print the seconds,
   then each wgmma kernel's registers, shared memory and spills (the
   forward, the backward, the GEMM core's matmul epilogue, statistics and
   KxK conv-statistics kernels, and the s8 matmul; fails on a spill).
2. Forward kernel vs. plain version on the card: the flash-attention
   forward's ``out`` and ``lse`` against ``flash_attention_fwd_reference`` on
   the same inputs, at the LM's shapes and at ragged / fp32 / fp16 / other
   head-dim / sharp-softmax cases, at the train step's shape (384, 128, 64),
   and at every head dim of ``BWD_HEAD_DIMS`` in bf16 and fp16, causal and
   not, at s in ``FWD_SEQS``, each within its stated tolerance. This phase
   is the gate on the kernel: its inputs give scores of std 1 (or 8), where
   a wrong q k^T or a wrong rescale across k-tiles shows. 16-bit cases are
   also held to the rounding the kernel's design allows (``check_p16``).
   Every case is held to bitwise repeatability of out and lse over two
   calls, and to the kernel's q-tile choice being ``flash_fwd_q_tile``'s.
2b. Backward kernels vs. plain version: ``dq``, ``dk``, ``dv`` of ``_bwd``
   (the dq kernel, which also computes delta, and the dk/dv kernel) against
   ``flash_attention_bwd_reference`` on the same (q, k, v, out, lse, do), out
   and lse from the forward kernel, at the train path's shapes, at causal /
   sharp / fp16 / d=128 / ragged fp32 cases, and at every head dim of
   ``BWD_HEAD_DIMS`` in bf16 and fp16, causal and not, at ragged s. 16-bit
   cases are also held to the rounding of p and ds (``check_bwd16``). Every
   case is also held to bitwise repeatability of dq, dk and dv over two
   calls, and the dq kernel's delta to the plain delta. The plain backward
   is itself held against autograd through the plain forward.
3. The forward path: the BERT-base-width LM (vocab 30528, 12 x 768, 12
   heads, MLP 3072, bf16; random weights from a seeded generator) serves
   requests of tokens (4, 128) and (8, 512) through ``forward`` and
   ``loss_fn``, with the launch counts zeroed just before and read just
   after. Each forward must launch the kernel once per layer with no
   fallback and agree with the einsum attention path; ``loss_fn`` must match
   a plain masked NLL (``F.cross_entropy``) of the einsum path's logits. At
   random init the scores are near zero, so this phase checks the model
   around the kernel, not the kernel.
3b. The train path at the same width: ``make_train_step`` (captured, the
   default) takes 5 Adam and 5 LAMB steps on a fixed batch of tokens
   (32, 128) (``bench.py``'s bert lane), with the counts zeroed just
   before and read just after: falling
   finite loss, exactly one launch of each of the three kernels per layer per
   step, no fallback. Then single steps: attention's gradients through the
   kernels against the einsum path, ``grad_accum=2``, ``remat=True``, and a
   step at tokens (8, 512).
4. Timings: each kernel, its plain version and the library call that
   computes the same function (``scaled_dot_product_attention`` and its
   backward; never called by the port) at the main paths' shapes (the
   forward at both requests' and at the train step's), each
   timed as interleaved replays of a CUDA graph, beside its bound: the dq
   kernel (delta included), the dk/dv kernel, the whole backward as
   ``_bwd`` runs it, and the plain delta pass as a yardstick; median
   forward time per request shape and median train-step time;
   ``torch.profiler`` traces of a few forwards and train steps (device-busy
   time, idle share, top kernels; no plain delta pass in the step).
5. Epilogue kernels vs. plain version: ``matmul_stats`` and
   ``matmul_epilogue`` (``conv_bn_epilogue.cu``) against their plain
   versions, bf16 and fp32, ragged M, K in {64, 256, 1024}, N in {64, 256,
   2048}, with and without the residual and the ReLU, at the narrow edges N
   in {8, 24, 72} and K in {8, 24} with ragged M, and at every distinct site
   shape of the ResNet-50 step (bf16 at batch 128, fp32 at batch 32); both
   kernels' outputs must also be bitwise repeatable, and the epilogue
   kernel's tile width ``epilogue_tile_n``'s. ``matmul_stats`` also at the
   edges with N in ``STATS_EDGE_NS`` and at ``STATS_WALK_CASES``, where
   every CTA sums several m-tiles of its n-tile.
5b. Conv + batch-norm statistics kernels vs plain version: ``matmul_bn_stats``
   (``conv_bn_epilogue.cu``) and ``convkxk_bn_stats``
   (``convkxk_bn_stats.cu``) against their plain versions, bf16 and fp32,
   ragged M, the ``KXK_CASES`` geometries with the image border scaled by
   ``BORDER``, and every distinct site shape of the ResNet-50 step, and
   ``matmul_bn_stats`` at the edges and walks of phase 5, with and without
   the relu; the statistics must also be bitwise repeatable.
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
   graph replays, each beside its bound; ``matmul_epilogue`` and
   ``torch.matmul`` at all 16 site shapes, and their sums over the 36
   launches of a step beside the bound's; the bf16 step fused and unfused
   (10 interleaved steps after 3 warm-up); a profile of each.
7b. The same for the conv + batch-norm kernels (library: ``torch.matmul``,
   cuDNN ``F.conv2d``) and for the step on that route: ``convkxk_bn_stats``
   at all four 3x3 site shapes with its sums over the 16 launches of a
   step; ``matmul_stats`` and ``matmul_bn_stats`` and ``torch.matmul`` at
   every distinct 1x1 site shape, and each kernel's sums over the 36
   launches of a step beside its bound's.
8. Capture (``program_store``, ``cached_step``): the LM forward at both
   request shapes through ``program_store.capture``; 5 Adam and 5 LAMB LM
   steps at tokens (32, 128) through the captured ``make_train_step``; the
   bf16 ResNet-50 step at batch 128 through ``trainer.compile_step`` on
   each route (unfused, ``MXNET_FUSED_EPILOGUE=1``,
   ``MXNET_FUSED_CONV_BN=1``), its learning rate lowered after step 3; and
   the hybridized ResNet-50 forward in predict mode. Each runs twice
   eagerly and once captured from the same state, with the counts zeroed
   before the phase and read after it: captured equal to eager bitwise
   where the two eager runs are bitwise equal, else within FUSED_SPREAD x
   their spread (the rule used is printed); 1 capture, 1 dispatch a step
   or call and none after warm-up; launches and fused sites per step as
   eager's; no fallback on a timed step; each call's output its own. Then
   eager against captured wall (10 host-clock calls, unprofiled), device
   busy, event span, the host's ms a call, idle share and peak memory of
   each path, and a JSON line of them. The captured wall must be below the
   eager wall for the LM forward at (4, 128) and the LM train step.
   Phases 6-7b drive the eager classic loop (MXNET_COMPILED_STEP=0: a
   hybridized block's recorded forward runs eagerly); 8g graphs it.
8d. ``bench.py``'s ResNet lane through ``parallel.ShardedTrainer``
   (``make_mesh({"dp": 1})``, ``compute_dtype=torch.bfloat16`` over fp32
   masters, int32 labels, SGD momentum at RESNET_LR) on each route, 5 steps
   in two eager runs (the same body with no program) and one captured:
   captured against eager by phase 8's rule, masters and momenta fp32, 1
   capture and 1 dispatch a step, launches and sites per step as
   ``compile_step``'s, a falling loss; eager against captured numbers and
   img/s; then ``grad_accum=2`` (2 x 64) for two steps.
8e. ``compile_step(accum_steps=2)`` on the conv + BN route, bf16, windows
   of 2 x 64: 3 dispatches a window, each grad replay's launches traced,
   the windows held against two eager windows of the same recipe
   (``grad_req='add'``, two recorded micro-batches, one ``trainer.step``).
8f. ``compile_step(bucket=True)`` with a pad-safe masked loss on ResNet-50
   with frozen batch norms, batches of ``BUCKET_SIZES`` in one bucket: one
   program, each size checked once and accepted.
8g. The classic loop on the conv + BN route, bf16 b128, with the recorded
   forward as one graphed tape node, against the eager loop: the same
   gates as 8c, then eager against graphed wall and host ms a step.
   The counts are zeroed before 8d and read after 8g (path
   ``compiled_steps``); a JSON line holds 8d's and 8g's numbers beside
   phase 8c's pure-bf16 ``compile_step`` ones.
8h. The imperative substrate (``ops.registry``, ``NDArray``, ``invoke``,
   ``mx.nd``, autograd on NDArrays). (a) The op sweep: every registered op
   on the card against the port on the CPU, fp32 with TF32 off, on the
   inputs of ``tests/op_smoke_specs.py`` (the fused ops at 8 input
   channels, the kernels' rule) or a seeded (4, 6) input: forwards within
   SWEEP_TOL, gradients of the summed float outputs within
   SWEEP_GRAD_TOL, the samplers by shape, dtype, moments and seeded
   repeats; the count of ops checked is printed. (b) The README's quick
   start on gpu(0) at its widths, fed NDArrays, README_STEPS Adam steps:
   falling loss, the recorded forward one graphed tape node. (c) SKILL.md's
   SGD loop: final loss below SKILL_LOSS_MAX, each loss within SKILL_RTOL
   of the CPU's. (d) With the counts zeroed just before and read just
   after (path ``nd``), 8g's classic loop fed ``nd.array(...,
   ctx=mx.gpu(0))`` on the conv + BN and epilogue routes, eager
   (MXNET_COMPILED_STEP=0) and graphed, each held bitwise against the same
   loop fed tensors from the same weights, with the route's launch and
   site gates and 1 capture and 1 dispatch a graphed step; ``invoke``
   dispatches a step printed; then eager fed NDArrays against eager fed
   tensors and graphed fed NDArrays: wall, device busy, host ms a step, in
   a JSON line.
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

import ctypes
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
# The forward kernel at every head dim of the backward's cases: d padded to
# one 64-column TMA box (8, 24, 40, 64) and to two (72, 120, 128), bf16 and
# fp16, causal and not, at s of one row, of one 64-row q-tile and a row
# (65), ragged (77, 200) and long (1000), so that the zero fill of columns
# past d and of rows past s, and the stores' clipping, show
FWD_SEQS = (1, 65, 77, 200, 1000)
FWD_HEAD_DIM_CASES = [(2, s, d, dtype, causal, 1.0) for d in (8, 24, 40, 64,
                                                              72, 120, 128)
                      for dtype in (torch.bfloat16, torch.float16)
                      for causal in (False, True) for s in FWD_SEQS]
# the train path's attention shape, tokens (32, 128), 12 heads
FWD_TRAIN_CASE = (384, 128, 64, torch.bfloat16, False, 1.0)
# timed forward shapes (bh, s) at d 64, bf16: the two requests and the
# train step's
FWD_TIMED = [(48, 128), (96, 512), (384, 128)]
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
# Head dims of the 16-bit backward kernels beyond the cases above: d padded
# to one 64-column TMA box (8, 24, 40, 64) and to two (72, 120, 128), bf16
# and fp16, causal and not, at ragged s, so that the zero fill of columns
# past d and of rows past s shows
BWD_HEAD_DIMS = (8, 24, 40, 64, 72, 120, 128)
BWD_HEAD_DIM_CASES = [(2, s, d, dtype, causal, 1.0) for d in BWD_HEAD_DIMS
                      for dtype in (torch.bfloat16, torch.float16)
                      for causal in (False, True) for s in (77, 200)]
# the dq kernel's delta against the plain delta, per row: fp32 sums of the
# same exact products (16-bit x 16-bit fits fp32) in another order, within
# DELTA_RTOL of rowsum(|do * o|)
DELTA_RTOL = 1e-6
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
# a profiler trace can miss the first kernels of a graph replay that starts
# as soon as the trace does (the LM train step's flash-forward launches),
# and misses none after a 50 ms wait inside the trace before the replay:
# tools/torch_trace_settle.py counts both (PERF.md). traced_launches
# waits so long
TRACE_SETTLE_S = 0.05
# -- the ResNet path --
# (M, K, N) cases of the epilogue kernels vs their plain versions: M ragged
# (not a multiple of either m-tile, 128 rows for bf16 and 64 for fp32)
EPI_MS = (1000, 3001)
EPI_KS = (64, 256, 1024)
EPI_NS = (64, 256, 2048)
# ... and at the narrowest N and K the kernels take, where the copies'
# zero fill and the stores' clipping do the work: N in {8, 24, 72} (inside
# one 64- or 128-column tile) and K in {8, 24} (inside one 64-wide k-box),
# ragged M
EPI_EDGE_MS = (77, 1000)
EPI_EDGE_KS = (8, 24)
EPI_EDGE_NS = (8, 24, 72)
# ... and for the statistics kernels also N in {264, 2048}: several n-tiles,
# the last of them narrow (264 = 256 + 8)
STATS_EDGE_NS = EPI_EDGE_NS + (264, 2048)
# the statistics kernels' static walk: (M, K, N) where every CTA takes
# several m-tiles of its one n-tile, with several n-tiles (the scratch rows
# of every n-tile written, each by one CTA) and a narrow last n-tile
STATS_WALK_CASES = [(40000, 64, 2048), (20000, 24, 264), (10000, 136, 1032),
                    (70000, 64, 64)]
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
# launches of each site shape per step: blocks (3, 4, 6, 3) per stage; the
# first block's conv1 and downsample once, conv3 in every block, the other
# blocks' conv1 in all but the first
RESNET_BLOCKS = (3, 4, 6, 3)
RESNET_SITE_LAUNCHES = [n for nb in RESNET_BLOCKS for n in (1, 1, nb, nb - 1)]
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
KXK_SITE_LAUNCHES = list(RESNET_BLOCKS)   # one 3x3 conv per bottleneck block
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

# -- the capture phase (program_store, cached_step) --
# the captured ResNet step's learning rate drops to CAPTURE_LR2 after
# CAPTURE_LR_STEP steps: the next steps must take it with no new capture,
# as the eager runs that take it too show
CAPTURE_LR_STEP, CAPTURE_LR2 = 3, RESNET_LR / 2
CAPTURE_TIMED = 10       # host-clock samples of each path, eager and captured
# the routes of the ResNet step under capture (see capture_route)
CAPTURE_ROUTES = ("unfused", "epilogue", "conv_bn")
# compile_step(accum_steps=2): windows of 2 x RESNET_BATCH / 2 (the first
# captures); compile_step(bucket=True): batch sizes of one bucket
ACCUM_WINDOWS = 2
BUCKET_SIZES = (96, 112, 128, 96)


# -- the int8 path --
# benchmark/microbench_tpu.py section_int8_pallas: ResNet-50's 1x1 conv at
# batch 32 and 28x28, 512 -> 128, as a matmul; its scale and requantize
# multiplier
INT8_MICRO = (32 * 28 * 28, 512, 128)
INT8_SCALE, INT8_OUT_SCALE = 3e-4, 31.0
INT8_BATCH = 32
# int8_matmul vs plain beyond the microbench shape, (M, K, N): a ragged M
# (batch 8 at 7x7, which the TPU's tiles refuse), K = 2048 (16 k-boxes,
# past the K up to which each CTA transposes w itself), and K and N that
# end inside the kernel's 128-wide k-boxes and n-tiles, K = 16 the least
INT8_CASES = [(392, 512, 2048), (INT8_BATCH * 7 * 7, 2048, 512),
              (1000, 48, 80), (77, 208, 16), (333, 16, 48)]
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


# bound arguments of the backward kernels: dq reads q, k, v, o, do and
# writes dq (3 products), reads lse and writes delta; dk/dv reads q, k, v,
# do and writes dk, dv (4 products), reads lse and delta. The whole
# backward reads q, k, v, o, do, lse and writes dq, dk, dv (5 distinct
# products: q k^T, do v^T, ds k, ds^T q, p^T do).
BWD_BOUND = {"flash_attention_bwd_dq": dict(products=3, tensors=6, vectors=2),
             "flash_attention_bwd_dkv": dict(products=4, tensors=6,
                                             vectors=2)}
BWD_WHOLE_BOUND = dict(products=5, tensors=8, vectors=1)
# device-busy ms of the train step at TRAIN_TOKENS with the earlier
# backward (mma.sync kernels and a plain-torch delta pass; PERF.md), on an
# NVIDIA H100 80GB HBM3 at 700 W, printed beside this run's
EARLIER_TRAIN_BUSY_MS = (25.030, 25.172)


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
        return None
    launches = sum(c for c, _ in kernels.values()) / n
    print(f"profile {what}, traced over {n}: wall {wall:.3f} ms/call, "
          f"device busy {busy:.3f} ms/call, idle share "
          f"{1 - busy / wall:.1%}, {launches:.0f} kernel launches/call "
          f"[{card_line}]")
    for name, (cnt, t) in sorted(kernels.items(),
                                 key=lambda kv: -kv[1][1])[:8]:
        t /= n
        print(f"  {t:8.4f} ms/call {cnt // n:4d} launches/call "
              f"{t / busy:6.1%}  {name[:90]}")
    return busy


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
    wgmma_report(_build)
    return card_line


def _c_int_fn(_build, source, symbol, n_args):
    fn = getattr(_build.load(source), symbol)
    fn.argtypes, fn.restype = [ctypes.c_int] * n_args, ctypes.c_int
    return fn


# Each wgmma kernel, by source: a pattern of its mangled name, the template
# arguments it names, and how many instantiations the build must report
WGMMA_KERNELS = {
    "flash_attention_fwd": (r"fwd_wgmmaI\d+(__nv_bfloat16|__half)Li(\d)ELi"
                            r"(\d+)E", 8),
    "flash_attention_bwd": (r"(dq|dkv)_wgmmaI\d+(__nv_bfloat16|__half)Li"
                            r"(\d+)E", 8),
    "conv_bn_epilogue": (r"gemm_wgmmaILi(\d+)ELi(\d)ELi(\d)E", 8),
    "convkxk_bn_stats": (r"gemm_wgmmaILi(\d+)ELi(\d)ELi(\d)E", 3),
    "int8_matmul": (r"int8_wgmmaILb(\d)ELb(\d)E", 4),
}
# gemm_wgmma's KIND, by the kernel it serves
GEMM_KINDS = {"0": "matmul_epilogue", "1": "matmul_stats",
              "2": "matmul_bn_stats", "3": "convkxk_bn_stats"}


def wgmma_report(_build) -> None:
    """The ptxas report of each wgmma kernel (registers, spills, stack)
    beside its dynamic shared memory; fails on a spill or a stack frame, or
    on a kernel missing from a build log."""
    fwd_smem = _c_int_fn(_build, "flash_attention_fwd",
                         "mxt_flash_attention_fwd_smem", 2)
    bwd_smem = _c_int_fn(_build, "flash_attention_bwd",
                         "mxt_flash_attention_bwd_smem", 2)
    epi_config = _c_int_fn(_build, "conv_bn_epilogue",
                           "mxt_matmul_epilogue_config", 3)
    stats_config = _c_int_fn(_build, "conv_bn_epilogue", "mxt_stats_config",
                             4)
    kxk_config = _c_int_fn(_build, "convkxk_bn_stats", "mxt_convkxk_config",
                           2)
    int8_config = _c_int_fn(_build, "int8_matmul", "mxt_int8_matmul_config",
                            3)

    def describe(source, args):
        if source == "flash_attention_fwd":
            dtype, nwg, hdp = args
            return (f"fwd_wgmma<{dtype.strip('_')}, {nwg}, {hdp}>",
                    fwd_smem(64 * int(nwg), int(hdp)))
        if source == "flash_attention_bwd":
            which, dtype, hdp = args
            return (f"{which}_wgmma<{dtype.strip('_')}, {hdp}>",
                    bwd_smem(0 if which == "dq" else 1, int(hdp)))
        if source == "int8_matmul":
            res, req = int(args[0]), int(args[1])
            cfg = lambda what: int8_config(res, req, what)
            return (f"int8_wgmma<{'resident w' if res else 'wt in the ring'}"
                    f", {'s8' if req else 'fp32'} out> ({cfg(1)}-stage ring, "
                    f"{cfg(2)} tile buffer{'' if cfg(2) == 1 else 's'})",
                    cfg(0))
        bn, nrb, kind = int(args[0]), int(args[1]), args[2]
        k = 4096 if nrb == 1 else 64      # the ring depth follows K
        if kind == "3":
            cfg = lambda what: kxk_config(bn, what)
        elif kind == "0":
            cfg = lambda what: epi_config(bn, k, what)
        else:
            cfg = lambda what: stats_config(bn, k, int(kind == "2"), what)
        return (f"gemm_wgmma<{bn}, {nrb}, {GEMM_KINDS[kind]}> ({cfg(1)}-stage "
                f"ring, {nrb} tile buffer{'' if nrb == 1 else 's'})", cfg(0))

    for source, (pattern, want) in WGMMA_KERNELS.items():
        log = _build.build_log(source)
        kern, seen = None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?" + pattern, line)
            if m:
                kern, spill, stack = m.groups(), 0, 0
                continue
            if kern is None:
                continue
            if "spill" in line:
                spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                       line))
                stack = int(re.search(r"(\d+) bytes stack frame", line)[1])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                name, nbytes = describe(source, kern)
                print(f"  ptxas {name}: {m[1]} registers, {nbytes} bytes of "
                      f"dynamic shared memory, {spill} bytes of spill, "
                      f"{stack} bytes of stack")
                if spill or stack:
                    fail(f"{name} spills or uses a stack")
                kern, seen = None, seen + 1
        if log and seen != want:
            fail(f"the build log of {source} reports {seen} wgmma kernels, "
                 f"want {want}")


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


def fwd_kernel_phase(ck, _build) -> float:
    """Phase 2; returns the max abs err of out at the forward path's
    shapes."""
    main_err = 0.0
    q_tile = _c_int_fn(_build, "flash_attention_fwd",
                       "mxt_flash_attention_fwd_q_tile", 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = ATTN_CASES + [FWD_TRAIN_CASE] + FWD_HEAD_DIM_CASES
    for i, (bh, s, d, dtype, causal, q_scale) in enumerate(cases):
        q, k, v = attn_inputs(bh, s, d, dtype, seed=i, q_scale=q_scale)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        again = ck._fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"case {i} {(bh, s, d, str(dtype), causal)}: out or lse "
                 f"differs between two calls")
        rows = q_tile(bh, s, d, ck._FLASH_DTYPES[dtype])
        if rows != ck.flash_fwd_q_tile(bh, s, dtype, sms):
            fail(f"case {i}: the kernel takes q-tiles of {rows} rows, "
                 f"flash_fwd_q_tile says "
                 f"{ck.flash_fwd_q_tile(bh, s, dtype, sms)}")
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
              f"causal={causal} q*{q_scale:g}, {rows}-row q-tiles: max abs "
              f"err out {errs[0]:.3e} lse {errs[1]:.3e}{p16}; bitwise "
              f"repeatable  ok")
    print(f"forward kernel: out and lse bitwise equal over two calls in all "
          f"{len(cases)} cases; the q-tile rule of flash_fwd_q_tile matches "
          f"the kernel's on {sms} SMs")
    torch.cuda.synchronize()
    return main_err


# -- 2b. ---------------------------------------------------------------------


def bwd_kernel_phase(ck) -> dict:
    """Phase 2b; returns the max abs err of (dq, dk/dv) at the train path's
    shapes, by kernel name."""
    main_err = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    delta_ratio = 0.0
    for i, (bh, s, d, dtype, causal, q_scale) in enumerate(
            BWD_CASES + BWD_HEAD_DIM_CASES):
        q, k, v, do = attn_inputs(bh, s, d, dtype, seed=100 + i,
                                  q_scale=q_scale, n=4)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        grads = ck._bwd(q, k, v, out, lse, do, causal, scale)
        again = ck._bwd(q, k, v, out, lse, do, causal, scale)
        _, delta = ck._launch_bwd_dq(q, k, v, out, do, lse, causal, scale)
        torch.cuda.synchronize()
        for name, g1, g2 in zip(("dq", "dk", "dv"), grads, again):
            if not torch.equal(g1, g2):
                fail(f"bwd case {i} {(bh, s, d, str(dtype), causal)}: {name} "
                     f"differs between two calls")
        prod = do.float() * out.float()
        dev = (delta - ck._delta(out, do)).abs()
        mag = prod.abs().sum(-1, keepdim=True)
        delta_ratio = max(delta_ratio, (dev / mag.clamp_min(1e-30)).max()
                          .item())
        if bool((dev > DELTA_RTOL * mag).any()):
            fail(f"bwd case {i} {(bh, s, d, str(dtype), causal)}: delta of "
                 f"the dq kernel off the plain delta by "
                 f"{dev.max().item():.3e} (> {DELTA_RTOL} x rowsum|do o|)")
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
              + f"{r16}; bitwise repeatable  ok")
    print(f"bwd kernels: dq, dk, dv bitwise equal over two calls in all "
          f"{len(BWD_CASES) + len(BWD_HEAD_DIM_CASES)} cases; the dq "
          f"kernel's delta within {delta_ratio:.2e} x rowsum|do o| of the "
          f"plain delta (bound {DELTA_RTOL})")
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


_PROFILER_WARM = []


def traced_launches(ck, fn, trace=True, total=None):
    """fn(), under a profiler that traces the device only if ``trace``:
    (its result, the port's kernel launches that the wrappers counted, and
    those the trace saw run on the device, each by wrapper and without
    zeros; None untraced). A replayed graph runs no Python, so only the
    trace sees its launches; a call that captures is not traced. The
    traced counts are added into ``total``."""
    from torch.profiler import ProfilerActivity, profile as trace_
    if trace and not _PROFILER_WARM:
        # the first trace of a process can miss its first kernels
        with trace_(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        _PROFILER_WARM.append(True)
    c0 = ck.launch_counts()
    if not trace:
        out, traced = fn(), None
    else:
        torch.cuda.synchronize()
        with trace_(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            out = fn()
            torch.cuda.synchronize()
        traced = {}
        for evt in prof.events():
            name = ck.kernel_of(evt.name) \
                if evt.device_type == torch.autograd.DeviceType.CUDA else None
            if name:
                traced[name] = traced.get(name, 0) + 1
        if total is not None:
            for k, n in traced.items():
                total[k] = total.get(k, 0) + n
    c1 = ck.launch_counts()
    return out, {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}, traced


def times(d: dict, n: int) -> dict:
    return {k: n * v for k, v in d.items() if v}


def check_step_launches(what, counted, traced, want: dict,
                        captured: bool) -> None:
    """The launches of each step of a run against one step's ``want``.
    Eager, every step's counted and traced launches are ``want``. Captured,
    the first call counts ``want`` twice (its eager run, which launches,
    and its capture, which records), untraced; each replay counts nothing
    and runs ``want`` on the device, as its trace shows."""
    want = times(want, 1)
    for i, (c, t) in enumerate(zip(counted, traced)):
        if captured and i == 0:
            ok = c == times(want, 2) and t is None
        else:
            ok = c == ({} if captured else want) and t == want
        if not ok:
            fail(f"{what}, step {i + 1}{' (replay)' if captured and i else ''}"
                 f": counted launches {c}, traced {t}; want {want} a step "
                 f"({'captured' if captured else 'eager'})")


def run_steps(models, ck, step, params, tokens, labels, n, captured,
              total=None):
    """n train steps from fresh moments; returns (losses, counted launches
    of each step, traced launches of each step but a capturing one, the
    params and moments after them)."""
    m, v = models.init_opt_state(params)
    losses, counted, traced = [], [], []
    for t in range(1, n + 1):
        (params, m, v, loss), c, tr = traced_launches(
            ck, lambda: step(params, m, v, tokens, labels, t),
            trace=not (captured and t == 1), total=total)
        losses.append(loss)
        counted.append(c)
        traced.append(tr)
    return losses, counted, traced, (params, m, v)


def train_path(models, ck, cfg, init, rng, config):
    """Phase 3b; returns the launch counts of the train path's main run (5
    Adam and 5 LAMB steps at TRAIN_TOKENS, captured as the knob
    MXNET_COMPILED_STEP says, on by default): those the wrappers counted,
    and those traced on the device."""
    L = cfg.num_layers
    per_layer = {k: L for k in TRAIN_KERNELS}
    captured = bool(config.get("MXNET_COMPILED_STEP"))
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    fallback0 = models.flash_fallback_count()
    ck.reset_launch_counts()
    runs, traced_total = {}, {}
    for opt in ("adam", "lamb"):
        step = models.make_train_step(cfg, optimizer=opt, lr=TRAIN_LR)
        runs[opt] = run_steps(models, ck, step, init(), tokens, labels,
                              TRAIN_STEPS, captured, traced_total)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    fallbacks = models.flash_fallback_count() - fallback0
    print(f"train path launch counts ({TRAIN_STEPS} adam + {TRAIN_STEPS} "
          f"lamb steps, tokens {TRAIN_TOKENS}, "
          f"{'captured' if captured else 'eager'}): counted by the wrappers "
          f"{counts}; traced on the device in the "
          f"{'replays' if captured else 'steps'} {traced_total}; flash "
          f"fallbacks {fallbacks}")
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks on the train path")
    if any(counts[k] == 0 for k in TRAIN_KERNELS):
        fail(f"a kernel of the train path never launched: {counts}")
    for opt, (losses, counted, traced, _) in runs.items():
        losses = [x.item() for x in losses]
        print(f"train {opt}, lr {TRAIN_LR}, tokens {TRAIN_TOKENS}: losses "
              + " ".join(f"{x:.6f}" for x in losses)
              + f"; launches per step {traced[-1]} (traced)")
        check_step_launches(opt, counted, traced, per_layer, captured)
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
        (loss,), counted, traced, _ = run_steps(models, ck, step, p, tokens,
                                                labels, 1, captured)
        torch.cuda.synchronize()
        single[what] = (loss.item(), counted, traced,
                        torch.cuda.max_memory_allocated())
        del p
    want = {"plain": per_layer,
            "grad_accum=2": {k: 2 * L for k in TRAIN_KERNELS},
            "remat": {"flash_attention_fwd": 2 * L,
                      "flash_attention_bwd_dq": L,
                      "flash_attention_bwd_dkv": L}}
    base = single["plain"][0]
    for what, (loss, counted, traced, mem) in single.items():
        print(f"one adam step, {what}: loss {loss:.6f} (|diff| to plain "
              f"{abs(loss - base):.3e}, bound {TRAIN_LOSS_ATOL}), launches "
              f"counted {counted[0]}, peak memory {mem / 2**30:.3f} GiB")
        check_step_launches(what, counted, traced, want[what], captured)
        if not abs(loss - base) <= TRAIN_LOSS_ATOL:
            fail(f"{what}: loss {loss} vs {base} of the plain step")

    # the multi-tile backward inside the model
    tokens_l, labels_l = batch(rng, cfg, *TRAIN_LONG_TOKENS)
    step = models.make_train_step(cfg, lr=TRAIN_LR)
    (loss,), counted, traced, _ = run_steps(models, ck, step, params,
                                            tokens_l, labels_l, 1, captured)
    loss = loss.item()
    print(f"one adam step, tokens {TRAIN_LONG_TOKENS}: loss {loss:.6f}, "
          f"launches counted {counted[0]}")
    check_step_launches(f"tokens {TRAIN_LONG_TOKENS}", counted, traced,
                        per_layer, captured)
    if not math.isfinite(loss):
        fail(f"tokens {TRAIN_LONG_TOKENS}: non-finite loss {loss}")
    fallbacks = models.flash_fallback_count() - fallback0
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks in the train checks")
    return counts, traced_total


# -- 4. ----------------------------------------------------------------------


def fwd_timings(ck, cfg, card_line) -> dict:
    """The forward kernel, its plain version and SDPA's forward at the two
    requests' and the train step's shapes, by (bh, s)."""
    attn_times = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtype, d, causal = torch.bfloat16, 64, False
    for bh, s in FWD_TIMED:
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
        med = attn_times[(bh, s)]
        print(f"flash fwd bh={bh} s={s} d={d} bf16, "
              f"{ck.flash_fwd_q_tile(bh, s, dtype, sms)}-row q-tiles, "
              f"{TIMING_ROUNDS} interleaved rounds of a CUDA graph of "
              f"{TIMING_ITERS} calls: " + ", ".join(
                  f"{what} {spread(t)}" for what, t in zip(
                      ("kernel", "plain", "sdpa"), times.values()))
              + f"; bound {bound:.5f} ms ({bound_by}), "
              f"{med['ms'] / bound:.2f}x it, "
              f"{med['ms'] / med['library_ms']:.2f}x sdpa [{card_line}]")
    return attn_times


def bwd_timings(ck, cfg, card_line) -> dict:
    """The dq kernel (delta included), the dk/dv kernel, the whole backward
    as ``_bwd`` runs them, their plain versions, the plain delta pass and the
    backward of scaled_dot_product_attention, at the train path's shapes."""
    out_times = {}
    for bh, s, d, dtype, causal, _ in BWD_CASES[:2]:
        q, k, v, do = attn_inputs(bh, s, d, dtype, seed=200, n=4)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        _, delta = ck._launch_bwd_dq(q, k, v, out, do, lse, causal, scale)
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
            "flash_attention_bwd_dq": lambda: ck._launch_bwd_dq(
                q, k, v, out, do, lse, causal, scale),
            "flash_attention_bwd_dkv": lambda: ck._launch_bwd_dkv(*args),
            "backward": lambda: ck._bwd(q, k, v, out, lse, do, causal,
                                        scale),
            "delta_plain": lambda: ck._delta(out, do),
            "dq_plain": lambda: ck._bwd_dq_plain(
                q, k, v, do, lse, ck._delta(out, do), causal, scale),
            "dkv_plain": lambda: ck._bwd_dkv_plain(*args),
            "backward_plain": lambda: ck.flash_attention_bwd_reference(
                q, k, v, out, lse, do, causal, scale),
            "sdpa_backward": lambda: torch.autograd.grad(
                lib_out, leaves, do4, retain_graph=True),
        })
        med = {key: statistics.median(t) for key, t in times.items()}
        lib = med["sdpa_backward"]
        for name, plain, bound_args in (
                ("flash_attention_bwd_dq", "dq_plain",
                 BWD_BOUND["flash_attention_bwd_dq"]),
                ("flash_attention_bwd_dkv", "dkv_plain",
                 BWD_BOUND["flash_attention_bwd_dkv"]),
                ("backward", "backward_plain", BWD_WHOLE_BOUND)):
            bound, bound_by = attn_bound_ms(bh, s, d, dtype, causal,
                                            **bound_args)
            out_times[(name, bh, s)] = dict(
                ms=med[name], plain_ms=med[plain], library_ms=lib,
                bound_ms=bound, bound_by=bound_by)
            print(f"{name} bh={bh} s={s} d={d} bf16, {TIMING_ROUNDS} "
                  f"interleaved rounds of a CUDA graph of {TIMING_ITERS} "
                  f"calls: kernel{'s' if name == 'backward' else ''} "
                  f"{spread(times[name])}, plain {spread(times[plain])}; "
                  f"bound {bound:.5f} ms ({bound_by}), "
                  f"{med[name] / bound:.2f}x it [{card_line}]")
        print(f"flash backward bh={bh} s={s}: dq (delta inside) + dk/dv as "
              f"_bwd {spread(times['backward'])}, sdpa backward (library) "
              f"{spread(times['sdpa_backward'])}: "
              f"{med['backward'] / lib:.2f}x sdpa; the plain delta pass it "
              f"no longer runs {spread(times['delta_plain'])} "
              f"[{card_line}]")
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


def train_timings(models, ck, cfg, params, rng, bwd_times, card_line,
                  config) -> None:
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    # the eager step, whose Python the plain-delta check below watches
    step = models.make_train_step(cfg, lr=TRAIN_LR)
    m, v = models.init_opt_state(params)
    state = [params, m, v, 1]

    def one():
        set_compiled(config, False)
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
    # the step must run no plain delta pass: count calls of the plain delta
    # while the traced steps run
    plain_delta, delta_calls = ck._delta, []
    ck._delta = lambda o, do: delta_calls.append(1) or plain_delta(o, do)
    try:
        busy = profile(one, PROFILE_STEPS, f"train step tokens {TRAIN_TOKENS}",
                       card_line)
    finally:
        ck._delta = plain_delta
        set_compiled(config, True)
    if delta_calls:
        fail(f"the train step ran the plain delta pass {len(delta_calls)} "
             f"times in {PROFILE_STEPS} steps")
    lo, hi = EARLIER_TRAIN_BUSY_MS
    print(f"train step tokens {TRAIN_TOKENS}: no plain delta pass in the "
          f"traced steps (delta inside the dq kernel); device busy "
          + (f"{busy:.3f}" if busy else "not measured")
          + f" ms/step against {lo:.3f}-{hi:.3f} with the earlier "
          f"mma.sync backward and its plain delta pass [{card_line}]")


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
    """matmul_epilogue against its plain version, and bitwise equal over two
    calls; returns the max abs err."""
    out = ck.matmul_epilogue(x, w, sc, sh, r, relu)
    if not torch.equal(out, ck.matmul_epilogue(x, w, sc, sh, r, relu)):
        fail(f"{what}: matmul_epilogue is not bitwise repeatable")
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


def epilogue_kernel_phase(ck, _build) -> dict:
    """Phase 5; returns the max abs err of each kernel at the timed
    sites."""
    tile_n = _c_int_fn(_build, "conv_bn_epilogue",
                       "mxt_matmul_epilogue_tile_n", 1)
    for n in sorted({*EPI_NS, *EPI_EDGE_NS,
                     *(n for _, _, n, _, _ in RESNET_SITE_SHAPES)}):
        if tile_n(n) != ck.epilogue_tile_n(n):
            fail(f"N {n}: the epilogue kernel takes tiles of {tile_n(n)} "
                 f"columns, epilogue_tile_n says {ck.epilogue_tile_n(n)}")
    worst = (-1.0, None)
    seed = 0
    for m in EPI_EDGE_MS:
        for k in EPI_EDGE_KS:
            for n in STATS_EDGE_NS:
                seed += 1
                x, w = epi_inputs(m, k, n, torch.bfloat16, 950 + seed)[:2]
                worst = max(worst, (check_stats(
                    ck, x, w, f"edge ({m}, {k}, {n}) bf16"), (m, k, n)),
                    key=lambda t: t[0])
    for i, (m, k, n) in enumerate(STATS_WALK_CASES):
        x, w = epi_inputs(m, k, n, torch.bfloat16, 980 + i)[:2]
        worst = max(worst, (check_stats(ck, x, w, f"walk ({m}, {k}, {n}) "
                                        f"bf16"), (m, k, n)),
                    key=lambda t: t[0])
    print(f"matmul_stats vs plain at the edges M {EPI_EDGE_MS} x K "
          f"{EPI_EDGE_KS} x N {STATS_EDGE_NS} and where every CTA walks "
          f"several m-tiles of its n-tile {STATS_WALK_CASES}, bf16: within "
          f"bounds and bitwise repeatable; largest |Δ| {worst[0]:.3e} at "
          f"{worst[1]}  ok")
    seed = 0
    for dtype in (torch.bfloat16, torch.float32):
        worst = (-1.0, None)
        for m in EPI_EDGE_MS:
            for k in EPI_EDGE_KS:
                for n in EPI_EDGE_NS:
                    seed += 1
                    x, w, sc, sh, r = epi_inputs(m, k, n, dtype, 900 + seed)
                    what = f"edge ({m}, {k}, {n}) {str(dtype)[6:]}"
                    for res in (None, r):
                        for relu in (False, True):
                            worst = max(worst, (check_epilogue(
                                ck, x, w, sc, sh, res, relu, what),
                                (m, k, n, res is not None, relu)),
                                key=lambda t: t[0])
        print(f"epilogue kernel vs plain at the narrow edges, "
              f"{str(dtype)[6:]}: M {EPI_EDGE_MS} x K {EPI_EDGE_KS} x N "
              f"{EPI_EDGE_NS}, with and without the residual and the relu: "
              f"all within bounds and bitwise repeatable; largest abs err "
              f"{worst[0]:.3e} at (M, K, N, residual, relu) {worst[1]}  ok")
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
              f"residual and the relu: all within bounds, both bitwise "
              f"repeatable; largest stats "
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
    worst_y = (-1.0, None)
    seed = 2400
    cases = [(m, k, n) for m in EPI_EDGE_MS for k in EPI_EDGE_KS
             for n in STATS_EDGE_NS] + STATS_WALK_CASES
    for m, k, n in cases:
        seed += 1
        x, w = epi_inputs(m, k, n, torch.bfloat16, seed)[:2]
        for relu in (False, True):
            worst_y = max(worst_y, (check_bn_stats(
                ck, x, w, relu, f"({m}, {k}, {n}) relu {relu} bf16"),
                (m, k, n, relu)), key=first)
    print(f"matmul_bn_stats vs plain at the edges M {EPI_EDGE_MS} x K "
          f"{EPI_EDGE_KS} x N {STATS_EDGE_NS} and where every CTA walks "
          f"several m-tiles of its n-tile {STATS_WALK_CASES}, bf16, with and "
          f"without the relu: y and statistics within bounds and bitwise "
          f"repeatable; largest y abs err {worst_y[0]:.3e} at (M, K, N, "
          f"relu) {worst_y[1]}  ok")
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


def epi_bound_ms(m, k, n, with_out, with_res=True):
    """Least time: x and w read once, and (with_out) the output written
    once (bf16) and, with_res, the residual read once, else 2N fp32
    statistics written; 2MKN bf16 tensor-core operations of the product."""
    nbytes = 2 * (m * k + k * n) + (
        (2 + 2 * with_res) * m * n + 8 * n if with_out else 8 * n)
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


def epilogue_site_timings(ck, card_line) -> dict:
    """matmul_epilogue and torch.matmul of the same product at every
    distinct site shape of the bf16 batch-128 step, with the site's residual
    and relu, beside the bound (the residual counted where the site has
    one); then the sums over the 36 launches of a step."""
    sites = []
    for i, ((side, k, n, res, relu), launches) in enumerate(
            zip(RESNET_SITE_SHAPES, RESNET_SITE_LAUNCHES)):
        m = RESNET_BATCH * side * side
        x, w, sc, sh, r = epi_inputs(m, k, n, torch.bfloat16, seed=800 + i)
        r = r if res else None
        times = time_ms({
            "ms": lambda: ck.matmul_epilogue(x, w, sc, sh, r, relu),
            "library_ms": lambda: torch.matmul(x, w)})
        bound, bound_by = epi_bound_ms(m, k, n, True, res)
        site = dict(shape=[m, k, n, "bf16"], residual=res, relu=relu,
                    launches=launches, bound_ms=bound, bound_by=bound_by,
                    tile_n=ck.epilogue_tile_n(n), **{
                        key: statistics.median(t)
                        for key, t in times.items()})
        sites.append(site)
        print(f"matmul_epilogue site ({m}, {k}, {n}) residual={res} "
              f"relu={relu}, x{launches} per step, "
              f"{site['tile_n']}-column tiles: kernel {spread(times['ms'])}, "
              f"torch.matmul {spread(times['library_ms'])}; bound "
              f"{bound:.5f} ms ({bound_by}), {site['ms'] / bound:.2f}x it "
              f"[{card_line}]")
        del x, w, sc, sh, r
    if sum(RESNET_SITE_LAUNCHES) != RESNET_SITES:
        fail(f"RESNET_SITE_LAUNCHES sums to {sum(RESNET_SITE_LAUNCHES)}, "
             f"want {RESNET_SITES}")
    step = {key: sum(t["launches"] * t[key] for t in sites)
            for key in ("ms", "bound_ms", "library_ms")}
    step["over_bound_ms"] = step["ms"] - step["bound_ms"]
    print(f"matmul_epilogue over the {sum(RESNET_SITE_LAUNCHES)} launches of "
          f"a step: {step['ms']:.4f} ms against a bound of "
          f"{step['bound_ms']:.4f} ms; sum of launches x (time - bound) "
          f"{step['over_bound_ms']:.4f} ms; torch.matmul of the bare "
          f"products {step['library_ms']:.4f} ms [{card_line}]")
    return dict(sites=sites, step=step)


STATS_KERNELS = ("matmul_stats", "matmul_bn_stats")


def stats_bound_ms(name, m, k, n):
    """B5's bound (x and w read, 2N floats written) or B4's (y written
    too); 2 M K N tensor-core operations."""
    if name == "matmul_stats":
        return epi_bound_ms(m, k, n, False)
    return conv_bn_bound_ms(2 * (m * k + k * n + m * n) + 8 * n,
                            2 * m * k * n)


def stats_site_timings(ck, _build, card_line) -> dict:
    """matmul_stats (B5, the epilogue route) and matmul_bn_stats (B4,
    the conv + BN route) at every distinct 1x1 site shape of the bf16
    batch-128 step, with torch.matmul of the bare product, each beside its
    bound; then, for each kernel, the sums over the 36 launches of a step:
    launches x ms, the bound's, and launches x (ms - bound)."""
    launches = dict.fromkeys(C1X1_SITE_SHAPES, 0)
    for (side, k, n, _res, _relu), count in zip(RESNET_SITE_SHAPES,
                                               RESNET_SITE_LAUNCHES):
        launches[(side, k, n)] += count
    sites = {name: [] for name in STATS_KERNELS}
    tile_n = _c_int_fn(_build, "conv_bn_epilogue", "mxt_stats_tile_n", 1)
    for i, ((side, k, n), count) in enumerate(launches.items()):
        m = RESNET_BATCH * side * side
        x, w = epi_inputs(m, k, n, torch.bfloat16, seed=820 + i)[:2]
        times = time_ms({
            "matmul_stats": lambda: ck.matmul_stats(x, w),
            "matmul_bn_stats": lambda: ck.matmul_bn_stats(x, w),
            "torch.matmul": lambda: torch.matmul(x, w)})
        med = {key: statistics.median(t) for key, t in times.items()}
        line = []
        for name in STATS_KERNELS:
            bound, bound_by = stats_bound_ms(name, m, k, n)
            sites[name].append(dict(
                shape=[m, k, n, "bf16"], launches=count, ms=med[name],
                bound_ms=bound, bound_by=bound_by,
                library_ms=med["torch.matmul"]))
            line.append(f"{name} {spread(times[name])}, bound {bound:.5f} "
                        f"ms ({bound_by}), {med[name] / bound:.2f}x it")
        print(f"site ({m}, {k}, {n}), x{count} per step, "
              f"{tile_n(n)}-column tiles: " + "; ".join(line)
              + f"; torch.matmul {spread(times['torch.matmul'])} "
              f"[{card_line}]")
        del x, w
    if sum(launches.values()) != RESNET_SITES:
        fail(f"the 1x1 site launches sum to {sum(launches.values())}, want "
             f"{RESNET_SITES}")
    out = {}
    for name in STATS_KERNELS:
        step = {key: sum(t["launches"] * t[key] for t in sites[name])
                for key in ("ms", "bound_ms", "library_ms")}
        step["over_bound_ms"] = step["ms"] - step["bound_ms"]
        out[name] = dict(sites=sites[name], step=step)
        print(f"{name} over the {RESNET_SITES} launches of a step: "
              f"{step['ms']:.4f} ms against a bound of "
              f"{step['bound_ms']:.4f} ms; sum of launches x (time - bound) "
              f"{step['over_bound_ms']:.4f} ms; torch.matmul of the bare "
              f"products {step['library_ms']:.4f} ms [{card_line}]")
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
    """B4 at the stage-1 and stage-4 conv3 sites and B8 at all four 3x3
    sites (bf16, batch 128), their plain versions and the library call of
    the bare conv (``torch.matmul`` / cuDNN ``F.conv2d`` on channels_last
    views), which computes no statistics, each as CUDA-graph replays beside
    its bound: x and w read once, z (or y) written once, 2 fp32 sums per
    channel; 2 M K N tensor-core operations. Then B8's sums over the 16
    launches of a step: launches x ms, the bound's, cuDNN's, and launches
    x (ms - bound)."""
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
    sites = []
    for i, ((side, c), launches) in enumerate(zip(KXK_SITE_SHAPES,
                                                   KXK_SITE_LAUNCHES)):
        xshape = (RESNET_BATCH, side, side, c)
        x, w = kxk_inputs(xshape, c, (3, 3), torch.bfloat16, seed=730 + i)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        times = time_ms({
            "convkxk_bn_stats": lambda: ck.convkxk_bn_stats(x, w, (1, 1)),
            "plain": lambda: ck.convkxk_bn_stats_reference(x, w, (1, 1)),
            "F.conv2d": lambda: F.conv2d(xc, wc, padding=1),
        })
        m, kk = RESNET_BATCH * side * side, 9 * c
        bound, bound_by = conv_bn_bound_ms(
            2 * (2 * x.numel() + w.numel()) + 8 * c, 2 * m * kk * c)
        site = dict(
            shape=[*xshape, c, "bf16"], launches=launches,
            ms=statistics.median(times["convkxk_bn_stats"]),
            plain_ms=statistics.median(times["plain"]),
            library_ms=statistics.median(times["F.conv2d"]),
            bound_ms=bound, bound_by=bound_by)
        sites.append(site)
        print(f"convkxk_bn_stats {xshape} -> {c}, 3x3 pad 1, bf16, x{launches}"
              f" per step, {TIMING_ROUNDS} interleaved rounds of a CUDA graph "
              f"of {TIMING_ITERS} calls: kernel "
              f"{spread(times['convkxk_bn_stats'])}, plain "
              f"{spread(times['plain'])}, cuDNN F.conv2d on channels_last "
              f"(no statistics) {spread(times['F.conv2d'])}; bound "
              f"{bound:.5f} ms ({bound_by}), {site['ms'] / bound:.2f}x it, "
              f"{site['ms'] / site['library_ms']:.2f}x cuDNN [{card_line}]")
        del x, w, xc, wc
    step = {key: sum(s["launches"] * s[key] for s in sites)
            for key in ("ms", "bound_ms", "library_ms")}
    step["over_bound_ms"] = step["ms"] - step["bound_ms"]
    print(f"convkxk_bn_stats over the {sum(KXK_SITE_LAUNCHES)} launches of a "
          f"step: {step['ms']:.4f} ms against a bound of "
          f"{step['bound_ms']:.4f} ms; sum of launches x (time - bound) "
          f"{step['over_bound_ms']:.4f} ms; cuDNN F.conv2d of the bare convs "
          f"{step['library_ms']:.4f} ms [{card_line}]")
    out["convkxk_bn_stats"] = dict(sites=sites, step=step)
    return out


# -- 8. ----------------------------------------------------------------------


def port_capture():
    """The port's program store and compiled step."""
    from mxnet_tpu_torch import cached_step, program_store
    return program_store, cached_step


def no_grad(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def hold_captured(what, eager_a, eager_b, captured) -> str:
    """Captured results against eager ones (lists of tensors in the same
    order): where two eager runs from the same state are bitwise equal,
    the captured run must be too; otherwise it must lie within
    FUSED_SPREAD x their spread (max |Δ| over all values) plus FUSED_SLACK
    of the largest value, the rule of fused against unfused. Prints and
    returns the rule used."""
    a, b, c = (torch.cat([t.detach().double().ravel() for t in ts])
               for ts in (eager_a, eager_b, captured))
    if torch.equal(a, b):
        rule = "bitwise (two eager runs bitwise equal)"
        if not torch.equal(c, a):
            fail(f"{what}: captured differs from eager in "
                 f"{(c != a).sum().item()} of {a.numel()} values (max |Δ| "
                 f"{(c - a).abs().max().item():.3e}), where two eager runs "
                 f"are bitwise equal")
    else:
        spread_ = (b - a).abs().max().item()
        err = (c - a).abs().max().item()
        lim = FUSED_SPREAD * spread_ + FUSED_SLACK * a.abs().max().item()
        rule = (f"within {FUSED_SPREAD} x the eager spread (two eager runs "
                f"differ): max |Δ| {err:.3e} <= {lim:.3e}, spread "
                f"{spread_:.3e}")
        if not err <= lim:
            fail(f"{what}: captured vs eager max |Δ| {err:.3e} > {lim:.3e} "
                 f"({FUSED_SPREAD} x the eager spread {spread_:.3e})")
    print(f"{what}: captured vs eager over {a.numel()} values, {rule}  ok")
    return rule


def event_ms(fn, n=CAPTURE_TIMED) -> float:
    """Median device span of one call of fn, CUDA events around it."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_host_ms(fn, n=CAPTURE_TIMED) -> float:
    """Median host ms for a call of fn to return when the device is idle
    before it (a synchronise between calls, none after): the host's own
    work a call, with no queue to wait on. For a captured call that is its
    key, its copies and the graph launch; for an eager call, every launch
    of the step."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def mode_numbers(what, mode, fn, kept, card_line) -> dict:
    """One path's numbers: wall ms (median of CAPTURE_TIMED host-clock
    calls after 3 warm-up, unprofiled), device ms (profile's busy time, or
    where the trace holds none the CUDA-event span of a call), the host's
    ms a call (``call_host_ms``), idle share, and peak memory: the most
    allocated during the timed calls above what was live before them, plus
    ``kept``, the memory a captured path's program holds (reserved at its
    capture)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = host_ms(fn, n=CAPTURE_TIMED)
    peak = torch.cuda.max_memory_allocated() - base + kept
    span = event_ms(fn)
    host = call_host_ms(fn)
    busy = profile(fn, PROFILE_STEPS, f"{what}, {mode}", card_line)
    wall = statistics.median(times)
    device = busy if busy else span
    print(f"{what}, {mode}: wall median {wall:.3f} ms over "
          f"{CAPTURE_TIMED} (min {min(times):.3f}, max "
          f"{max(times):.3f}); device busy "
          + (f"{busy:.3f} ms" if busy else
             "not in the trace (the event span stands in)")
          + f"; event span {span:.3f} ms; host {host:.3f} ms a call from an "
          f"idle device; idle share {1 - device / wall:.1%}; peak memory "
          f"{peak / 2**30:.3f} GiB [{card_line}]")
    return dict(wall_ms=wall, wall_min_ms=min(times), wall_max_ms=max(times),
                busy_ms=busy, span_ms=span, host_ms=host,
                idle_share=1 - device / wall, peak_gib=peak / 2**30)


def capture_numbers(what, fns, kept, card_line) -> dict:
    """Eager against captured (``mode_numbers`` of each; ``kept`` counts
    for the captured path)."""
    out = {mode: mode_numbers(what, mode, fn,
                              kept if mode == "captured" else 0, card_line)
           for mode, fn in fns.items()}
    e, c = out["eager"]["wall_ms"], out["captured"]["wall_ms"]
    print(f"{what}: captured wall {c:.3f} ms against eager {e:.3f} ms, "
          f"{e / c:.2f}x [{card_line}]")
    return out


def reserved_by(fn):
    """(fn's result, the memory reserved by the allocator over its call,
    after emptying the cache first)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_reserved() - r0


def capture_forward_phase(models, ps, ck, cfg, params, requests,
                          card_line, traced_total) -> dict:
    """Phase 8a: the LM forward at each request shape captured through
    ``program_store.capture``, held against the eager forward; 1 capture
    per shape, 1 dispatch a call, the forward kernel's launches per call
    as eager's (the eager forward's counted and traced, the first captured
    call's counted, a replay's traced); then eager against captured
    numbers."""
    ns = ps.namespace("hybrid_forward")
    fwd = ps.capture(lambda toks: models.forward(params, toks, cfg)[0])
    want = {"flash_attention_fwd": cfg.num_layers}
    numbers = {}
    for tokens, _labels in requests:
        B, S = tokens.shape
        what = f"LM forward tokens ({B}, {S})"
        t0, d0 = ns.traces, ns.dispatches
        with torch.no_grad():
            eager = [traced_launches(
                ck, lambda: models.forward(params, tokens, cfg)[0])
                for _ in range(2)]
            (first, kept), c_first, _ = traced_launches(
                ck, lambda: reserved_by(lambda: fwd(tokens)), trace=False)
            replay, c_replay, t_replay = traced_launches(
                ck, lambda: fwd(tokens), total=traced_total)
        eager_launches = [(c, t) for _, c, t in eager]
        eager = [e for e, _, _ in eager]
        hold_captured(what, [eager[0]] * 2, [eager[1]] * 2, [first, replay])
        if (ns.traces - t0, ns.dispatches - d0) != (1, 2):
            fail(f"{what}: {ns.traces - t0} captures and "
                 f"{ns.dispatches - d0} dispatches over 2 calls")
        got = (eager_launches, c_first, c_replay, t_replay)
        if got != ([(want, want)] * 2, times(want, 2), {}, want):
            fail(f"{what}: launches (eager counted and traced, first "
                 f"captured call counted, replay counted, replay traced) "
                 f"{got}; want {want} a forward")
        del eager, first, replay
        calls = []
        captured = no_grad(lambda: calls.append(1) or fwd(tokens))
        t1, d1 = ns.traces, ns.dispatches
        numbers[(B, S)] = capture_numbers(what, {
            "eager": no_grad(lambda: models.forward(params, tokens, cfg)),
            "captured": captured}, kept, card_line)
        if (ns.traces - t1, ns.dispatches - d1) != (0, len(calls)):
            fail(f"{what}: {ns.traces - t1} captures and "
                 f"{ns.dispatches - d1} dispatches over {len(calls)} timed "
                 f"calls")
        print(f"{what}: 1 capture, 1 dispatch a call, 0 captures over "
              f"{len(calls)} timed calls; forward-kernel launches: "
              f"{cfg.num_layers} an eager forward (counted and traced), "
              f"{2 * cfg.num_layers} counted at the first captured call "
              f"(its eager run and its capture), {cfg.num_layers} traced in "
              f"a replay, which counts none  ok")
    n = numbers[tuple(REQUESTS[0])]
    if not n["captured"]["wall_ms"] < n["eager"]["wall_ms"]:
        fail(f"LM forward {REQUESTS[0]}: captured wall "
             f"{n['captured']['wall_ms']:.3f} ms not below eager "
             f"{n['eager']['wall_ms']:.3f} ms")
    return numbers


def capture_train_phase(models, ps, cs, ck, cfg, init, rng, card_line,
                        config, traced_total) -> dict:
    """Phase 8b: TRAIN_STEPS Adam and then TRAIN_STEPS LAMB steps of the
    LM at TRAIN_TOKENS, each from the same initial state in two eager runs
    (MXNET_COMPILED_STEP=0) and one captured run: losses, params and
    moments held captured against eager; one capture per run however t
    advances, one dispatch a step; the kernels' launches per step as
    eager's (check_step_launches). Then eager against captured numbers of
    the Adam step."""
    L = cfg.num_layers
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    for opt in ("adam", "lamb"):
        runs = []
        for capture in (False, False, True):
            set_compiled(config, capture)
            step = models.make_train_step(cfg, optimizer=opt, lr=TRAIN_LR)
            t0, d0 = cs.trace_count(), cs.dispatch_count()
            losses, counted, traced, state = run_steps(
                models, ck, step, init(), tokens, labels, TRAIN_STEPS,
                capture, traced_total if capture else None)
            got = (cs.trace_count() - t0, cs.dispatch_count() - d0)
            if got != ((1, TRAIN_STEPS) if capture else (0, 0)):
                fail(f"LM train {opt}, capture={capture}: (captures, "
                     f"dispatches) {got} over {TRAIN_STEPS} steps")
            check_step_launches(f"LM train {opt}, capture={capture}",
                                counted, traced,
                                {k: L for k in TRAIN_KERNELS}, capture)
            runs.append((losses, [x for d in state for x in d.values()]))
            del state, step
        (la, sa), (lb, sb), (lc, sc) = runs
        print(f"LM train {opt}, tokens {TRAIN_TOKENS}, lr {TRAIN_LR}: losses "
              f"eager " + " ".join(f"{x.item():.6f}" for x in la)
              + "; captured " + " ".join(f"{x.item():.6f}" for x in lc)
              + f"; 1 capture, 1 dispatch a step, launches per step "
              f"{ {k: L for k in TRAIN_KERNELS} }")
        hold_captured(f"LM train {opt} losses", la, lb, lc)
        hold_captured(f"LM train {opt} params and moments after "
                      f"{TRAIN_STEPS} steps", sa, sb, sc)
        if not lc[-1].item() < lc[0].item():
            fail(f"LM train {opt}, captured: the loss did not fall")
        del runs, sa, sb, sc
    torch.cuda.empty_cache()
    fns, kept = {}, 0
    for mode in ("eager", "captured"):
        step = models.make_train_step(cfg, lr=TRAIN_LR)
        p = init()
        m, v = models.init_opt_state(p)
        state = [p, m, v, 1]

        def one(step=step, state=state, on=mode == "captured"):
            set_compiled(config, on)
            p, m, v, t = state
            step(p, m, v, tokens, labels, t)
            state[3] = t + 1

        if mode == "captured":
            _, kept = reserved_by(one)
        fns[mode] = one
    t0 = cs.trace_count()
    numbers = capture_numbers(f"LM train step adam, tokens {TRAIN_TOKENS}",
                              fns, kept, card_line)
    set_compiled(config, True)
    if cs.trace_count() != t0:
        fail("LM train step: a capture after warm-up")
    if not numbers["captured"]["wall_ms"] < numbers["eager"]["wall_ms"]:
        fail(f"LM train step: captured wall "
             f"{numbers['captured']['wall_ms']:.3f} ms not below eager "
             f"{numbers['eager']['wall_ms']:.3f} ms")
    return numbers


def capture_route(config, name):
    """Set the knobs of a ResNet route (unfused, the epilogue's, conv +
    BN's); returns its Route, None for unfused."""
    route = {"unfused": None, "epilogue": EPILOGUE, "conv_bn": CONV_BN}[name]
    for r in (EPILOGUE, CONV_BN):
        set_fused(config, int(r is route), r)
    return route


def set_compiled(config, on: bool) -> None:
    os.environ["MXNET_COMPILED_STEP"] = "1" if on else "0"
    config.refresh("MXNET_COMPILED_STEP")


def resnet_site_counts(resnet):
    return {**{f"epilogue.{k}": v
               for k, v in resnet.fused_epilogue_counts().items()},
            **{f"conv_bn.{k}": v
               for k, v in resnet.fused_conv_bn_counts().items()}}


def route_gates(route):
    """(launches, site counts) of one step on ``route``."""
    sites = {f"epilogue.{k}": v for k, v in (
        EPILOGUE.fused_sites if route is EPILOGUE
        else EPILOGUE.unfused_sites).items()}
    sites.update({f"conv_bn.{k}": v for k, v in (
        CONV_BN.fused_sites if route is CONV_BN
        else CONV_BN.unfused_sites).items()})
    return (route.launches if route else {}), sites


def capture_resnet_phase(mx, ps, cs, ck, resnet, config, card_line,
                         traced_total) -> dict:
    """Phase 8c: the bf16 ResNet-50 step at batch 128 through
    ``trainer.compile_step`` on each route, RESNET_STEPS steps from the
    same weights in two eager runs (the same TrainStep with
    MXNET_COMPILED_STEP=0: the eager tape) and one captured run, the
    learning rate set to CAPTURE_LR2 after step CAPTURE_LR_STEP: losses,
    params, running statistics and momenta held captured against eager;
    1 capture and 1 dispatch a step, no fallback; launches per step as
    the route's gates (check_step_launches), and sites: each eager step's
    and the capture's as the route's gates (the first captured call counts
    them twice, for its eager run and its capture), none in a replay,
    which runs no Python; the loss falls. Then eager against captured
    numbers. Then the hybridized predict-mode forward."""
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(n, a, b):
        return ce(n(a), b)

    numbers = {}
    for name in CAPTURE_ROUTES:
        route = capture_route(config, name)
        want_launches, want_sites = route_gates(route)
        what = f"ResNet-50 bf16 b{RESNET_BATCH} compile_step, {name}"
        runs, steps = [], {}
        for compiled in (False, False, True):
            set_compiled(config, compiled)
            net.load_dict(init)
            net.zero_grad()
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(RESNET_OPT))
            step = trainer.compile_step(net, loss_fn)
            t0, d0 = cs.trace_count(), cs.dispatch_count()
            losses, counted, traced = [], [], []
            for i in range(RESNET_STEPS):
                if i == CAPTURE_LR_STEP:
                    trainer.set_learning_rate(CAPTURE_LR2)
                s0 = resnet_site_counts(resnet)
                if compiled and i == 0:
                    (loss, kept), c, t = traced_launches(
                        ck, lambda: reserved_by(lambda: step(x, y)),
                        trace=False)
                else:
                    loss, c, t = traced_launches(
                        ck, lambda: step(x, y),
                        total=traced_total if compiled else None)
                counted.append(c)
                traced.append(t)
                s1 = resnet_site_counts(resnet)
                sites = {k: s1[k] - s0[k] for k in s1}
                n = 2 if compiled and i == 0 else 0 if compiled else 1
                if sites != {k: n * v for k, v in want_sites.items()}:
                    fail(f"{what}, compiled={compiled}, step {i + 1}: "
                         f"sites {sites}; want {n} x {want_sites}")
                reason = step.last_fallback_reason
                if reason != (None if compiled else "MXNET_COMPILED_STEP=0"):
                    fail(f"{what}, compiled={compiled}, step {i + 1}: "
                         f"last_fallback_reason {reason!r}")
                if compiled and (cs.trace_count() - t0,
                                 cs.dispatch_count() - d0) != (1, i + 1):
                    fail(f"{what}, step {i + 1}: "
                         f"{cs.trace_count() - t0} captures, "
                         f"{cs.dispatch_count() - d0} dispatches")
                losses.append(loss.float().mean().reshape(1))
            check_step_launches(f"{what}, compiled={compiled}", counted,
                                traced, want_launches, compiled)
            lr = trainer._optimizer.scalars(x.device)["lr"].item()
            if lr != np.float32(CAPTURE_LR2):
                fail(f"{what}: the optimizer's lr scalar is {lr}")
            state = [p.data().clone() for p in net.collect_params().values()]
            state += [s.clone() for s in trainer._init_states()]
            runs.append((losses, state))
            steps[compiled] = (trainer, step)
        (la, sa), (lb, sb), (lc, sc) = runs
        gated_sites = {k: v for k, v in want_sites.items() if v}
        print(f"{what}: losses eager " + " ".join(
            f"{v.item():.6f}" for v in la) + "; captured " + " ".join(
            f"{v.item():.6f}" for v in lc) + f"; lr {RESNET_LR} -> "
            f"{CAPTURE_LR2} after step {CAPTURE_LR_STEP} with 0 new "
            f"captures; launches per step {want_launches} (eager: counted "
            f"and traced; captured: counted twice at the capture, traced in "
            f"each replay), sites {gated_sites} "
            f"a step (none counted in a replay)")
        hold_captured(f"{what} losses", la, lb, lc)
        hold_captured(f"{what} params, running statistics and momenta "
                      f"after {RESNET_STEPS} steps", sa, sb, sc)
        if not all(math.isfinite(v.item()) for v in lc) or \
                not lc[-1].item() < lc[0].item():
            fail(f"{what}: captured losses {[v.item() for v in lc]} did not "
                 f"fall")
        del runs, sa, sb, sc
        calls = []

        def eager(step=steps[False][1]):
            set_compiled(config, False)
            step(x, y)

        def captured(step=steps[True][1]):
            set_compiled(config, True)
            step(x, y)
            calls.append(1)
            if step.last_fallback_reason is not None:
                fail(f"{what}: a timed step ran eagerly "
                     f"({step.last_fallback_reason})")

        t1 = cs.trace_count()
        numbers[name] = capture_numbers(what, {"eager": eager,
                                               "captured": captured},
                                        kept, card_line)
        if cs.trace_count() != t1:
            fail(f"{what}: a capture after warm-up")
        print(f"{what}: 0 captures and no fallback over {len(calls)} timed "
              f"steps  ok")
        del steps, eager, captured
        torch.cuda.empty_cache()
    set_compiled(config, True)
    capture_route(config, "unfused")

    # the hybridized forward in predict mode
    ns = ps.namespace("hybrid_forward")
    x2 = x.roll(1, 0)
    net.load_dict(init)
    net.hybridize(False)
    with torch.no_grad():
        eager = [net(x) for _ in range(2)]
        eager2 = net(x2)
    net.hybridize()
    t0, d0 = ns.traces, ns.dispatches
    first = net(x)
    replay = net(x)
    kept_copy = replay.clone()
    other = net(x2)
    what = f"ResNet-50 bf16 b{RESNET_BATCH} hybridized predict forward"
    hold_captured(what, [eager[0]] * 2 + [eager2],
                  [eager[1]] * 2 + [eager2], [first, replay, other])
    if not torch.equal(replay, kept_copy):
        fail(f"{what}: call 2's output changed when call 3 ran")
    if (ns.traces - t0, ns.dispatches - d0) != (1, 3):
        fail(f"{what}: {ns.traces - t0} captures, {ns.dispatches - d0} "
             f"dispatches over 3 calls")
    print(f"{what}: 1 capture, 1 dispatch a call, each call's output its "
          f"own  ok")
    return numbers


# -- 8d-8g. the rest of the compiled step ------------------------------------


def port_parallel():
    """The port's parallel package."""
    from mxnet_tpu_torch import parallel
    return parallel


def run_traced_steps(ck, resnet, what, call, n, compiled, want_sites,
                     traced_total, counters=None):
    """n calls of ``call`` (one train step each), each's launches counted
    and, but for a capturing first call, traced; the sites of each step
    held to ``want_sites`` (the first compiled call counts them twice, for
    its eager run and its capture; a replay none); ``counters()`` gives
    (captures, dispatches), which must be (1, i + 1) after compiled step i.
    Returns (losses, counted, traced, the memory the capture reserved)."""
    losses, counted, traced, kept = [], [], [], 0
    base = counters() if counters else None
    for i in range(n):
        s0 = resnet_site_counts(resnet)
        if compiled and i == 0:
            (loss, kept), c, t = traced_launches(
                ck, lambda: reserved_by(call), trace=False)
        else:
            loss, c, t = traced_launches(
                ck, call, total=traced_total if compiled else None)
        counted.append(c)
        traced.append(t)
        s1 = resnet_site_counts(resnet)
        sites = {k: s1[k] - s0[k] for k in s1}
        k = 2 if compiled and i == 0 else 0 if compiled else 1
        if sites != {key: k * v for key, v in want_sites.items()}:
            fail(f"{what}, compiled={compiled}, step {i + 1}: sites "
                 f"{sites}; want {k} x {want_sites}")
        if compiled and counters:
            got = tuple(a - b for a, b in zip(counters(), base))
            if got != (1, i + 1):
                fail(f"{what}, step {i + 1}: (captures, dispatches) {got}")
        losses.append(loss.detach().float().mean().reshape(1))
    return losses, counted, traced, kept


def check_run(what, runs, min_fall=True):
    """Hold the captured run (the last of ``runs``, each (losses, state))
    against the two eager ones; its losses finite and falling."""
    (la, sa), (lb, sb), (lc, sc) = runs
    hold_captured(f"{what} losses", la, lb, lc)
    hold_captured(f"{what} state after {len(lc)} steps", sa, sb, sc)
    vals = [v.item() for v in lc]
    if not all(math.isfinite(v) for v in vals) or \
            (min_fall and not vals[-1] < vals[0]):
        fail(f"{what}: captured losses {vals} did not fall")
    print(f"{what}: losses eager " + " ".join(
        f"{v.item():.6f}" for v in la) + "; captured " + " ".join(
        f"{v:.6f}" for v in vals))


def with_img_s(numbers, batch):
    for mode in numbers.values():
        if isinstance(mode, dict) and "wall_ms" in mode:
            mode["img_s"] = batch / (mode["wall_ms"] / 1e3)
    return numbers


def sharded_lane_phase(mx, ps, ck, resnet, config, card_line,
                       traced_total) -> dict:
    """Phase 8d: ``bench.py``'s ResNet lane through ``parallel.
    ShardedTrainer`` (``make_mesh({"dp": 1})``, SGD momentum 0.9, wd
    1e-4 at RESNET_LR, ``compute_dtype=torch.bfloat16``, fp32 masters,
    int32 labels) on each route: RESNET_STEPS steps from the same weights
    in two eager runs (MXNET_COMPILED_STEP=0: the same body, no program)
    and one captured run. Losses, masters and momenta captured against
    eager; masters and momenta still fp32; 1 capture and 1 dispatch a
    step; launches and sites per step as ``compile_step``'s on the route;
    the loss falls. Then eager against captured numbers and img/s, and
    ``grad_accum=2`` (2 x 64) for two steps."""
    par = port_parallel()
    ns = ps.namespace("sharded_step")
    x, y = image_batch(RESNET_BATCH, torch.float32)
    y = y.to(torch.int32)
    net = resnet50(mx, x[:2])
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mesh = par.make_mesh({"dp": 1}, devices=[x.device])

    def trainer(accum=1):
        net.load_dict(init)
        return par.ShardedTrainer(
            net, lambda o, lab: ce(o, lab).mean(), mesh, optimizer="sgd",
            optimizer_params={"lr": RESNET_LR, "momentum": 0.9, "wd": 1e-4},
            compute_dtype=torch.bfloat16, grad_accum=accum)

    def counters():
        return ns.traces, ns.dispatches

    def state_of(tr):
        ts = list(tr.params.values()) + \
            [s for st in tr.opt_state.values() for s in st]
        bad = [t.dtype for t in ts if t.dtype != torch.float32]
        if bad:
            fail(f"ShardedTrainer: masters or momenta not fp32: {bad[:3]}")
        return [t.clone() for t in ts]

    numbers = {}
    for name in CAPTURE_ROUTES:
        route = capture_route(config, name)
        want_launches, want_sites = route_gates(route)
        what = (f"ResNet-50 ShardedTrainer bf16 compute, fp32 masters, "
                f"b{RESNET_BATCH}, {name}")
        runs, trainers, kept = [], {}, 0
        for compiled in (False, False, True):
            set_compiled(config, compiled)
            tr = trainer()
            losses, counted, traced, k = run_traced_steps(
                ck, resnet, what, lambda: tr.step(x, y, sync=False),
                RESNET_STEPS, compiled, want_sites, traced_total,
                counters if compiled else None)
            kept = k or kept
            check_step_launches(f"{what}, compiled={compiled}", counted,
                                traced, want_launches, compiled)
            runs.append((losses, state_of(tr)))
            trainers[compiled] = tr
        check_run(what, runs)
        del runs
        calls = []

        def eager(tr=trainers[False]):
            set_compiled(config, False)
            tr.step(x, y, sync=False)

        def captured(tr=trainers[True]):
            set_compiled(config, True)
            tr.step(x, y, sync=False)
            calls.append(1)

        t1 = ns.traces
        numbers[name] = with_img_s(capture_numbers(
            what, {"eager": eager, "captured": captured}, kept, card_line),
            RESNET_BATCH)
        if ns.traces != t1 or not calls:
            fail(f"{what}: a capture after warm-up")
        print(f"{what}: launches per step {want_launches}, sites "
              f"{ {k: v for k, v in want_sites.items() if v} }, 1 capture, "
              f"1 dispatch a step, 0 captures over {len(calls)} timed "
              f"steps; captured {numbers[name]['captured']['img_s']:.1f} "
              f"img/s [{card_line}]  ok")
        del trainers, eager, captured
        torch.cuda.empty_cache()
    # grad_accum=2: two micro-batches of 64 a step, the statistics chained
    route = capture_route(config, "conv_bn")
    want_launches, want_sites = route_gates(route)
    what = f"ResNet-50 ShardedTrainer grad_accum=2 (2 x {RESNET_BATCH // 2})"
    set_compiled(config, True)
    tr = trainer(accum=2)
    losses, counted, traced, _ = run_traced_steps(
        ck, resnet, what, lambda: tr.step(x, y, sync=False), 2, True,
        {k: 2 * v for k, v in want_sites.items()}, traced_total, counters)
    check_step_launches(what, counted, traced, times(want_launches, 2), True)
    state_of(tr)
    if not all(math.isfinite(v.item()) for v in losses):
        fail(f"{what}: losses {[v.item() for v in losses]}")
    print(f"{what}: losses " + " ".join(f"{v.item():.6f}" for v in losses)
          + f"; launches per step {times(want_launches, 2)}, 1 capture, 1 "
          f"dispatch a step  ok")
    del tr
    capture_route(config, "unfused")
    torch.cuda.empty_cache()
    return numbers


def bf16_resnet(mx, hybridize=True):
    """(net, its initial values, the batch): ResNet-50 in pure bf16 at
    RESNET_BATCH, as phase 8c."""
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize(hybridize)
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    return net, init, x, y


def accum_phase(mx, cs, ck, resnet, config, traced_total) -> None:
    """Phase 8e: ``compile_step(accum_steps=2)`` on the conv + BN route,
    bf16, ACCUM_WINDOWS windows of 2 x 64 images. Held against two eager
    windows of the same recipe (MXNET_COMPILED_STEP=0; every parameter
    with ``grad_req='add'``: two recorded forwards and backwards, then
    ``trainer.step(128)``): a batch-norm net's window is two micro-batches
    with their own batch statistics, which a batch-128 step is not. 3
    dispatches a window (2 grad programs and 1 update program) and no
    capture after the first window; each grad replay launches the route's
    kernels (traced)."""
    route = capture_route(config, "conv_bn")
    want_launches, _ = route_gates(route)
    net, init, x, y = bf16_resnet(mx)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    half = RESNET_BATCH // 2
    micro = [(x[:half], y[:half]), (x[half:], y[half:])]
    what = f"ResNet-50 bf16 compile_step(accum_steps=2), 2 x {half}"
    runs = []
    for compiled in (False, False, True):
        set_compiled(config, compiled)
        net.load_dict(init)
        net.zero_grad()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(RESNET_OPT))
        losses = []
        if compiled:
            step = trainer.compile_step(
                net, lambda n, a, b: ce(n(a), b), accum_steps=2)
            for w in range(ACCUM_WINDOWS):
                t0, d0 = cs.trace_count(), cs.dispatch_count()
                for i, (xm, ym) in enumerate(micro):
                    if w == 0:
                        loss = step(xm, ym, batch_size=half)
                        continue
                    loss, c, t = traced_launches(
                        ck, lambda: step(xm, ym, batch_size=half),
                        total=traced_total)
                    if c or t != want_launches:
                        fail(f"{what}, window {w + 1}, micro-batch {i + 1}"
                             f": counted {c}, traced {t}; want "
                             f"{want_launches} traced")
                    losses.append(loss.float().mean().reshape(1))
                got = (cs.trace_count() - t0, cs.dispatch_count() - d0)
                if got != ((2 if w == 0 else 0), 3):
                    fail(f"{what}, window {w + 1}: (captures, dispatches) "
                         f"{got}; want ({2 if w == 0 else 0}, 3)")
        else:
            for p in net.collect_params().values():
                if p.grad_req != "null":
                    p.grad_req = "add"
            for w in range(ACCUM_WINDOWS):
                net.zero_grad()
                for xm, ym in micro:
                    with mx.autograd.record():
                        loss = ce(net(xm), ym)
                    mx.autograd.backward(loss)
                    if w:
                        losses.append(loss.float().mean().reshape(1))
                trainer.step(RESNET_BATCH)
            for p in net.collect_params().values():
                if p.grad_req != "null":
                    p.grad_req = "write"
        state = [p.data().clone() for p in net.collect_params().values()]
        runs.append((losses, state + [s.clone()
                                      for s in trainer._init_states()]))
    set_compiled(config, True)
    check_run(what, runs, min_fall=False)
    print(f"{what}: {ACCUM_WINDOWS} windows, 3 dispatches a window, 2 "
          f"captures in the first and none after, launches per micro-batch "
          f"{want_launches} (traced)  ok")
    capture_route(config, "unfused")
    del net, runs
    torch.cuda.empty_cache()


def bucket_phase(mx, cs, ps, config) -> None:
    """Phase 8f: ``compile_step(bucket=True)`` with a pad-safe masked loss
    on ResNet-50 in bf16 with its batch norms frozen (running statistics,
    as when fine-tuning: every sample's loss is then its own), batches of
    BUCKET_SIZES images, which all fall into the bucket of RESNET_BATCH.
    One program for the bucket, each padded size checked once and
    accepted; each step's loss equal to the unpadded loss of the same
    weights, bitwise (the check's own rule)."""
    capture_route(config, "unfused")
    net, init, x, y = bf16_resnet(mx)
    frozen = 0

    def freeze(b):
        nonlocal frozen
        if type(b).__name__ == "BatchNorm":
            b._use_global_stats = True
            frozen += 1
        for c in b._children.values():
            freeze(c)

    freeze(net)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def masked(n, a, b, m):
        rows = ce(n(a), b).float() * m
        total = rows[0]
        for i in range(1, rows.shape[0]):
            total = total + rows[i]
        return total

    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_OPT))
    step = trainer.compile_step(net, masked, bucket=True)
    what = (f"ResNet-50 bf16 compile_step(bucket=True), frozen batch norm "
            f"({frozen}), batches {BUCKET_SIZES}")
    t0 = cs.trace_count()
    from mxnet_tpu_torch import serving
    serving.reset_counters()
    for n in BUCKET_SIZES:
        m = torch.ones(n, device=x.device)
        loss = step(x[:n], y[:n], m, batch_size=n)
        if not step.last_step_compiled or step.bucket_refused is not None:
            fail(f"{what}: batch {n}: refused ({step.bucket_refused}) or "
                 f"eager ({step.last_fallback_reason})")
        if not math.isfinite(loss.item()):
            fail(f"{what}: batch {n}: loss {loss.item()}")
    padded = sum(n != RESNET_BATCH for n in BUCKET_SIZES)
    got = (cs.trace_count() - t0, step.padded_steps,
           serving.bucket_stats())
    want = (1, padded, {"hits": padded - len(set(BUCKET_SIZES) - {
        RESNET_BATCH}), "misses": len(set(BUCKET_SIZES) - {RESNET_BATCH})})
    if got != want:
        fail(f"{what}: (captures, padded steps, bucket stats) {got}; want "
             f"{want}")
    print(f"{what}: 1 program for the bucket of {RESNET_BATCH}, {padded} "
          f"padded steps, each size checked once (bitwise pad-safe loss)  "
          f"ok")
    del net, step
    torch.cuda.empty_cache()


def classic_loop_phase(mx, ps, ck, resnet, config, card_line,
                       traced_total) -> dict:
    """Phase 8g: the classic Gluon loop (``hybridize()``; ``record()``
    forward and loss; ``backward``; ``trainer.step``) on the conv + BN
    route, bf16 b128, RESNET_STEPS steps from the same weights: two eager
    runs (MXNET_COMPILED_STEP=0, the recorded forward run eagerly, fused)
    and one with the forward as one graphed tape node. Losses, params,
    running statistics and momenta held graphed against eager; 1 capture
    and 1 dispatch a step; launches and sites per step as the route's.
    Then eager against graphed wall, device busy and host ms a step."""
    route = capture_route(config, "conv_bn")
    want_launches, want_sites = route_gates(route)
    ns = ps.namespace("hybrid_forward")
    net, init, x, y = bf16_resnet(mx)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    what = f"ResNet-50 bf16 b{RESNET_BATCH} classic loop, recorded forward"

    def make_step(trainer):
        def one():
            with mx.autograd.record():
                loss = ce(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            return loss
        return one

    runs, steps, kept = [], {}, 0
    for graphed in (False, False, True):
        set_compiled(config, graphed)
        net.load_dict(init)
        net.zero_grad()
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(RESNET_OPT))
        one = make_step(trainer)
        losses, counted, traced, k = run_traced_steps(
            ck, resnet, what, one, RESNET_STEPS, graphed, want_sites,
            traced_total,
            (lambda: (ns.traces, ns.dispatches)) if graphed else None)
        kept = k or kept
        check_step_launches(f"{what}, graphed={graphed}", counted, traced,
                            want_launches, graphed)
        if graphed and net.last_eager_reason is not None:
            fail(f"{what}: ran eagerly ({net.last_eager_reason})")
        state = [p.data().clone() for p in net.collect_params().values()]
        runs.append((losses, state + [s.clone()
                                      for s in trainer._init_states()]))
        steps[graphed] = one
    check_run(what, runs)
    del runs

    def eager():
        set_compiled(config, False)
        steps[False]()

    def graphed():
        set_compiled(config, True)
        steps[True]()

    t1 = ns.traces
    numbers = with_img_s(capture_numbers(what, {"eager": eager,
                                                "captured": graphed},
                                         kept, card_line), RESNET_BATCH)
    if ns.traces != t1:
        fail(f"{what}: a capture after warm-up")
    print(f"{what}: launches per step {want_launches}, 1 capture, 1 "
          f"dispatch a step; host {numbers['eager']['host_ms']:.3f} ms a "
          f"step eager, {numbers['captured']['host_ms']:.3f} graphed "
          f"[{card_line}]  ok")
    set_compiled(config, True)
    capture_route(config, "unfused")
    del net, steps
    torch.cuda.empty_cache()
    return numbers


# -- 8h. ---------------------------------------------------------------------

# the op sweep's bounds, the card against the CPU in fp32 with TF32 off:
# the card's transcendental functions and reduction orders differ from the
# CPU's by a few ulps, the fused ops run their kernels against the plain
# versions, and the gradients of a normalization's summed output are fp32
# noise around zero on both sides
SWEEP_TOL = (1e-4, 1e-5)            # rtol, atol
SWEEP_GRAD_TOL = (1e-4, 1e-4)
SWEEP_SAMPLERS = ("uniform", "normal", "random_gamma", "exponential",
                  "poisson", "negative_binomial", "randint", "randn",
                  "multinomial", "shuffle", "bernoulli")
SWEEP_FUSED = ("_fused_conv1x1_bn", "_fused_convkxk_bn",
               "_fused_conv1x1_bn_act")
SWEEP_DRAWS = 200_000
# (attrs, mean, variance) of each sampler: mean within 5 standard errors of
# SWEEP_DRAWS draws, variance within 5%
SWEEP_MOMENTS = {
    "uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "normal": (dict(loc=0.5, scale=2.0), 0.5, 4.0),
    "random_gamma": (dict(alpha=2.5, beta=0.5), 1.25, 0.625),
    "exponential": (dict(lam=2.0), 0.5, 0.25),
    "poisson": (dict(lam=3.0), 3.0, 3.0),
    "negative_binomial": (dict(k=3, p=0.4), 4.5, 11.25),
    "randint": (dict(low=2, high=10), 5.5, (8 ** 2 - 1) / 12),
    "randn": (dict(loc=-1.0, scale=0.5), -1.0, 0.25),
    "bernoulli": (dict(prob=0.3), 0.3, 0.21),
}
README_STEPS = 20        # the README's quick start, on gpu(0)
SKILL_STEPS = 50         # SKILL.md's quick drive
SKILL_LOSS_MAX = 0.95    # its final loss on the numpy data below (the CPU's
#                          run gives 0.9347 from a first loss of 1.1137)
SKILL_RTOL = 1e-4        # its losses on the card against the CPU's
ND_ROUTES = ("conv_bn", "epilogue")


def falling(vals) -> bool:
    """Finite losses whose last is below the first."""
    return all(map(math.isfinite, vals)) and vals[-1] < vals[0]


def port_nd():
    """(the op specs of ``tests/op_smoke_specs.py``, the port's registry)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import op_smoke_specs
    from mxnet_tpu_torch.ops import registry
    return op_smoke_specs.SPECS, registry


def sweep_inputs(specs, registry, name):
    """An op's numpy inputs and attrs: ``SPECS``' (the fused ops with 8
    input channels of centred normal draws, the kernels' rule), else a
    seeded (4, 6) input per array."""
    gen = np.random.RandomState(sum(map(ord, name)))
    if name in SWEEP_FUSED:
        arrays, attrs = specs[name]
        x, w = arrays[0], arrays[1]
        x8 = gen.standard_normal((*x.shape[:3], 8)).astype(np.float32)
        w8 = (gen.standard_normal((*w.shape[:3], 8)) * 0.3).astype(
            np.float32)
        return [x8, w8] + [np.asarray(a) for a in arrays[2:]], dict(attrs)
    if name in specs:
        arrays, attrs = specs[name]
        return [np.asarray(a) for a in arrays], dict(attrs)
    n = registry.get_op(name).num_inputs
    n = 2 if n == -1 else n
    return [gen.rand(4, 6).astype(np.float32) + 0.1 for _ in range(n)], {}


def _nd_outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _is_float(dtype) -> bool:
    return str(dtype) in ("float16", "float32", "float64", "torch.bfloat16")


def op_forward(mx, ctx, name, arrays, attrs):
    with ctx:
        return _nd_outs(mx.nd.invoke(name, [mx.nd.array(a) for a in arrays],
                                     dict(attrs)))


def op_grads(mx, ctx, name, arrays, attrs, float_idx):
    """Gradients of the sum of the op's float outputs with respect to its
    float inputs, through ``autograd.record`` / ``autograd.grad``."""
    with ctx:
        nds = [mx.nd.array(a) for a in arrays]
        with mx.autograd.record():
            outs = _nd_outs(mx.nd.invoke(name, nds, dict(attrs)))
            heads = [o.astype("float32").sum() for o in outs
                     if _is_float(o.dtype)]
        return [g.asnumpy() for g in mx.autograd.grad(
            heads, [nds[i] for i in float_idx])]


def _sweep_close(what, got, want, tol):
    if got.shape != want.shape:
        fail(f"op sweep, {what}: shape {got.shape} on the card, "
             f"{want.shape} on the CPU")
    if want.dtype.kind in "biu":
        if not np.array_equal(got, want):
            fail(f"op sweep, {what}: integer outputs differ")
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    if not np.allclose(g, w, rtol=tol[0], atol=tol[1], equal_nan=True):
        err = np.nanmax(np.abs(g - w))
        fail(f"op sweep, {what}: max |card - cpu| {err:.3e} beyond rtol "
             f"{tol[0]}, atol {tol[1]}")
    both = np.isfinite(g) & np.isfinite(w)
    return float(np.abs(g - w)[both].max()) if both.any() else 0.0


def op_sweep(mx, specs, registry) -> dict:
    """Phase 8h (a): every registered op on the card against the port on
    the CPU with the same numpy inputs: forwards (dtype, shape, values
    within SWEEP_TOL), gradients of differentiable float ops (within
    SWEEP_GRAD_TOL), the samplers by shape, dtype and moments, and the same
    seed giving the same draws. Returns the counts checked."""
    gpu, cpu = mx.gpu(0), mx.cpu()
    names = registry.list_ops()
    n_fwd = n_grad = n_rand = 0
    worst = (0.0, "")
    for name in names:
        if name in SWEEP_SAMPLERS:
            continue
        arrays, attrs = sweep_inputs(specs, registry, name)
        got = op_forward(mx, gpu, name, arrays, attrs)
        want = op_forward(mx, cpu, name, arrays, attrs)
        if len(got) != len(want):
            fail(f"op sweep, {name}: {len(got)} outputs on the card, "
                 f"{len(want)} on the CPU")
        for i, (g, w) in enumerate(zip(got, want)):
            if str(g.dtype) != str(w.dtype) or g.ctx != gpu:
                fail(f"op sweep, {name} output {i}: {g.dtype} on {g.ctx}, "
                     f"want {w.dtype} on {gpu}")
            err = _sweep_close(f"{name} output {i}", g.asnumpy(),
                               w.asnumpy(), SWEEP_TOL)
            worst = max(worst, (err, name))
        n_fwd += 1
        float_idx = [i for i, a in enumerate(arrays)
                     if np.issubdtype(a.dtype, np.floating)]
        if registry.get_op(name).differentiable and float_idx:
            got = op_grads(mx, gpu, name, arrays, attrs, float_idx)
            want = op_grads(mx, cpu, name, arrays, attrs, float_idx)
            for i, g, w in zip(float_idx, got, want):
                _sweep_close(f"{name} d/d input {i}", g, w, SWEEP_GRAD_TOL)
            n_grad += 1
    for name in SWEEP_SAMPLERS:
        arrays, attrs = sweep_inputs(specs, registry, name)
        got = op_forward(mx, gpu, name, arrays, attrs)
        want = op_forward(mx, cpu, name, arrays, attrs)
        for g, w in zip(got, want):
            if g.shape != w.shape or str(g.dtype) != str(w.dtype):
                fail(f"op sweep, {name}: {g.shape} {g.dtype} on the card, "
                     f"{w.shape} {w.dtype} on the CPU")
        if name in SWEEP_MOMENTS:
            a, mean, var = SWEEP_MOMENTS[name]
            a = dict(a, shape=(SWEEP_DRAWS,))
        else:
            a = attrs
        draws = []
        for seed in (3, 3):
            mx.random.seed(seed, ctx=gpu)
            draws.append(op_forward(mx, gpu, name, arrays, a)[0].asnumpy())
        if not np.array_equal(draws[0], draws[1]):
            fail(f"op sweep, {name}: the same seed drew differently")
        if name in SWEEP_MOMENTS:
            x = draws[0].astype(np.float64)
            if abs(x.mean() - mean) > 5 * (var / SWEEP_DRAWS) ** 0.5 or \
                    abs(x.var() - var) > 0.05 * var:
                fail(f"op sweep, {name}: mean {x.mean():.4f}, variance "
                     f"{x.var():.4f}; want {mean:.4f}, {var:.4f}")
        n_rand += 1
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], np.float32)
    with gpu:
        draws = mx.nd.invoke("multinomial", [mx.nd.array(probs)],
                             {"shape": SWEEP_DRAWS}).asnumpy()
    for r in range(2):
        freq = np.bincount(draws[r], minlength=3) / SWEEP_DRAWS
        if not np.allclose(freq, probs[r], atol=0.01):
            fail(f"op sweep, multinomial: frequencies {freq}, want "
                 f"{probs[r]}")
    counts = {"ops": len(names), "forwards": n_fwd, "gradients": n_grad,
              "samplers": n_rand}
    if n_fwd + n_rand != len(names):
        fail(f"op sweep checked {n_fwd + n_rand} of {len(names)} ops")
    print(f"op sweep: {len(names)} ops checked on the card against the CPU "
          f"(fp32, TF32 off): {n_fwd} forwards within rtol {SWEEP_TOL[0]}, "
          f"atol {SWEEP_TOL[1]} (largest |card - cpu| {worst[0]:.3e}, "
          f"{worst[1]}), {n_grad} gradients within rtol "
          f"{SWEEP_GRAD_TOL[0]}, atol {SWEEP_GRAD_TOL[1]}, {n_rand} "
          f"samplers by shape, dtype, moments of {SWEEP_DRAWS} draws and "
          f"seeded repeats  ok")
    return counts


def readme_phase(mx, ps) -> list:
    """Phase 8h (b): the README's quick start on gpu(0), at its widths
    (784-128-10, batch 32, ``hybridize()``, Adam at 1e-3), fed NDArrays,
    README_STEPS steps: falling finite loss, and from the second step the
    recorded forward as one graphed tape node (1 capture, then 1 dispatch a
    step)."""
    ns = ps.namespace("hybrid_forward")
    ag, gluon = mx.autograd, mx.gluon
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(128, activation="relu"), gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    x, y = mx.nd.random.normal(shape=(32, 784)), mx.nd.zeros((32,))
    t0, d0 = ns.traces, ns.dispatches
    losses = []
    for step in range(README_STEPS):
        with ag.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(32)
        if step and net.last_eager_reason is not None:
            fail(f"README quick start, step {step + 1}: the recorded "
                 f"forward ran eagerly ({net.last_eager_reason})")
        losses.append(float(loss.mean().asscalar()))
    got = (ns.traces - t0, ns.dispatches - d0)
    if got != (1, README_STEPS - 1):
        fail(f"README quick start: (captures, dispatches) {got}, want "
             f"(1, {README_STEPS - 1})")
    if loss.ctx != mx.gpu(0) or not all(map(math.isfinite, losses)) or \
            not losses[-1] < losses[0]:
        fail(f"README quick start: losses {losses} on {loss.ctx}")
    print(f"README quick start on {x.ctx}: losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} over {README_STEPS} Adam steps; 1 capture, "
          f"{README_STEPS - 1} graphed dispatches  ok")
    return losses


def skill_loop(mx, ctx, steps=SKILL_STEPS) -> list:
    """SKILL.md's quick drive (``nd.FullyConnected``, ``attach_grad``,
    ``nd.sgd_update``, ``_set_data``, ``asscalar``) on ``ctx``, its arrays
    from numpy seed 1."""
    nd, ag = mx.nd, mx.autograd
    rng = np.random.RandomState(1)
    with ctx:
        X = nd.array(rng.randn(64, 10).astype(np.float32))
        y = nd.array(rng.randn(64, 1).astype(np.float32))
        W = nd.array((rng.randn(1, 10) * 0.1).astype(np.float32))
        b = nd.zeros((1,))
        W.attach_grad()
        b.attach_grad()
        losses = []
        for _ in range(steps):
            with ag.record():
                loss = ((nd.FullyConnected(X, W, b, num_hidden=1) - y) ** 2
                        ).mean()
            loss.backward()
            for p in (W, b):
                p._set_data(nd.sgd_update(p, p.grad, lr=0.1)._data)
            losses.append(float(loss.asscalar()))
    if W._data.device.type != ctx.device.type:
        fail(f"SKILL loop ran on {W._data.device}, not {ctx}")
    return losses


def skill_phase(mx) -> list:
    """Phase 8h (c): SKILL.md's loop on gpu(0): its final loss below
    SKILL_LOSS_MAX, and each step's loss within SKILL_RTOL of the CPU's."""
    card_ = skill_loop(mx, mx.gpu(0))
    host = skill_loop(mx, mx.cpu())
    if not card_[-1] < min(SKILL_LOSS_MAX, card_[0]) or not np.allclose(
            card_, host, rtol=SKILL_RTOL, atol=0):
        fail(f"SKILL loop: losses {card_[0]:.6f} -> {card_[-1]:.6f} on the "
             f"card, {host[0]:.6f} -> {host[-1]:.6f} on the CPU")
    print(f"SKILL.md loop on gpu(0): loss {card_[0]:.6f} -> {card_[-1]:.6f} "
          f"over {SKILL_STEPS} SGD steps (< {SKILL_LOSS_MAX}), within rtol "
          f"{SKILL_RTOL} of the CPU's each step  ok")
    return card_


def nd_resnet_phase(mx, ps, ck, resnet, config, card_line, classic,
                    nd_counts, nd_traced) -> dict:
    """Phase 8h (d): the classic loop of 8g (ResNet-50 bf16 b128, SGD
    momentum, ``hybridize()``) fed ``nd.array(..., ctx=mx.gpu(0))`` batches
    and labels, on the conv + BN and epilogue routes, against the same loop
    fed tensors from the same weights: eager (MXNET_COMPILED_STEP=0, each
    layer through ``invoke``) and graphed, losses, parameters, running
    statistics and momenta bitwise equal, launches and sites per step as
    the route's gates (graphed: 1 capture and 1 dispatch a step); the
    dispatches through ``invoke`` a step. Then, on the conv + BN route, the
    NDArray eager loop against the tensor eager loop and the NDArray
    graphed loop: wall, device busy, host ms a step. The launches of the
    NDArray-fed runs alone, counted by the wrappers and traced on the
    device, are added into ``nd_counts`` and ``nd_traced``: the tensor-fed
    controls and the timing loops are in neither."""
    ns = ps.namespace("hybrid_forward")
    net, init, x, y = bf16_resnet(mx)
    xn, yn = mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0))
    if xn.ctx != mx.gpu(0) or xn._data.dtype != torch.bfloat16:
        fail(f"nd batch {xn.ctx} {xn._data.dtype}")
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    base = f"ResNet-50 bf16 b{RESNET_BATCH} classic loop"
    batches = {"tensor": (x, y), "nd": (xn, yn)}
    steps, invokes = {}, {}

    def make_step(flavor, trainer):
        bx, by = batches[flavor]

        def one():
            with mx.autograd.record():
                loss = ce(net(bx), by)
            mx.autograd.backward(loss)
            trainer.step(RESNET_BATCH)
            return loss._data if flavor == "nd" else loss
        return one

    for route_name in ND_ROUTES:
        route = capture_route(config, route_name)
        want_launches, want_sites = route_gates(route)
        for graphed in (False, True):
            what = f"{base}, {route_name}, " \
                   f"{'graphed' if graphed else 'eager'}"
            runs = {}
            for flavor in ("tensor", "nd"):
                set_compiled(config, graphed)
                net.load_dict(init)
                net.zero_grad()
                net.hybridize()
                trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                           dict(RESNET_OPT))
                one = make_step(flavor, trainer)
                per_step = []
                into = nd_traced if flavor == "nd" else {}

                def counted(one=one, per_step=per_step):
                    n0 = mx.nd.invoke_count()
                    out = one()
                    per_step.append(mx.nd.invoke_count() - n0)
                    return out

                losses, counted_l, traced, _ = run_traced_steps(
                    ck, resnet, f"{what}, {flavor}", counted, RESNET_STEPS,
                    graphed, want_sites, into,
                    (lambda: (ns.traces, ns.dispatches)) if graphed
                    else None)
                check_step_launches(f"{what}, {flavor}", counted_l, traced,
                                    want_launches, graphed)
                if flavor == "nd":
                    for c in counted_l:
                        for k, v in c.items():
                            nd_counts[k] = nd_counts.get(k, 0) + v
                if graphed and net.last_eager_reason is not None:
                    fail(f"{what}, {flavor}: ran eagerly "
                         f"({net.last_eager_reason})")
                state = [p.data().clone()
                         for p in net.collect_params().values()]
                state += [s.clone() for s in trainer._init_states()]
                runs[flavor] = (losses, state)
                invokes[(route_name, graphed, flavor)] = per_step
                steps[(route_name, graphed, flavor)] = one
            a, b = (torch.cat([t.detach().double().ravel()
                               for t in runs[f][0] + runs[f][1]])
                    for f in ("tensor", "nd"))
            if not torch.equal(a, b):
                fail(f"{what}: fed NDArrays differs from fed tensors in "
                     f"{(a != b).sum().item()} of {a.numel()} values")
            vals = [v.item() for v in runs["nd"][0]]
            if not falling(vals):
                fail(f"{what}: losses {vals} did not fall")
            print(f"{what}: fed NDArrays equals fed tensors bitwise over "
                  f"{a.numel()} values (losses, parameters, running "
                  f"statistics, momenta); launches a step {want_launches}; "
                  f"invoke dispatches a step, tensors "
                  f"{invokes[(route_name, graphed, 'tensor')]}, NDArrays "
                  f"{invokes[(route_name, graphed, 'nd')]}  ok")
    capture_route(config, "conv_bn")

    def timed(key):
        def call():
            set_compiled(config, key[1])
            steps[key]()
        return call

    what = f"{base}, conv_bn, fed NDArrays against fed tensors"
    numbers = {
        "eager_tensor": mode_numbers(what, "eager, tensors",
                                     timed(("conv_bn", False, "tensor")), 0,
                                     card_line),
        "eager_nd": mode_numbers(what, "eager, NDArrays",
                                 timed(("conv_bn", False, "nd")), 0,
                                 card_line),
        "graphed_nd": mode_numbers(what, "graphed, NDArrays",
                                   timed(("conv_bn", True, "nd")), 0,
                                   card_line)}
    numbers["invokes_a_step"] = {
        f"{r}_{'graphed' if g else 'eager'}_{f}": v[-1]
        for (r, g, f), v in invokes.items()}
    e_t, e_n = numbers["eager_tensor"], numbers["eager_nd"]
    print(f"{what}: eager host {e_n['host_ms']:.3f} ms a step fed NDArrays "
          f"against {e_t['host_ms']:.3f} fed tensors "
          f"({e_n['host_ms'] / e_t['host_ms'] - 1:+.1%}); eager wall "
          f"{e_n['wall_ms']:.3f} against {e_t['wall_ms']:.3f} ms; graphed "
          f"wall fed NDArrays {numbers['graphed_nd']['wall_ms']:.3f} ms "
          f"against phase 8g's {classic['captured']['wall_ms']:.3f} fed "
          f"tensors [{card_line}]")
    set_compiled(config, True)
    capture_route(config, "unfused")
    del net, steps
    torch.cuda.empty_cache()
    return numbers


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
    fwd_err = fwd_kernel_phase(ck, _build)
    bwd_err = bwd_kernel_phase(ck)
    epi_err = epilogue_kernel_phase(ck, _build)
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
    train_counts, train_traced = train_path(models, ck, cfg, init, rng,
                                            config)

    attn_times = fwd_timings(ck, cfg, card_line)
    bwd_times = bwd_timings(ck, cfg, card_line)
    forward_timings(models, cfg, params, requests, attn_times, card_line)
    train_timings(models, ck, cfg, init(), rng, bwd_times, card_line,
                  config)
    del params, requests
    torch.cuda.empty_cache()

    # -- the ResNet train path ----------------------------------------------
    # phases 6-7b hold the eager classic loop (a hybridized block's
    # recorded forward run eagerly); phase 8g holds its graphed form
    set_compiled(config, False)
    resnet_counts, _net, step = resnet_train_path(mx, ck, resnet, config,
                                                  card_line)
    site_backward_phase(ck, nn_ops)
    epi_times = epilogue_timings(ck, card_line)
    epi_sites = epilogue_site_timings(ck, card_line)
    resnet_timings(resnet, config, step, card_line)
    del _net, step
    torch.cuda.empty_cache()

    # -- the fused conv + batch-norm path ------------------------------------
    cbn_counts, step = resnet_conv_bn_path(mx, ck, resnet, config, nn_ops,
                                           card_line)
    cbn_times = conv_bn_timings(ck, card_line)
    stats_sites = stats_site_timings(ck, _build, card_line)
    resnet_timings(resnet, config, step, card_line, CONV_BN)
    del step
    torch.cuda.empty_cache()

    set_compiled(config, True)

    # -- 8. capture -----------------------------------------------------------
    ps, cs = port_capture()
    ck.reset_launch_counts()
    capture_traced = {}
    params = init()
    rng = np.random.RandomState(0)
    requests = [batch(rng, cfg, B, S) for B, S in REQUESTS]
    cap_fwd = capture_forward_phase(models, ps, ck, cfg, params, requests,
                                    card_line, capture_traced)
    del params, requests
    torch.cuda.empty_cache()
    cap_train = capture_train_phase(models, ps, cs, ck, cfg, init, rng,
                                    card_line, config, capture_traced)
    torch.cuda.empty_cache()
    cap_resnet = capture_resnet_phase(mx, ps, cs, ck, resnet, config,
                                      card_line, capture_traced)
    torch.cuda.synchronize()
    capture_counts = ck.launch_counts()
    print(f"capture phase launch counts: counted by the wrappers "
          f"{capture_counts}; traced on the device in the checked replays "
          f"{capture_traced}; program store {json.dumps(ps.stats())}")
    print(json.dumps({"capture": {
        "card": card_line,
        **{f"lm_forward_{B}_{S}": v for (B, S), v in cap_fwd.items()},
        f"lm_train_adam_{TRAIN_TOKENS[0]}_{TRAIN_TOKENS[1]}": cap_train,
        **{f"resnet50_bf16_b{RESNET_BATCH}_{k}": v
           for k, v in cap_resnet.items()}}}))
    torch.cuda.empty_cache()

    # -- 8d-8g. ShardedTrainer, accumulation, buckets, the recorded forward
    ck.reset_launch_counts()
    steps_traced = {}
    sharded = sharded_lane_phase(mx, ps, ck, resnet, config, card_line,
                                 steps_traced)
    accum_phase(mx, cs, ck, resnet, config, steps_traced)
    bucket_phase(mx, cs, ps, config)
    classic = classic_loop_phase(mx, ps, ck, resnet, config, card_line,
                                 steps_traced)
    torch.cuda.synchronize()
    steps_counts = ck.launch_counts()
    if not all(steps_counts[k] for k in (*EPI_KERNELS, *CONV_BN_KERNELS)):
        fail(f"a kernel of the ResNet paths never launched in phases "
             f"8d-8g: {steps_counts}")
    print(f"phases 8d-8g launch counts: counted by the wrappers "
          f"{steps_counts}; traced on the device in the checked replays "
          f"{steps_traced}; program store {json.dumps(ps.stats())}")
    print(json.dumps({"sharded_lane": {
        "card": card_line,
        **{f"resnet50_sharded_bf16_compute_b{RESNET_BATCH}_{k}": v
           for k, v in sharded.items()},
        **{f"resnet50_compile_step_pure_bf16_b{RESNET_BATCH}_{k}":
           with_img_s(v, RESNET_BATCH) for k, v in cap_resnet.items()},
        f"resnet50_classic_loop_bf16_b{RESNET_BATCH}_conv_bn": classic}}))
    torch.cuda.empty_cache()

    # -- 8h. the imperative substrate -----------------------------------------
    specs, registry = port_nd()
    sweep = op_sweep(mx, specs, registry)
    readme_losses = readme_phase(mx, ps)
    skill_losses = skill_phase(mx)
    nd_counts, nd_traced = {}, {}
    nd_numbers = nd_resnet_phase(mx, ps, ck, resnet, config, card_line,
                                 classic, nd_counts, nd_traced)
    torch.cuda.synchronize()
    if not all(nd_counts.get(k) for k in (*EPI_KERNELS, *CONV_BN_KERNELS)):
        fail(f"a kernel of the ResNet paths never launched in phase 8h's "
             f"NDArray-fed runs: {nd_counts}")
    print(f"phase 8h launch counts of the NDArray-fed runs: counted by the "
          f"wrappers {nd_counts}; traced on the device in the checked steps "
          f"{nd_traced}")
    print(json.dumps({"nd": {
        "card": card_line, "op_sweep": sweep,
        "readme_losses": [readme_losses[0], readme_losses[-1]],
        "skill_losses": [skill_losses[0], skill_losses[-1]],
        f"resnet50_classic_loop_bf16_b{RESNET_BATCH}_conv_bn":
            with_img_s(nd_numbers, RESNET_BATCH)}}))
    torch.cuda.empty_cache()

    # -- 9. int8 --------------------------------------------------------------
    int8_counts, int8_err = int8_path(ck)
    int8_ops_phase(port_int8())
    int8_times = int8_timings(ck, card_line)

    # -- 10. results --------------------------------------------------------
    paths = {"forward": fwd_counts, "train": train_counts,
             "resnet_train": resnet_counts, "resnet_conv_bn": cbn_counts,
             "capture": capture_counts, "compiled_steps": steps_counts,
             "nd": nd_counts, "int8": int8_counts}

    # launches the wrappers counted (a capture's once, a replay's not at
    # all), and those a profiler trace saw run in the replays that were
    # checked (the captured runs of the train and capture phases)
    traced_paths = {"train": train_traced, "capture": capture_traced,
                    "compiled_steps": steps_traced, "nd": nd_traced}

    def launches(name):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "traced_replay_launches_by_path": {
                    p: c.get(name, 0) for p, c in traced_paths.items()}}

    t = attn_times[(96, 512)]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:49",
        "design": "persistent TMA + wgmma (fwd_wgmma): 128-key K/V ring of "
                  "2 stages, P as register A of P V, ex2.approx, mask on "
                  "edge tiles only, 64- or 128-row q-tiles, TMA store",
        **launches("flash_attention_fwd"),
        "max_abs_err": fwd_err, **{k: t[k] for k in keys},
        "library": "scaled_dot_product_attention forward",
        "shape": [96, 512, 64, "bf16"],
        **{f"at_{bh}_{s}_64": {k: attn_times[(bh, s)][k] for k in keys}
           for bh, s in FWD_TIMED if (bh, s) != (96, 512)},
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
            "max_abs_err": bwd_err[name], **{k: t[k] for k in keys},
            "library": "scaled_dot_product_attention backward (the whole "
                       "backward, against `backward`)",
            "shape": [bh, s, 64, "bf16"],
            "backward": {k: bwd_times[("backward", bh, s)][k] for k in keys},
            "at_96_512_64": {
                **{k: bwd_times[(name, 96, 512)][k] for k in keys},
                "backward": {k: bwd_times[("backward", 96, 512)][k]
                             for k in keys}},
        })
    stats_design = ("persistent TMA + wgmma GEMM (gemm_wgmma, the core of "
                    "matmul_epilogue): 128-row tiles of 64/128 columns, "
                    "each CTA keeps one n-tile, k-box ring, "
                    "running column sums per thread across the CTA's "
                    "tiles, one scratch row per CTA, the final sum by the "
                    "last CTA of each n-tile")
    for name, line, design in (
            ("matmul_stats", 512, stats_design),
            ("matmul_epilogue", 574, "persistent TMA + wgmma GEMM "
             "(epilogue_wgmma): 128-row tiles of 64/128/256 columns, n-tile "
             "fastest, k-box ring, residual by TMA into a tile buffer, "
             "epilogue in place, TMA store")):
        sites = [dict(shape=[m, k, n, "bf16"], **epi_times[(name, m, k, n)])
                 for m, k, n in EPI_SITES]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/conv_bn_epilogue.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            "design": design,
            **launches(name), "max_abs_err": epi_err[name],
            **{k: sites[0][k] for k in keys},
            "library": "torch.matmul of the same product, which computes "
                       "neither the statistics nor the epilogue",
            "shape": sites[0]["shape"], "sites": sites,
            **({"all_sites": epi_sites["sites"],
                "per_step": epi_sites["step"]}
               if name == "matmul_epilogue" else
               {"all_sites": stats_sites[name]["sites"],
                "per_step": stats_sites[name]["step"]}),
        })
    sites = [t for key, t in cbn_times.items()
             if key[0] == "matmul_bn_stats"]
    kernels.append({
        "name": "matmul_bn_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/conv_bn_epilogue.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:316",
        "design": stats_design + ", y by TMA store from a tile buffer",
        **launches("matmul_bn_stats"),
        "max_abs_err": cbn_err["matmul_bn_stats"],
        **{k: sites[0][k] for k in keys},
        "library": "torch.matmul of the same product, which computes no "
                   "statistics",
        "shape": sites[0]["shape"], "sites": sites,
        "all_sites": stats_sites["matmul_bn_stats"]["sites"],
        "per_step": stats_sites["matmul_bn_stats"]["step"],
    })
    kxk = cbn_times["convkxk_bn_stats"]
    kernels.append({
        "name": "convkxk_bn_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/convkxk_bn_stats.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:880",
        "design": "persistent TMA + wgmma implicit GEMM on the statistics "
                  "kernels' core (gemm_wgmma, KIND kConvStats): x by TMA "
                  "im2col loads, one per (tap, 64-channel block) k-box of "
                  "128 output pixels, the OHWI weight as a 3-D map, 64-, "
                  "128- or 256-column tiles (256 where the waves allow, "
                  "lanes splitting the running sums), the statistics' "
                  "running sums and in-kernel final sum, z by TMA store",
        **launches("convkxk_bn_stats"),
        "max_abs_err": cbn_err["convkxk_bn_stats"],
        **{k: kxk["sites"][0][k] for k in keys},
        "library": "cuDNN F.conv2d of the same conv, which computes no "
                   "statistics",
        "shape": kxk["sites"][0]["shape"], "sites": kxk["sites"],
        "per_step": kxk["step"],
    })
    t = int8_times["micro"]
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:752",
        "design": "persistent TMA + wgmma s8 GEMM (int8_wgmma): one "
                  "128-column n-tile per CTA, x k-boxes through a ring, w's "
                  "panel transposed K-major once per CTA (K <= 512; a "
                  "K-major copy of w above), epilogue in registers, TMA "
                  "store of the fp32 or s8 tile",
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
