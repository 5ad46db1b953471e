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
11. Serving (``serving``, ``serving_decode``, and the workers of
   ``tools/torch_serving_latency.py``), none of whose paths launches a TPU
   kernel's port (the counts are zeroed before and printed after). (a) The
   decode engine serves ``TinyCausalLM`` at DECODE_WIDTH (the flagship
   config's widths, fp32, weights from numpy seed 0) on the default page
   pool (512 x 16): ``warmup()`` captures exactly the prefill buckets + 1
   programs (the decode program in each sampler form); a join/retire
   storm of STORM_REQUESTS greedy requests (prompts of STORM_PROMPT
   tokens from numpy seed 0, STORM_NEW new,
   concurrency STORM_CONCURRENCY) beside the lane_decode storm's slow
   model on the same pool: 0 captures after warm-up, one dispatch per
   decode iteration and per prefill, 0 leaked pages after ``drain()``, a
   clean pool audit, two geometries on the pool; the first
   ORACLE_REQUESTS requests each bitwise the engine's own arithmetic run
   eagerly for it alone (``paged_oracle``), the slow model's token-exact
   against ``eager_generate``; the fp32
   requests' agreement with ``eager_generate`` is printed with the model's
   logit and attention-score sizes (not gated: rounding picks among
   near-equal attention keys at these widths). Then the same weights in
   fp64: a storm of EXACT_REQUESTS requests token-exact against
   ``eager_generate``, a shared-prompt burst with prefix hits, token-exact,
   and a seeded sampling request preempted on a PREEMPT_POOL_PAGES-page
   pool replaying the eager loop's tokens. (c) On the fp32 engine: the
   decode step at 8 rows captured against eager (wall, device busy, host
   ms a call, idle share, peak memory), and the lane_decode A/B at full
   width: tokens/s one at a time and continuous, the batching speedup (bar
   >= 2, printed), p50/p99, the iteration's wall, host ms and idle share
   from a trace, graph launches equal to dispatches. (b) The one-shot
   engine serves the lane_infer MLP and ResNet-50 v1 (NHWC, 224², predict
   mode, hybridized) in fp32 and bf16: SERVE_REQUESTS requests of
   SERVE_ROWS rows from SERVE_THREADS threads, each output its exact-shape
   eager forward's by the verify rule; programs <= buckets and 0 captures
   after warm-up where bucketing was accepted; whether verify accepted or
   refused bucketing, and why, is printed. (d) The lanes' own workers
   (``lanes_phase``): the lane_infer stream, the two-model storm and the
   shared-prefix lane at their own widths, with their bars printed. A
   JSON line holds phase 11's numbers.
12. Speculative decoding (``GenerativeEngine(draft=...)``,
   ``MXNET_SPEC_DECODE=1``) at SPEC_WIDTH: ``high_agreement_pair`` at the
   flagship widths (a 12-layer target whose layers 2-12 are the identity,
   a 1-layer draft sharing its first layer) and a low-agreement 1-layer
   draft drawn on its own, SPEC_REQUESTS greedy requests of SPEC_NEW
   tokens at SPEC_ROWS rows, k SPEC_K, each engine on a pool of its own.
   Gated: in fp64 both drafts' streams token-exact against the non-spec
   engine, the low-agreement one auto-disabled; a seeded sampled request
   on the card equal, seed for seed, to the same engine on the CPU; in
   fp32 both drafts' streams token-exact against the non-spec engine,
   acceptance >= SPEC_MIN_ACCEPTANCE and the low-agreement leg
   auto-disabled; 0 captures after warm-up and no leaked page on every
   leg; no launch of a TPU kernel's port. Printed: tokens/s spec against
   baseline, the captured draft-round and verify programs' wall, device
   busy and host ms, peak memory; then ``tools/torch_serving_latency.py``'s
   ``--speculative`` lane (the reference's widths and bars) with its
   bars printed, gated on token-exactness and 0 captures. A JSON line
   holds phase 12's numbers.
13. The mixture-of-experts LM: the flagship config with MOE_EXPERTS
   experts, top MOE_TOP_K, capacity factor MOE_CAPACITY (``num_experts``,
   ``parallel.moe``), Adam at TRAIN_LR on tokens TRAIN_TOKENS, at
   ``grad_accum`` 1 and 2: two eager runs of MOE_EAGER_STEPS steps and one
   captured run of MOE_CAPTURED_STEPS; the path's launches are those of
   these runs alone (not of the capacity-drop forwards or the timing
   loops). Gated: captured against eager by phase 8's rule over the first
   MOE_EAGER_STEPS steps (losses, params, moments), 1 capture and 1
   dispatch a step, the flash kernels' launches each eager step counted
   by the wrappers and each replay's traced (12, or 24 at ``grad_accum``
   2), their sum over the runs, finite falling losses, no flash
   fallback. Printed: eager against captured wall, device busy and peak
   memory of the step, the capacity-drop share per layer at init and
   after the steps. A JSON line holds phase 13's numbers. Phase 12 also
   prints the device operations a replay of each sampler form's decode,
   draft-round and verify program runs.
14. The mesh of one (``parallel``): ``init_process_group("nccl")`` with one
   rank from a file store under the run's temporary directory, one eager
   all-reduce before any capture (NCCL makes its communicator at the
   first collective). Every function of ``parallel.collectives`` over the
   one-rank groups of a (dp, fsdp, tp) mesh, eager and replayed from a
   CUDA graph capture, equal to its one-rank definition (the one check of
   NCCL under capture one card can give). ``Trainer(kvstore='nccl').
   compile_step`` on ResNet-50 v1, bf16, batch RESNET_BATCH, on the conv +
   BN and the epilogue routes, under ``MXNET_SPMD_MESH`` of each of
   MESH_SPECS: parameters, optimizer state and running statistics
   bitwise the same MESH_STEPS steps without a kvstore; the route's
   launches a step counted and traced, 1 capture, 1 dispatch a step, 0
   reshards; captured wall with and without the mesh printed. Then
   ``ShardedTrainer`` with ``fsdp_plan()`` and ``tensor_parallel_plan()``
   on the same net over the mesh of one (bf16 compute, fp32 masters, the
   conv + BN route) bitwise the plan-less one. The launches of the path
   are those of the kvstore and planned runs. Multi-GPU collectives are
   not run here (one card). A JSON line holds phase 14's numbers.
15. The LM on a mesh (``sharding_plan``, ``make_train_step(cfg, mesh)``,
   ``make_pp_pipeline``), at the BERT-base width in bf16 on tokens
   TRAIN_TOKENS, in an NCCL world of one rank (as phase 14): the dense and
   the MoE (MOE_EXPERTS experts, top MOE_TOP_K) steps, Adam and LAMB, on
   the mesh of one MESH_LM_AXES with their params and moments placed by
   the plan, MESH_LM_STEPS captured steps gated bitwise the plain
   captured step's (losses, params, moments); the pipeline at pp=1
   (PP_AXES) with each of PP_MICRO micro-batches through
   ``make_pp_train_step``, PP_STEPS captured Adam steps held to the same
   arithmetic unpipelined on fp32 master weights and, within the
   fp32-packing bound, to the plain step (see ``pp_runs``); every run 1 capture and 1 dispatch a step, B1-B3's
   launches each step counted by the wrappers at the first call and
   traced by kernel name in each replay (12 a step on the mesh steps,
   12 x the micro-batches on the pipeline), no flash fallback; ring
   attention at sp=1 against dense attention (a smoke check: a ring of
   more than one member needs more than one card). Printed: each path's
   eager and captured wall, device busy, host ms, idle share and peak
   memory. The path's launches are those of the mesh and pp runs. A JSON
   line holds phase 15's numbers.
16. The runtime around the step (``engine``, ``metric``, ``profiler``,
   ``sentinel``, ``parallel.elastic``) on the ResNet-50 v1 bf16 step at
   batch RESNET_BATCH through ``Trainer.compile_step`` on the conv + BN
   route (B4 at the 36 1x1 sites, B8 at the 16 3x3 sites), weights from
   seed 0, batches from numpy seeds, captured before the loops. (a)
   RUNTIME_STEPS steps of a
   synchronous loop (a blocking copy of each batch, host metric reads
   under ``MXNET_METRIC_DEVICE=0``) against the same steps pipelined
   (``engine.prefetch(depth=RUNTIME_DEPTH)`` of pinned batches, ``Loss``
   and ``Accuracy`` accumulated on the device and read once), each under
   ``profiler.StepTimeline``: final parameters and momenta bitwise equal,
   accuracy equal, losses within RUNTIME_LOSS_RTOL, the steady
   dispatch-ahead depth >= RUNTIME_DEPTH, no blocking host read or
   synchronization in a pipelined step (the port's counters), and a traced
   replay running 36 B4 and 16 B8; printed: each loop's
   ``device_idle_gap_us``, wall and the speedup. (b) ``Sentinel(every=
   SENTINEL_EVERY)`` over SENTINEL_STEPS steps: each in-program digest
   bitwise ``sentinel.tree_digest`` of the same state recomputed after
   ``engine.waitall()``, its parameter sum and gradient norm within
   SENTINEL_RTOL of host recomputes, the parameters after the run bitwise
   those of the same steps without a sentinel, no capture after the
   first call, one dispatch and no blocking synchronization a step;
   printed: the overhead of ``every=20`` against off over
   SENTINEL_OVERHEAD_STEPS steps, the plain and the digest form's memory
   pools and the fold's peak memory. (c) ``tools/torch_elastic_drill.py``'s
   three children, each a fresh ``python3`` on the card: uninterrupted,
   preempted by a real SIGTERM at step 7 (``run_elastic(preemption=
   True)``, async checkpoints every 4 steps, the drain force-saving the
   last completed step), restarted: 0 steps replayed, the restored hash
   the saved one, the final state bitwise the uninterrupted child's, no
   temp file left, B4 and B8 launched in every child, ``telemetry.merge``
   of the three shards holding ``elastic.recovery_s`` and
   ``preemption.drain_s``; printed: the recovery wall, restore and drain
   ms and the captures on restart. The path's launches are those of (a)
   and (b), name ``runtime``. A JSON line holds phase 16's numbers.
17. Mixed precision (``amp``). (k) The fp16 forms of B4, B5, B6 and B8
   against their plain versions at the edges and cases of phases 5 and 5b
   and at every site shape of the ResNet-50 step, with bf16's bounds
   scaled to fp16's ulp, bitwise repeatable; (t) each fp16 kernel beside
   its bf16 form over a step's launches at every site shape (interleaved,
   one call), and at its first timed site with its plain version and the
   library call. (a) ResNet-50 v1 at batch RESNET_BATCH, fp32 parameters
   from seed 0, under ``amp.init("float16")`` with ``amp.init_trainer``,
   SGD momentum through ``Trainer.compile_step`` on the conv + BN route,
   AMP_STEPS steps with the batch of step AMP_OVERFLOW_AT scaled to
   overflow fp16, once with ``MXNET_AMP_LAG=0`` and once with 1 (cuDNN
   deterministic in both): the lag-1 run bitwise the lag-0 run
   (parameters, momenta, the scaler's scale and clean-step count), the
   overflow step leaving every parameter and momentum as it was and
   halving the scale, one dispatch a replay with each flag read one step
   late and no other host read, the first step's loss within
   AMP_LOSS_RTOL of the fp32 step's on the same weights, and a traced
   replay running B4 and B8 in fp16 at the sites the route fuses under
   fp16 AMP (AMP16_CONV_BN: an fp16 input is not fused, as in the
   reference); printed: the captured step's wall. (b) The epilogue route
   in fp16, B5 and B6 traced in fp16. (c) ``amp.init()`` (bf16, no
   scaler) on the conv + BN route: B4 and B8 traced in bf16 at all 52
   sites. (d) ``amp.convert_hybrid_block(net, "float16")`` hybridized,
   held to the fp32 net within AMP_INFER_RTOL, and the captures of its
   calls across ``amp.init`` / ``uninit``. The path's launches are those
   of (a)-(c), name ``amp``; the kernels line gains a row per fp16 form.
   A JSON line holds phase 17's numbers.
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
import threading
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
# steps a profile averages over: 2 since PR 19 (3 before), which took a
# third of the script's time off its profiles as the script reached 89% of
# its 1200 s limit
PROFILE_STEPS = 2
# a profiler trace can miss the first kernels of a graph replay that starts
# as soon as the trace does (the LM train step's flash-forward launches),
# and missed none after a 50 ms wait inside the trace before the replay
# (tools/torch_trace_settle.py counts both; PERF.md). Late in a whole run
# a trace lost the records of the first ~51 ms after its start (every
# replay of one MoE graph short by its first 118 kernels, marker
# included), and none with a 200 ms wait in 220 traces (PERF.md §6);
# a later whole run lost one record with 200 ms. The records lost were
# always a trace's first ones, so each trace runs a prefix of
# TRACE_PREFIX short marker kernels and one of about 10 ms, all run to
# their end, before fn: the first records a trace loses are the prefix's,
# and their count (the prefix's records missing) is reported.
TRACE_SETTLE_S = 0.2
TRACE_PREFIX = 1024
TRACE_PREFIX_SPIN = 1 << 24  # cycles of the prefix's last marker
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
# fp16 (phase 17): bf16's bound scaled to fp16's ulp, 2^-10 against 2^-7.
EPI_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (1.25e-3, 1.25e-3),
           torch.float32: (1e-4, 1e-5)}
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
Z_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
         torch.float32: 0.0}

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


# phase 11 (serving): the decode engine at the flagship config's widths
# (__graft_entry__.py:25-28) in fp32, its pool at the knobs' defaults
DECODE_WIDTH = dict(vocab=30528, d_model=768, n_layers=12, n_heads=12,
                    d_mlp=3072, max_seq=512)
STORM_REQUESTS, STORM_CONCURRENCY, STORM_NEW = 32, 8, 64
STORM_PROMPT = (8, 200)          # prompt tokens, drawn from numpy seed 0
ORACLE_REQUESTS = 16             # storm requests held to the oracles: the
                                 # first 16 of the 32 (time)
EXACT_REQUESTS = 8               # fp64 storm: the first 8 of the prompts
BURST_USERS, BURST_PROMPT, BURST_NEW = 8, 96, 16
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234)
PREEMPT_POOL_PAGES = 12          # too few for two sampled requests
PREEMPT_PROMPT, PREEMPT_NEW = 80, 64
SLOW_REQUESTS, SLOW_NEW = 8, 8
AB_REQUESTS, AB_NEW = 16, 32     # the lane_decode A/B at full width
SERVE_REQUESTS, SERVE_THREADS, SERVE_ROWS = 64, 4, (1, 8)
SERVE_VERIFY = (1e-5, 1e-6)      # the verify rule's last-ulp bound
SERVE_IMAGE = 224

# phase 12 (speculative decoding): high_agreement_pair at the flagship
# widths (__graft_entry__.py:25-28), the decode phase's max_seq
SPEC_WIDTH = dict(vocab=30528, d_model=768, target_layers=12,
                  draft_layers=1, n_heads=12, max_seq=DECODE_WIDTH["max_seq"])
SPEC_REQUESTS, SPEC_NEW, SPEC_K, SPEC_ROWS = 12, 32, 4, 4
SPEC_PROMPT = (8, 64)            # prompt tokens, drawn from numpy seed 12
SPEC_WARM = 128                  # warm-up covers prompt + new tokens
SPEC_POOL = 256                  # pages of 16 tokens, one pool an engine
SPEC_MIN_ACCEPTANCE = 0.7        # the reference's bar
# phase 13 (the MoE LM): the flagship config with experts
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25
MOE_EAGER_STEPS, MOE_CAPTURED_STEPS = 3, 5


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
    idle share, and the kernels by device time. The trace records the
    device only: only its kernels are read, and recording every host op
    of an eager step cost a third of the script's time."""
    from torch.profiler import ProfilerActivity, profile as trace
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
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
    "conv_bn_epilogue": (r"gemm_wgmmaILi(\d+)ELi(\d)ELi(\d)E\d+"
                         r"(__nv_bfloat16|__half)", 16),
    "convkxk_bn_stats": (r"gemm_wgmmaILi(\d+)ELi(\d)ELi(\d)E\d+"
                         r"(__nv_bfloat16|__half)", 6),
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
        elem = "bf16" if args[3] == "__nv_bfloat16" else "fp16"
        k = 4096 if nrb == 1 else 64      # the ring depth follows K
        if kind == "3":
            cfg = lambda what: kxk_config(bn, what)
        elif kind == "0":
            cfg = lambda what: epi_config(bn, k, what)
        else:
            cfg = lambda what: stats_config(bn, k, int(kind == "2"), what)
        return (f"gemm_wgmma<{bn}, {nrb}, {GEMM_KINDS[kind]}, {elem}> "
                f"({cfg(1)}-stage ring, {nrb} tile buffer"
                f"{'' if nrb == 1 else 's'})", cfg(0))

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
# traced_launches' traces in this process (printed with the kernels line)
TRACES = [0]
# the prefix records each trace lost (traced_launches)
TRACE_LOSS = {"short": 0, "most": 0}


def trace_prefix() -> None:
    """TRACE_PREFIX short kernels of their own name (``spin_kernel``), one
    long one, run to their end."""
    for _ in range(TRACE_PREFIX):
        torch.cuda._sleep(1)
    torch.cuda._sleep(TRACE_PREFIX_SPIN)
    torch.cuda.synchronize()


def note_prefix_loss(prof) -> None:
    seen = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" in e.name)
    lost = TRACE_PREFIX + 1 - seen
    if lost:
        TRACE_LOSS["short"] += 1
        TRACE_LOSS["most"] = max(TRACE_LOSS["most"], lost)


def traced_launches(ck, fn, trace=True, total=None, by_dtype=None):
    """fn(), under a profiler that traces the device only if ``trace``:
    (its result, the port's kernel launches that the wrappers counted, and
    those the trace saw run on the device, each by wrapper and without
    zeros; None untraced). A replayed graph runs no Python, so only the
    trace sees its launches; a call that captures is not traced. The
    traced counts are added into ``total``, and the conv / batch-norm TMA
    + wgmma kernels' by (wrapper, element type) into ``by_dtype``."""
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
            # marker kernels run to their end inside the trace before fn:
            # with the settle alone, traces of the MoE step lost their
            # first records (PERF.md §6)
            trace_prefix()
            out = fn()
            torch.cuda.synchronize()
        note_prefix_loss(prof)
        TRACES[0] += 1
        traced = {}
        for evt in prof.events():
            name = ck.kernel_of(evt.name) \
                if evt.device_type == torch.autograd.DeviceType.CUDA else None
            if name:
                traced[name] = traced.get(name, 0) + 1
                dtype = ck.kernel_dtype(evt.name)
                if by_dtype is not None and dtype:
                    by_dtype[(name, dtype)] = \
                        by_dtype.get((name, dtype), 0) + 1
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
    of the largest value, the rule of fused against unfused. Compared
    tensor by tensor, in float64 (a model's params and moments can be
    1.5 G values). Prints and returns the rule used."""
    def flat(t):
        return t.detach().double().ravel()

    def equal(xs, ys):
        return all(torch.equal(flat(x), flat(y)) for x, y in zip(xs, ys))

    def dist(xs, ys):
        return max(((flat(x) - flat(y)).abs().max().item()
                    for x, y in zip(xs, ys) if x.numel()), default=0.0)

    n = sum(t.numel() for t in eager_a)
    if equal(eager_a, eager_b):
        rule = "bitwise (two eager runs bitwise equal)"
        if not equal(captured, eager_a):
            bad = sum((flat(z) != flat(x)).sum().item()
                      for x, z in zip(eager_a, captured))
            fail(f"{what}: captured differs from eager in {bad} of {n} "
                 f"values (max |Δ| {dist(captured, eager_a):.3e}), where "
                 f"two eager runs are bitwise equal")
    else:
        spread_ = dist(eager_b, eager_a)
        err = dist(captured, eager_a)
        top = max((flat(x).abs().max().item() for x in eager_a
                   if x.numel()), default=0.0)
        lim = FUSED_SPREAD * spread_ + FUSED_SLACK * top
        rule = (f"within {FUSED_SPREAD} x the eager spread (two eager runs "
                f"differ): max |Δ| {err:.3e} <= {lim:.3e}, spread "
                f"{spread_:.3e}")
        if not err <= lim:
            fail(f"{what}: captured vs eager max |Δ| {err:.3e} > {lim:.3e} "
                 f"({FUSED_SPREAD} x the eager spread {spread_:.3e})")
    print(f"{what}: captured vs eager over {n} values, {rule}  ok")
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


# ---------------------------------------------------------------------------
# 11. serving
# ---------------------------------------------------------------------------
def port_serving():
    """(serving, serving_decode, tools.torch_serving_latency) beside this
    file."""
    from mxnet_tpu_torch import serving, serving_decode
    from tools import torch_serving_latency
    return serving, serving_decode, torch_serving_latency


def pow2_grid(cap):
    out, b = [], 1
    while b <= cap:
        out.append(b)
        b <<= 1
    return out


def storm_prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, size=rng.randint(STORM_PROMPT[0],
                                                   STORM_PROMPT[1] + 1)
                        ).tolist() for _ in range(STORM_REQUESTS)]


def paged_oracle(sd, eng, prompt, n):
    """The engine's own arithmetic for one greedy request alone, run
    eagerly: its prefill body at the prompt's bucket, then its decode body
    at the engine's row count with the request in row 0 and the other rows
    dead (trash tables, length 0), over pages of its pool. A decode row's
    values do not depend on the other rows, so the captured, continuously
    batched engine must give these tokens bitwise."""
    pool, page, trash = eng._pool, eng._pool.page, eng._pool.trash
    rows, width = eng._rows, eng._max_pages
    bucket = min(eng._policy.bucket(len(prompt)), eng._model.max_seq)
    pages = pool.alloc(-(-(len(prompt) + n) // page))
    try:
        with torch.no_grad(), pool.exclusive(eng._geom):
            tokens = torch.zeros(bucket, dtype=torch.long)
            tokens[:len(prompt)] = torch.tensor(prompt)
            table = torch.full((width,), trash, dtype=torch.long)
            table[:len(pages)] = torch.tensor(pages)
            greedy = [torch.tensor(0.0), torch.tensor(0), torch.tensor(1.0),
                      torch.tensor(0)]
            out = [int(eng._prefill_fn(bucket)(
                *[t.cuda() for t in (tokens, torch.tensor(len(prompt)),
                                     table, *greedy)]))]
            body = eng._decode_fn()
            tables = torch.full((rows, width), trash, dtype=torch.long)
            tables[0] = table
            for cached in range(len(prompt), len(prompt) + n - 1):
                toks = torch.zeros(rows, dtype=torch.long)
                toks[0] = out[-1]
                lengths = torch.zeros(rows, dtype=torch.long)
                lengths[0] = cached
                nxt = body(*[t.cuda() for t in (
                    toks, tables, lengths, torch.zeros(rows),
                    torch.zeros(rows, dtype=torch.long), torch.ones(rows),
                    torch.zeros(rows, dtype=torch.long))])
                out.append(int(nxt[0]))
    finally:
        pool.free(pages)
    return out


def attention_scale(model, params, prompt):
    """(largest |logit|, largest |attention score| of each layer) of the
    model's prefill over ``prompt``: the forward of
    ``TinyCausalLM.prefill``, keeping the scores."""
    with torch.no_grad():
        toks = torch.tensor(prompt, device="cuda")
        b = toks.shape[0]
        h = params["emb"][toks] + params["pos"][:b]
        causal = torch.ones(b, b, dtype=torch.bool, device="cuda").tril()
        scales = []
        for lp in params["layers"]:
            q, k, v = (model._heads(h @ lp[w]) for w in ("wq", "wk", "wv"))
            scores = torch.einsum("ihd,jhd->ihj", q, k) / math.sqrt(
                model.head_dim)
            scores = scores.masked_fill(~causal[:, None, :], -1e30)
            scales.append(float(scores.masked_fill(
                ~causal[:, None, :], 0).abs().max()))
            att = torch.einsum("ihj,jhd->ihd", torch.softmax(scores, -1), v)
            h = h + att.reshape(b, -1) @ lp["wo"]
            h = model._mlp(h, lp)
        return float((h[-1] @ params["out"]).abs().max()), scales


def first_difference(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def decode_storm_phase(sd, lat, card_line) -> dict:
    """11a: the decode engine at DECODE_WIDTH in fp32 on the default pool:
    warm-up captures prefill buckets + 1 programs; the join/retire storm
    (greedy, STORM_CONCURRENCY threads) beside the lane_decode storm's slow
    model on the same pool: 0 captures after warm-up, one dispatch (a
    graph replay) per decode iteration and per prefill, 0 leaked pages
    after ``drain()``, a clean audit, two geometries; every request bitwise
    the engine's own arithmetic run eagerly for that request alone
    (``paged_oracle``), and compared with ``eager_generate`` (reported).
    Then 11c's timings on the same engine. Then the same model in fp64
    (``exact_phase``), where rounding cannot flip a token."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model = sd.TinyCausalLM(**DECODE_WIDTH)
    t0 = time.perf_counter()
    params = model.init_params(0, device="cuda")
    n_params = sum(t.numel() for t in [params["emb"], params["pos"],
                                       params["out"]]
                   + [w for lp in params["layers"] for w in lp.values()])
    print(f"11a: TinyCausalLM {DECODE_WIDTH}: {n_params / 1e6:.1f} M "
          f"params fp32 from numpy seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    pool = sd.PagePool()
    eng = sd.GenerativeEngine(model, params=params, pool=pool, name="full",
                              device="cuda")
    slow_m = lat.slow_model()
    slow_p = slow_m.init_params(1, device="cuda")
    slow = sd.GenerativeEngine(slow_m, params=slow_p, pool=pool, max_rows=2,
                               name="slow", device="cuda")
    out = {"n_params": n_params}
    try:
        grid = pow2_grid(DECODE_WIDTH["max_seq"])
        c0 = sd.trace_count()
        t0 = time.perf_counter()
        n = eng.warmup()
        out["warmup_s"] = time.perf_counter() - t0
        # the decode program in each sampler form counts once
        forms = len(sd.FORMS)
        if n != len(grid) + 1 or sd.trace_count() - c0 != n + forms - 1:
            fail(f"decode warm-up captured {n} programs "
                 f"({sd.trace_count() - c0} traces), want prefill buckets "
                 f"{grid} + 1 = {len(grid) + 1} ({len(grid) + forms} "
                 "traces: the decode program in each sampler form)")
        slow.warmup(max_len=16)
        print(f"11a: warm-up captured {n} programs (prefill buckets {grid} "
              f"+ decode) in {out['warmup_s']:.1f} s; pool "
              f"{pool.pages} x {pool.page}, storage "
              f"{2 * pool.storage(eng._geom)[0].numel() * 4 / 2**20:.0f} "
              f"MiB of K + V")
        prompts = storm_prompts(model.vocab)
        slow_prompts = lat.mk_prompts(np.random.RandomState(1),
                                      SLOW_REQUESTS, slow_m.vocab, 4, 13)
        t0, d0 = sd.trace_count(), sd.dispatch_count()
        s0, q0 = eng.stats(), slow.stats()
        res = {}

        def run(name, e, ps, conc, new):
            def go():
                res[name] = lat.drive(e, ps, conc, new)
            return go

        threads = [threading.Thread(target=run("full", eng, prompts,
                                               STORM_CONCURRENCY,
                                               STORM_NEW)),
                   threading.Thread(target=run("slow", slow, slow_prompts,
                                               2, SLOW_NEW))]
        t_storm = time.perf_counter()
        lat._join(threads)
        storm_s = time.perf_counter() - t_storm
        eng.drain()
        slow.drain()
        st, sst = eng.stats(), slow.stats()
        steps = (st["decode_steps"] - s0["decode_steps"]
                 + sst["decode_steps"] - q0["decode_steps"])
        prefills = (st["prefills"] - s0["prefills"]
                    + sst["prefills"] - q0["prefills"])
        traces = sd.trace_count() - t0
        dispatches = sd.dispatch_count() - d0
        wall, tokens, sheds, outs = res["full"]
        _sw, _st, slow_sheds, slow_outs = res["slow"]
        if sheds or slow_sheds:
            fail(f"the storm shed {sheds} + {slow_sheds} requests")
        if traces:
            fail(f"{traces} captures after warm-up in the storm")
        if dispatches != steps + prefills:
            fail(f"{dispatches} dispatches for {steps} decode iterations + "
                 f"{prefills} prefills: not one replay per iteration")
        if pool.in_use() or pool.audit():
            fail(f"after drain: {pool.in_use()} pages in use, audit "
                 f"{pool.audit()}")
        if len(pool._storage) != 2 or pool.stats()["high_water"] < 2:
            fail(f"multi-model accounting: {len(pool._storage)} geometries, "
                 f"high water {pool.stats()['high_water']}")
        t0 = time.perf_counter()
        for i, p in enumerate(prompts[:ORACLE_REQUESTS]):
            want = paged_oracle(sd, eng, p, STORM_NEW)
            if outs[i] != want:
                fail(f"storm request {i} (prompt {len(p)} tokens) differs "
                     f"from the engine's arithmetic run eagerly for it alone "
                     f"at token {first_difference(outs[i], want)}")
        for i, p in enumerate(slow_prompts):
            if slow_outs[i] != sd.eager_generate(slow_m, slow_p, p,
                                                 SLOW_NEW):
                fail(f"slow-model request {i} differs from eager_generate")
        oracle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        diverged = {}
        for i, p in enumerate(prompts[:ORACLE_REQUESTS]):
            j = first_difference(outs[i], sd.eager_generate(model, params, p,
                                                            STORM_NEW))
            if j is not None:
                diverged[i] = j
        eager_s = time.perf_counter() - t0
        logit_max, score_max = attention_scale(model, params, prompts[0])
        out["storm"] = dict(
            requests=STORM_REQUESTS, concurrency=STORM_CONCURRENCY,
            new_tokens=STORM_NEW, wall_s=wall, tokens=tokens,
            tokens_s=tokens / wall, decode_steps=steps, prefills=prefills,
            dispatches=dispatches, captures_after_warmup=traces,
            rows_per_decode=st.get("rows_per_decode"),
            p50_ms=st["p50_us"] / 1e3, p99_ms=st["p99_us"] / 1e3,
            iteration_ms=wall * 1e3 / max(st["decode_steps"]
                                           - s0["decode_steps"], 1),
            slow_p99_ms=sst["p99_us"] / 1e3,
            pool_high_water=pool.stats()["high_water"],
            held_to_oracles=ORACLE_REQUESTS,
            equal_to_eager_generate=ORACLE_REQUESTS - len(diverged),
            first_difference_from_eager_generate=diverged,
            prompt0_max_abs_logit=logit_max,
            prompt0_max_abs_attention_score=score_max)
        print(f"11a: storm of {STORM_REQUESTS} greedy requests (prompts "
              f"{STORM_PROMPT[0]}-{STORM_PROMPT[1]} tokens, {STORM_NEW} new, "
              f"concurrency {STORM_CONCURRENCY}) beside {SLOW_REQUESTS} "
              f"slow-model requests on one pool: {storm_s:.2f} s, "
              f"{tokens / wall:.1f} tokens/s, {steps} decode iterations + "
              f"{prefills} prefills = {dispatches} dispatches, 0 captures, "
              f"p50 {st['p50_us'] / 1e3:.1f} ms p99 "
              f"{st['p99_us'] / 1e3:.1f} ms, pool high water "
              f"{pool.stats()['high_water']} pages, 0 leaked, audit clean; "
              f"requests 0-{ORACLE_REQUESTS - 1} each bitwise the engine's "
              f"arithmetic run eagerly for it alone ({oracle_s:.1f} s), the "
              f"slow model's token-exact against eager_generate "
              f"[{card_line}]")
        print(f"11a: fp32 storm against eager_generate (a full prefill per "
              f"token, not gated): {ORACLE_REQUESTS - len(diverged)} of "
              f"requests 0-{ORACLE_REQUESTS - 1} token-exact, the rest from "
              f"token "
              f"{diverged} (request: first differing token) ({eager_s:.1f} "
              f"s). Without layer norms the residual stream grows layer by "
              f"layer: request 0's largest |logit| is {logit_max:.4g} and "
              f"its largest |attention score| per layer "
              f"{[float(f'{x:.3g}') for x in score_max]}, so the softmax is "
              f"near one-hot and fp32 rounding of two equal formulas (a KV "
              f"cache against a full prefill) can pick another key; the "
              f"fp64 phase below holds token-exactness.")
        out["timings"] = decode_timings(sd, lat, eng, card_line)
    finally:
        eng.close()
        slow.close()
    if pool.in_use() or pool.audit():
        fail(f"after close: {pool.in_use()} pages in use, {pool.audit()}")
    out["exact"] = exact_phase(sd, lat, model, params, pool, card_line)
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    return out, model, params


def exact_phase(sd, lat, model, params32, pool, card_line) -> dict:
    """11a in fp64 (the same weights cast, a second geometry on the same
    pool): a storm of the first EXACT_REQUESTS prompts token-exact against
    ``eager_generate`` (fp64), 0 captures after warm-up; a shared-prompt
    burst with prefix hits, token-exact; a seeded sampling request
    preempted on a PREEMPT_POOL_PAGES-page pool replaying the eager loop's
    sampled tokens."""
    from mxnet_tpu_torch import telemetry

    params = {k: (v.double() if k != "layers" else
                  [{n: w.double() for n, w in lp.items()} for lp in v])
              for k, v in params32.items()}
    out = {}
    eng = sd.GenerativeEngine(model, params=params, pool=pool,
                              name="full_fp64", device="cuda")
    try:
        n = eng.warmup()
        prompts = storm_prompts(model.vocab)[:EXACT_REQUESTS]
        t0, d0 = sd.trace_count(), sd.dispatch_count()
        s0 = eng.stats()
        wall, tokens, sheds, outs = lat.drive(eng, prompts,
                                              STORM_CONCURRENCY, STORM_NEW)
        eng.drain()
        st = eng.stats()
        if sheds or sd.trace_count() != t0 or sd.dispatch_count() - d0 != (
                st["decode_steps"] - s0["decode_steps"]
                + st["prefills"] - s0["prefills"]):
            fail(f"fp64 storm: {sheds} sheds, "
                 f"{sd.trace_count() - t0} captures after warm-up, "
                 f"{sd.dispatch_count() - d0} dispatches")
        for i, p in enumerate(prompts):
            want = sd.eager_generate(model, params, p, STORM_NEW)
            if outs[i] != want:
                fail(f"fp64 storm request {i} (prompt {len(p)} tokens) "
                     f"differs from eager_generate at token "
                     f"{first_difference(outs[i], want)}")
        out["storm"] = dict(programs=n, requests=EXACT_REQUESTS,
                            tokens_s=tokens / wall,
                            p50_ms=st["p50_us"] / 1e3,
                            p99_ms=st["p99_us"] / 1e3)
        print(f"11a: fp64: warm-up captured {n} programs; storm of the first "
              f"{EXACT_REQUESTS} prompts ({STORM_NEW} new, concurrency "
              f"{STORM_CONCURRENCY}): {tokens / wall:.1f} tokens/s, 0 "
              f"captures, one dispatch per iteration and prefill, every "
              f"request token-exact against eager_generate  ok")

        burst = np.random.RandomState(5).randint(
            0, model.vocab, size=BURST_PROMPT).tolist()
        base = telemetry.snapshot()
        p0 = eng.stats()["prefills"]
        first = eng.generate(list(burst), max_new_tokens=BURST_NEW)
        _w, _t, _s, bouts = lat.drive(eng, [list(burst)] * (BURST_USERS - 1),
                                      BURST_USERS - 1, BURST_NEW)
        delta = telemetry.delta(base)
        hits = delta.get("prefix.hit_blocks", 0)
        want = sd.eager_generate(model, params, burst, BURST_NEW)
        if not hits or any(o != want for o in [first] + bouts):
            fail(f"shared-prompt burst: {hits} hit blocks, token-exact "
                 f"{[o == want for o in [first] + bouts]}")
        out["burst"] = dict(users=BURST_USERS, prompt=BURST_PROMPT,
                            hit_blocks=hits,
                            miss_blocks=delta.get("prefix.miss_blocks", 0),
                            cow_forks=delta.get("prefix.cow_forks", 0),
                            prefills=eng.stats()["prefills"] - p0)
        print(f"11a: fp64 shared-prompt burst ({BURST_USERS} x "
              f"{BURST_PROMPT} tokens): {hits} hit blocks, "
              f"{out['burst']['miss_blocks']} missed, "
              f"{out['burst']['cow_forks']} copy-on-write forks, "
              f"{out['burst']['prefills']} prefill(s); token-exact  ok")
    finally:
        eng.close()
    if pool.in_use() or pool.audit():
        fail(f"fp64: {pool.in_use()} pages in use, audit {pool.audit()}")

    spec = sd.SamplingSpec(**SAMPLED)
    small = sd.PagePool(pages=PREEMPT_POOL_PAGES)
    peng = sd.GenerativeEngine(model, params=params, pool=small, max_rows=2,
                               name="preempt", device="cuda")
    try:
        rng = np.random.RandomState(9)
        pps = [rng.randint(0, model.vocab, size=PREEMPT_PROMPT).tolist()
               for _ in range(2)]
        c0 = sd.trace_count()
        _w, _t, sheds, pouts = lat.drive(peng, pps, 2, PREEMPT_NEW,
                                         sampling=spec)
        preempts = peng.stats()["preempts"]
        if sheds or not preempts:
            fail(f"forced preemption: {preempts} preemptions, {sheds} sheds")
        for i, p in enumerate(pps):
            want = sd.eager_generate(model, params, p, PREEMPT_NEW,
                                     sampling=spec)
            if pouts[i] != want:
                fail(f"sampled request {i} after {preempts} preemption(s) "
                     f"differs from eager_generate with {spec} at token "
                     f"{first_difference(pouts[i], want)}")
        if small.in_use() or small.audit():
            fail(f"small pool after the preemptions: {small.audit()}")
        out["preempt"] = dict(preempts=preempts, pages=PREEMPT_POOL_PAGES,
                              captures_in_scheduler=sd.trace_count() - c0)
        print(f"11a: fp64 seeded sampling ({spec}) on a "
              f"{PREEMPT_POOL_PAGES}-page pool: {preempts} preemption(s), "
              f"both requests replay the eager loop's tokens; "
              f"{sd.trace_count() - c0} programs captured lazily on the "
              f"scheduler thread  ok [{card_line}]")
    finally:
        peng.close()
    return out


def decode_timings(sd, lat, eng, card_line) -> dict:
    """11c: the decode step at 8 rows, captured (the program's copies,
    replay and output clone) against eager (the same body run op by op
    after the same copies): wall, device busy, host ms a call, idle share,
    peak memory; then the lane_decode A/B at full width (AB_REQUESTS
    prompts of STORM_PROMPT tokens, AB_NEW new, one at a time against
    STORM_CONCURRENCY threads, each pass from a cold prefix cache) with a
    trace of the continuous pass: tokens/s, batching speedup, p50/p99,
    the iteration's wall, device busy and idle share, graph launches
    against dispatches."""
    # greedy rows: the decode program's greedy form, as the engine runs them
    prog = eng._programs[("decode", "greedy")]
    body = eng._decode_fn("greedy")
    rng = np.random.RandomState(3)
    bufs = [b.clone() for b in eng._decode_host]
    tokens, tables, lengths, temps, top_ks, top_ps, seeds = \
        [b.numpy() for b in bufs]
    tokens[:] = rng.randint(0, eng._model.vocab, size=tokens.shape)
    # every row reads and writes the trash page only: the step's work is
    # that of real rows (the gather always fetches every table entry)
    tables[:] = eng._pool.trash
    lengths[:] = rng.randint(8, eng._model.max_seq - 1, size=lengths.shape)
    temps[:], top_ks[:], top_ps[:], seeds[:] = 0.0, 0, 1.0, 0

    def captured():
        return prog(*bufs)

    def eager():
        with torch.no_grad():
            return body(*[b.to("cuda", non_blocking=True) for b in bufs])

    with eng._pool.exclusive(eng._geom):
        step = capture_numbers("decode step, 8 rows, full width",
                               {"eager": eager, "captured": captured}, 0,
                               card_line)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, eng._model.vocab,
                           size=rng.randint(STORM_PROMPT[0],
                                            STORM_PROMPT[1] + 1)).tolist()
               for _ in range(AB_REQUESTS)]
    ab = lat.run_decode(concurrency=STORM_CONCURRENCY, new_tokens=AB_NEW,
                        prompts=prompts, engine=eng,
                        warmup_len=DECODE_WIDTH["max_seq"], profile=True)
    if ab["retraces_after_warm"]:
        fail(f"lane_decode A/B: {ab['retraces_after_warm']} captures after "
             "warm-up")
    if not ab["same_tokens_both_passes"]:
        fail("lane_decode A/B: one-at-a-time and continuous passes gave "
             "different tokens")
    bar = ab["batching_speedup"] >= lat.BARS["batching_speedup"]
    busy = ab.get("continuous_busy_ms")
    graphs = ab.get("continuous_graph_launches") or 0
    if graphs and graphs != ab["continuous_dispatches"]:
        fail(f"lane_decode A/B: {graphs} graph launches traced for "
             f"{ab['continuous_dispatches']} dispatches")
    steps = ab["continuous_decode_steps"]
    host_iter = (ab["continuous_iteration_ms"] - busy / steps
                 if busy else None)
    print(f"11c: lane_decode A/B at full width: one at a time "
          f"{ab['sequential_tokens_s']:.1f} tokens/s, continuous "
          f"(concurrency {STORM_CONCURRENCY}) {ab['continuous_tokens_s']:.1f}"
          f" tokens/s, batching speedup {ab['batching_speedup']:.2f} (bar "
          f">= {lat.BARS['batching_speedup']}: "
          f"{'met' if bar else 'NOT met'}), {ab['rows_per_decode']:.2f} rows"
          f" a decode step, p50 {ab['p50_us'] / 1e3:.1f} ms p99 "
          f"{ab['p99_us'] / 1e3:.1f} ms; the continuous pass: "
          f"{ab['continuous_iteration_ms']:.3f} ms wall an iteration, "
          + (f"device busy {busy:.1f} of {ab['continuous_wall_ms']:.1f} ms "
             f"(idle share {ab['continuous_idle_share']:.1%}), host "
             f"{host_iter:.3f} ms an iteration, "
             f"{ab['continuous_graph_launches']} graph launches for "
             f"{ab['continuous_dispatches']} dispatches"
             if busy else "the trace holds no device time")
          + f" [{card_line}]")
    return dict(step=step, ab=ab,
                host_ms_per_iteration=host_iter, batching_bar_met=bar)


def verify_rule(got, want) -> bool:
    return torch.equal(got, want) or torch.allclose(
        got, want, rtol=SERVE_VERIFY[0], atol=SERVE_VERIFY[1])


def oneshot_phase(serving, mx, net, make, what, card_line) -> dict:
    """11b: SERVE_REQUESTS requests of SERVE_ROWS rows from SERVE_THREADS
    threads through a ``ServingEngine`` (max batch SERVE_ROWS[1], its
    pow2 grid warmed), each output against its exact-shape eager forward
    on the card by the verify rule; programs <= buckets and 0 captures
    after warm-up where bucketing was accepted. Prints whether verify
    accepted or refused bucketing, and why."""
    rng = np.random.RandomState(0)
    reqs = [make(rng, int(n)) for n in
            rng.randint(SERVE_ROWS[0], SERVE_ROWS[1] + 1,
                        size=SERVE_REQUESTS)]
    outs = [None] * len(reqs)
    grid = pow2_grid(SERVE_ROWS[1])
    eng = serving.ServingEngine(net, max_batch=SERVE_ROWS[1],
                                max_delay_us=2000)
    try:
        n = eng.warmup(reqs[0], max_rows=SERVE_ROWS[1])
        if n != len(grid):
            fail(f"{what}: warm-up captured {n} programs, want {len(grid)}")
        t0, d0 = serving.trace_count(), serving.dispatch_count()
        errs = []

        def worker(k):
            def go():
                try:
                    for i in range(k, len(reqs), SERVE_THREADS):
                        outs[i] = eng.infer(reqs[i])
                except BaseException as e:
                    errs.append(e)
            return go

        ts = time.perf_counter()
        threads = [threading.Thread(target=worker(k))
                   for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - ts
        if errs or any(t.is_alive() for t in threads):
            fail(f"{what}: a request failed or hung: {errs[:1]}")
        st = eng.stats()
        captures = serving.trace_count() - t0
        for i, x in enumerate(reqs):
            got = outs[i]
            with torch.no_grad(), mx.autograd.pause():
                want = net.forward(x.cuda())
            if got.device.type != "cuda" or not verify_rule(got, want):
                fail(f"{what}: request {i} ({x.shape[0]} rows) differs from "
                     f"its eager forward beyond the verify rule (max |Δ| "
                     f"{(got.float() - want.float()).abs().max().item():.3e})")
        refused = eng.bucket_refused
        if refused is None and (captures or st["programs"] > len(grid)):
            fail(f"{what}: {captures} captures after warm-up, "
                 f"{st['programs']} programs for {len(grid)} buckets")
        verdict = ("accepted" + (f" ({st['verify_ulp_accepts']} last-ulp "
                                 "accepts)" if st["verify_ulp_accepts"]
                                 else " (bit-exact)")
                   if refused is None else f"REFUSED: {refused}")
        print(f"11b: {what}: {SERVE_REQUESTS} requests of {SERVE_ROWS[0]}-"
              f"{SERVE_ROWS[1]} rows from {SERVE_THREADS} threads in "
              f"{wall:.2f} s: {st['batches']} dispatches, "
              f"{st['coalesced']} coalesced, {st['programs']} programs for "
              f"{len(grid)} buckets, {captures} captures after warm-up, "
              f"p50 {st['p50_us'] / 1e3:.2f} ms p99 "
              f"{st['p99_us'] / 1e3:.2f} ms; each output its eager "
              f"forward's by the verify rule; bucketing {verdict} "
              f"[{card_line}]")
        return dict(requests=SERVE_REQUESTS, wall_s=wall,
                    batches=st["batches"], coalesced=st["coalesced"],
                    programs=st["programs"], buckets=len(grid),
                    captures_after_warmup=captures,
                    p50_ms=st["p50_us"] / 1e3, p99_ms=st["p99_us"] / 1e3,
                    verify_runs=st["verify_runs"],
                    verify_ulp_accepts=st["verify_ulp_accepts"],
                    bucket_refused=refused)
    finally:
        eng.close()


def lanes_phase(lat, card_line) -> dict:
    """11d: the serving lanes' own workers at their own widths
    (``tools/torch_serving_latency.py``): the lane_infer stream (64
    requests of 1-32 rows of the 64-wide MLP, sequential then from 4
    threads), the two-model storm (solo and co-hosted p99, sheds) and the
    shared-prefix lane (16 users of one 32-token prompt, warm and cold).
    Gated: 0 captures after warm-up and programs <= buckets where
    bucketing was accepted, the prefix lane token-exact with its counters
    still at 0 when the cache is off, no page leaked by the storm; the
    lanes' timing bars are printed."""
    serve = lat.run_serving(device="cuda")
    storm = lat.run_storm("cuda")
    prefix = lat.run_shared_prefix(device="cuda")
    if serve["bucket_refused"] is None and (
            serve["retraces_after_warm"]
            or serve["programs"] > serve["warmup_programs"]):
        fail(f"lane_infer: {serve['retraces_after_warm']} captures after "
             f"warm-up, {serve['programs']} programs for "
             f"{serve['warmup_programs']} buckets")
    if not prefix["token_exact"] or prefix["prefix_counters_off"]:
        fail(f"shared-prefix lane: token-exact {prefix['token_exact']}, "
             f"counters with the cache off {prefix['prefix_counters_off']}")
    if storm["pool_in_use_after"] or storm["pool_audit"]:
        fail(f"storm lane: {storm['pool_in_use_after']} pages in use, "
             f"audit {storm['pool_audit']}")
    missed = lat.check_bars(serve=serve, storm=storm, prefix=prefix)
    print(f"11d: lane_infer: p50 {serve['p50_us'] / 1e3:.3f} ms p99 "
          f"{serve['p99_us'] / 1e3:.3f} ms, {serve['throughput_rps']:.1f} "
          f"requests/s, {serve['programs']} programs, "
          f"{serve['retraces_after_warm']} captures after warm-up, from 4 "
          f"threads {serve['concurrent']['requests_per_dispatch']:.2f} "
          f"requests a dispatch and p99 "
          f"{serve['concurrent']['p99_us'] / 1e3:.3f} ms; storm: fast p99 "
          f"{storm['fast']['p99_us'] / 1e3:.2f} ms solo "
          f"{storm['fast_solo_p99_us'] / 1e3:.2f} ms (ratio "
          f"{storm['interference_p99_ratio']:.2f}), {storm['shed_total']} "
          f"shed; shared prefix: hit rate {prefix['prefix_hit_rate']:.4f}, "
          f"{prefix['prefills_warm']} against {prefix['prefills_cold']} "
          f"prefills, {prefix['warm_tokens_s']:.1f} against "
          f"{prefix['cold_tokens_s']:.1f} tokens/s, token-exact; lane bars "
          f"missed: {missed or 'none'} [{card_line}]")
    return dict(lane_infer=serve, storm=storm, shared_prefix=prefix,
                bars_missed=missed)


def oneshot_nets_phase(serving, mx, card_line) -> dict:
    """11b: the lane_infer MLP, then ResNet-50 v1 (NHWC, 224², predict
    mode, hybridized) in fp32 and in bf16."""
    from tools import torch_serving_latency as lat

    out = {}
    mlp = lat.lane_mlp(64, "cuda")
    out["mlp"] = oneshot_phase(
        serving, mx, mlp,
        lambda rng, n: torch.from_numpy(rng.randn(n, 64).astype(np.float32)),
        "lane_infer MLP", card_line)
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        probe = torch.zeros(2, SERVE_IMAGE, SERVE_IMAGE, 3, device="cuda")
        net = resnet50(mx, probe)
        if dtype is torch.bfloat16:
            net.cast("bfloat16")
        net.hybridize()

        def make(rng, n, dtype=dtype):
            return torch.from_numpy(rng.randn(
                n, SERVE_IMAGE, SERVE_IMAGE, 3).astype(np.float32)).to(dtype)

        out[f"resnet50_{name}"] = oneshot_phase(
            serving, mx, net, make, f"ResNet-50 {name}", card_line)
        del net
        torch.cuda.empty_cache()
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


# -- 12. speculative decoding ------------------------------------------------
def decode_params_to(params, *to):
    """A decode-parameter dict with every tensor ``.to(*to)``."""
    return {k: (v.to(*to) if k != "layers" else
                [{n: w.to(*to) for n, w in lp.items()} for lp in v])
            for k, v in params.items()}


def spec_prompts(vocab):
    rng = np.random.RandomState(12)
    return [rng.randint(0, vocab, size=rng.randint(SPEC_PROMPT[0],
                                                   SPEC_PROMPT[1] + 1)
                        ).tolist() for _ in range(SPEC_REQUESTS)]


def spec_engine(sd, model, params, name, draft=None, dparams=None,
                device="cuda", warm=True):
    """A decode engine on a pool of its own (SPEC_POOL pages of 16), spec
    at SPEC_K when given a draft, warmed over prompts up to SPEC_WARM."""
    pool = sd.PagePool(pages=SPEC_POOL, page=16)
    kw = dict(draft=draft, draft_params=dparams, spec_k=SPEC_K) \
        if draft is not None else {}
    eng = sd.GenerativeEngine(model, params=params, pool=pool,
                              max_rows=SPEC_ROWS, name=name, device=device,
                              **kw)
    if warm:
        eng.warmup(max_len=SPEC_WARM)
    return eng, pool


def spec_pass(sd, lat, eng, pool, prompts, what, sampling=None):
    """The prompts from one client thread each through ``eng``: (wall s,
    tokens, outputs, stats); gated: no shed, 0 captures after warm-up, no
    page leaked after the drain, a clean audit."""
    c0 = sd.trace_count() + sd.spec_trace_count()
    wall, tokens, sheds, outs = lat.drive(eng, prompts, len(prompts),
                                          SPEC_NEW, sampling=sampling)
    eng.drain()
    captures = sd.trace_count() + sd.spec_trace_count() - c0
    if sheds or captures:
        fail(f"{what}: {sheds} sheds, {captures} captures after warm-up")
    if pool.in_use() or pool.audit():
        fail(f"{what}: {pool.in_use()} pages in use after the drain, audit "
             f"{pool.audit()}")
    return wall, tokens, outs, eng.stats()


def spec_program_numbers(sd, eng, card_line) -> dict:
    """The captured draft round (kmax = SPEC_K) and verify (k = SPEC_K) of
    ``eng``, replayed on inputs of SPEC_ROWS live rows at SAMPLED's
    arguments whose tables all point at the trash page (the work of real
    rows: the gather fetches every table entry): wall, device busy, host
    ms a call, idle share."""
    r, trash, v = eng._rows, eng._pool.trash, eng._model.vocab
    rng = np.random.RandomState(3)
    lengths = torch.from_numpy(rng.randint(
        8, eng._model.max_seq - SPEC_K - 2, size=r))
    toks = torch.from_numpy(rng.randint(0, v, size=r))
    samp = [torch.full((r,), SAMPLED["temperature"]),
            torch.full((r,), SAMPLED["top_k"]),
            torch.full((r,), SAMPLED["top_p"]),
            torch.full((r,), SAMPLED["seed"])]
    dtables = torch.full((r, eng._draft_max_pages), trash, dtype=torch.long)
    tables = torch.full((r, eng._max_pages), trash, dtype=torch.long)
    drec = eng._spec_programs[("draft_round", SPEC_K, "full")]
    vrec = eng._spec_programs[("verify", SPEC_K, "full")]
    dargs = [toks, torch.zeros(r, dtype=torch.bool), toks, dtables,
             lengths, *samp]
    props, q_dist = drec(*dargs)
    vargs = [toks, props, tables, lengths, q_dist, *samp]
    out = {"device_ops_a_call": form_device_ops(
        sd, eng, toks, lengths, dtables, tables, samp)}
    with eng._pool.exclusive(eng._draft_geom):
        out["draft_round"] = mode_numbers(
            f"12: captured draft round, kmax {SPEC_K}, {r} rows", "captured",
            lambda: drec(*dargs), 0, card_line)
    with eng._pool.exclusive(eng._geom):
        out["verify"] = mode_numbers(
            f"12: captured verify, k {SPEC_K}, {r} rows", "captured",
            lambda: vrec(*vargs), 0, card_line)
    return out


def device_ops(fn) -> int:
    """The device operations (kernels and copies) one call of ``fn`` runs,
    from a profiler trace of a call after a warm one."""
    from torch.profiler import ProfilerActivity, profile as trace_
    fn()
    torch.cuda.synchronize()
    with trace_(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_SETTLE_S)
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def form_device_ops(sd, eng, toks, lengths, dtables, tables, samp) -> dict:
    """The device operations a replay of each sampler form's decode,
    draft-round and verify program runs (``serving_decode.FORMS``: the
    greedy form takes no sampling arguments)."""
    r = toks.shape[0]
    rows = {"greedy": None, "full": samp}
    out = {}
    for form in sd.FORMS:
        args = rows[form] or []
        drec = eng._spec_programs[("draft_round", SPEC_K, form)]
        vrec = eng._spec_programs[("verify", SPEC_K, form)]
        prec = eng._programs[("decode", form)]
        dargs = [toks, torch.zeros(r, dtype=torch.bool), toks, dtables,
                 lengths, *args]
        drafted = drec(*dargs)
        vargs = [toks, drafted[0], tables, lengths]
        if form != "greedy":
            vargs += [drafted[1], *args]
        # the decode program takes the sampling arguments in every form
        pargs = [toks, tables, lengths, *(args or [
            torch.zeros(r), torch.zeros(r, dtype=torch.long), torch.ones(r),
            torch.zeros(r, dtype=torch.long)])]
        with eng._pool.exclusive(eng._draft_geom):
            d = device_ops(lambda: drec(*dargs))
        with eng._pool.exclusive(eng._geom):
            v = device_ops(lambda: vrec(*vargs))
            p = device_ops(lambda: prec(*pargs))
        out[form] = {"decode": p, "draft_round": d, "verify": v}
        print(f"12: device operations a replay, {form} form, {r} rows: "
              f"decode {p}, draft round (kmax {SPEC_K}) {d}, verify (k "
              f"{SPEC_K}) {v}")
    return out


def spec_phase(sd, lat, ck, card_line) -> dict:
    """Phase 12: speculative decoding at the flagship widths
    (``high_agreement_pair`` at SPEC_WIDTH: a 12-layer target whose layers
    2-12 are the identity, a 1-layer draft sharing its first layer; a
    low-agreement draft drawn on its own). Gated: in fp64 the greedy
    speculative streams (the high-agreement draft, and the low-agreement
    one, which must auto-disable) token-exact against the non-spec
    engine on the same weights; a seeded sampled request on the card
    replaying the same engine on the CPU seed for seed; in fp32 both legs'
    greedy streams token-exact against the non-spec engine (the target has
    one live layer, so the fp32 rounding that leaves the eager loop at
    these widths in phase 11 cannot reach it) and acceptance >= 0.7 on
    the high-agreement leg; 0 captures after warm-up and no page leaked on
    every leg. Printed: tokens/s spec against baseline, the captured
    draft-round and verify programs' walls and device busy, the launch
    counts by kernel (no TPU kernel's port lies on this path), peak
    memory; then the reference's --speculative lane
    (``tools/torch_serving_latency.py``) with its bars printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    target, tp, draft, dp = sd.high_agreement_pair(device="cuda",
                                                   **SPEC_WIDTH)
    low = sd.TinyCausalLM(vocab=SPEC_WIDTH["vocab"],
                          d_model=SPEC_WIDTH["d_model"], n_layers=1,
                          n_heads=SPEC_WIDTH["n_heads"],
                          max_seq=SPEC_WIDTH["max_seq"])
    lp = low.init_params(99, device="cuda")
    prompts = spec_prompts(target.vocab)
    out = {"width": SPEC_WIDTH, "requests": SPEC_REQUESTS,
           "new_tokens": SPEC_NEW, "k": SPEC_K, "rows": SPEC_ROWS}
    prev = os.environ.get("MXNET_SPEC_DECODE")
    os.environ["MXNET_SPEC_DECODE"] = "1"
    try:
        # -- fp64: the gates on tokens -------------------------------------
        tp64, dp64, lp64 = (decode_params_to(p, torch.float64)
                            for p in (tp, dp, lp))
        plain, ppool = spec_engine(sd, target, tp64, "spec_plain64")
        try:
            _w, _t, want, _st = spec_pass(sd, lat, plain, ppool, prompts,
                                          "12: fp64 non-spec engine")
        finally:
            plain.close()
        for name, d, dparams in (("high", draft, dp64), ("low", low, lp64)):
            eng, pool = spec_engine(sd, target, tp64, f"spec_{name}64", d,
                                    dparams)
            try:
                _w, _t, got, st = spec_pass(sd, lat, eng, pool, prompts,
                                            f"12: fp64 {name}-agreement "
                                            "spec engine")
            finally:
                eng.close()
            for i, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    fail(f"12: fp64 {name}-agreement spec request {i} "
                         f"differs from the non-spec engine at token "
                         f"{first_difference(a, b)}")
            if not st["spec_rounds"] or (name == "low") != \
                    st["spec_disabled"]:
                fail(f"12: fp64 {name}-agreement leg: {st['spec_rounds']} "
                     f"rounds, disabled {st['spec_disabled']}")
            out[f"fp64_{name}"] = {k: st[k] for k in (
                "spec_rounds", "spec_proposed", "spec_accepted",
                "spec_fallbacks", "spec_disabled", "decode_steps")}
            print(f"12: fp64 {name}-agreement spec engine: {SPEC_REQUESTS} "
                  f"greedy requests token-exact against the non-spec "
                  f"engine; {st['spec_rounds']} rounds, "
                  f"{st['spec_accepted']} of {st['spec_proposed']} "
                  f"proposals accepted, {st['decode_steps']} plain decode "
                  f"steps, auto-disabled {st['spec_disabled']}  ok")
        # a seeded sampled request on the card and the same engine on the
        # CPU (fresh engines, one request: the same round schedule)
        spec = sd.SamplingSpec(**SAMPLED)
        outs = {}
        for where, dev in (("card", "cuda"), ("host", "cpu")):
            eng, pool = spec_engine(sd, target,
                                    decode_params_to(tp64, dev),
                                    f"spec_{where}", draft,
                                    decode_params_to(dp64, dev),
                                    device=dev, warm=where == "card")
            try:
                outs[where] = eng.generate(prompts[0],
                                           max_new_tokens=SPEC_NEW,
                                           sampling=spec)
                outs[where + "_rounds"] = eng.stats()["spec_rounds"]
            finally:
                eng.close()
        if outs["card"] != outs["host"] or not outs["card_rounds"]:
            fail(f"12: sampled spec request ({spec}) on the card differs "
                 f"from the CPU's at token "
                 f"{first_difference(outs['card'], outs['host'])} "
                 f"({outs['card_rounds']} / {outs['host_rounds']} rounds)")
        out["sampled"] = dict(spec=str(spec), rounds=outs["card_rounds"],
                              tokens=outs["card"])
        print(f"12: fp64 seeded sampled spec request ({spec}): "
              f"{outs['card_rounds']} rounds on the card, the same "
              f"{SPEC_NEW} tokens as the same engine on the CPU  ok")
        del tp64, dp64, lp64

        # -- fp32: acceptance, throughput, the programs ----------------------
        ck.reset_launch_counts()
        base, bpool = spec_engine(sd, target, tp, "spec_base32")
        try:
            bwall, btok, bouts, bst = spec_pass(sd, lat, base, bpool,
                                                prompts, "12: fp32 baseline")
        finally:
            base.close()
        legs = {}
        for name, d, dparams in (("low", low, lp), ("high", draft, dp)):
            eng, pool = spec_engine(sd, target, tp, f"spec_{name}32", d,
                                    dparams)
            try:
                wall, tok, outs32, st = spec_pass(
                    sd, lat, eng, pool, prompts,
                    f"12: fp32 {name}-agreement spec engine")
                if name == "high":
                    programs = spec_program_numbers(sd, eng, card_line)
            finally:
                eng.close()
            agree = sum(a == b for a, b in zip(outs32, bouts))
            legs[name] = dict(
                tokens_s=tok / wall, rounds=st["spec_rounds"],
                proposed=st["spec_proposed"], accepted=st["spec_accepted"],
                acceptance=st["spec_accepted"] / max(st["spec_proposed"],
                                                     1),
                fallbacks=st["spec_fallbacks"],
                disabled=st["spec_disabled"],
                decode_steps=st["decode_steps"],
                equal_to_non_spec=agree,
                first_differences={i: first_difference(a, b) for i, (a, b)
                                   in enumerate(zip(outs32, bouts))
                                   if a != b})
        torch.cuda.synchronize()
        counts = ck.launch_counts()
        hi, lo = legs["high"], legs["low"]
        if hi["acceptance"] < SPEC_MIN_ACCEPTANCE or hi["disabled"]:
            fail(f"12: fp32 high-agreement acceptance {hi['acceptance']:.4f}"
                 f" (bar >= {SPEC_MIN_ACCEPTANCE}), disabled "
                 f"{hi['disabled']}")
        if not lo["disabled"]:
            fail("12: the fp32 low-agreement draft never auto-disabled")
        for name, leg in legs.items():
            if leg["equal_to_non_spec"] != SPEC_REQUESTS:
                fail(f"12: fp32 {name}-agreement spec engine: "
                     f"{leg['equal_to_non_spec']} of {SPEC_REQUESTS} streams "
                     f"equal to the non-spec engine's (first differences "
                     f"{leg['first_differences']})")
        out["fp32"] = dict(baseline_tokens_s=btok / bwall, legs=legs,
                           speedup=hi["tokens_s"] / (btok / bwall),
                           programs=programs, launches=counts)
        print(f"12: fp32, {SPEC_REQUESTS} requests x {SPEC_NEW} tokens from "
              f"{SPEC_REQUESTS} threads, {SPEC_ROWS} rows: baseline "
              f"{btok / bwall:.1f} tokens/s; high-agreement spec "
              f"{hi['tokens_s']:.1f} tokens/s ({out['fp32']['speedup']:.2f}"
              f"x), acceptance {hi['acceptance']:.4f} (bar >= "
              f"{SPEC_MIN_ACCEPTANCE}), {hi['rounds']} rounds, "
              f"{hi['decode_steps']} plain steps; low-agreement "
              f"{lo['tokens_s']:.1f} tokens/s, auto-disabled after "
              f"{lo['rounds']} rounds ({lo['accepted']} of {lo['proposed']} "
              f"accepted) [{card_line}]")
        print(f"12: fp32 high- and low-agreement spec engines: "
              f"{SPEC_REQUESTS} greedy requests each token-exact against the "
              f"non-spec engine  ok")
        print(f"12: launch counts of the fp32 legs (no TPU kernel's port on "
              f"this path): {counts}")
        if any(counts.values()):
            fail(f"12: a TPU kernel's port launched on the spec path: "
                 f"{counts}")
    finally:
        if prev is None:
            os.environ.pop("MXNET_SPEC_DECODE", None)
        else:
            os.environ["MXNET_SPEC_DECODE"] = prev
    lane = lat.run_speculative(device="cuda")
    missed = lat.check_bars(spec=lane)
    out["lane"] = {k: v for k, v in lane.items()}
    out["lane"]["bars_missed"] = missed
    print(f"12: --speculative lane (reference widths, 12 requests x 24 "
          f"tokens, k 4, 2 rows): baseline {lane['baseline_tokens_s']:.1f} "
          f"tokens/s, spec {lane['spec_tokens_s']:.1f} "
          f"({lane['speedup']:.2f}x, bar >= 1.5), acceptance "
          f"{lane['acceptance']:.4f} (bar >= 0.7), token-exact "
          f"{lane['token_exact']}, draft round "
          f"{lane['draft_round_ms']:.3f} ms, verify {lane['verify_ms']:.3f} "
          f"ms, baseline decode step {lane['baseline_decode_step_ms']:.3f} "
          f"ms (cost-table EMAs, host included), low-agreement "
          f"{lane['low_agreement']['ratio_vs_baseline']:.2f}x baseline, "
          f"auto-disabled {lane['low_agreement']['autodisabled']}; bars "
          f"missed: {missed or 'none'} [{card_line}]")
    if not lane["token_exact"] or lane["captures_after_warm"]:
        fail(f"12: --speculative lane: token-exact {lane['token_exact']}, "
             f"{lane['captures_after_warm']} captures after warm-up")
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"12: peak memory {out['peak_gib']:.2f} GiB, {out['phase_s']:.1f} s")
    return out


# -- 14. the mesh of one --------------------------------------------------------
# the MXNET_SPMD_MESH forms of a mesh of one, the routes the kvstore step
# runs, and the steps of each run
MESH_SPECS = ("1", "dp=1,fsdp=1,tp=1")
MESH_ROUTES = ("conv_bn", "epilogue")
MESH_STEPS = 3


def mesh_world(phase="14"):
    """An NCCL world of this one process from a file store under the
    run's temporary directory, and one eager all-reduce before any
    capture. Returns ``torch.distributed``."""
    import tempfile

    import torch.distributed as dist
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="mxt_mesh_"), "store")
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
    t = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    if t.tolist() != [3.0] * 4:
        fail(f"{phase}: the first NCCL all-reduce of one rank gave "
             f"{t.tolist()}")
    print(f"{phase}: NCCL world of 1 rank ({dist.get_backend()}), first "
          f"all-reduce eager  ok")
    return dist


def collectives_phase(par, ps) -> dict:
    """Every collective over the one-rank groups of a (dp, fsdp, tp) mesh,
    eager and replayed from a capture (``program_store.capture``: an eager
    run on the side stream, then the capture; a second call on another
    input replays it), each bitwise its one-rank definition."""
    c = par.collectives
    P = par.PartitionSpec
    mesh = par.make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
    if mesh.device_mesh is None or mesh.device.type != "cuda":
        fail(f"14: the mesh of one is not over the NCCL world: {mesh}")
    same = (lambda t: t)
    cases = {
        "all_reduce_sum": (lambda t: c.all_reduce(t, "dp", mesh=mesh), same),
        "all_reduce_max": (lambda t: c.all_reduce(t, "fsdp", "max", mesh),
                           same),
        "all_reduce_min": (lambda t: c.all_reduce(t, "tp", "min", mesh),
                           same),
        "all_reduce_3_axes": (lambda t: c.all_reduce(
            t, ("dp", "fsdp", "tp"), mesh=mesh), same),
        "pmean": (lambda t: c.pmean(t, "dp", mesh), same),
        "all_gather": (lambda t: c.all_gather(t, "tp", axis=1, mesh=mesh),
                       same),
        "all_gather_stack": (lambda t: c.all_gather(t, "dp", tiled=False,
                                                    mesh=mesh),
                             lambda t: t[None]),
        "reduce_scatter": (lambda t: c.reduce_scatter(t, "fsdp", 0, mesh),
                           same),
        "all_to_all": (lambda t: c.all_to_all(t, "tp", 1, 0, mesh), same),
        "ppermute": (lambda t: c.ppermute(t, "dp", [(0, 0)], mesh), same),
        "ring_shift": (lambda t: c.ring_shift(t, "dp", mesh=mesh), same),
        "broadcast_from": (lambda t: c.broadcast_from(t, "dp", 0, mesh),
                           same),
        "run_sharded": (c.run_sharded(
            lambda t: c.all_reduce(t * 2.0, "dp") + c.axis_index("tp")
            + c.axis_size("fsdp"), mesh, (P("dp"),), P("dp")),
            lambda t: t * 2.0 + 1.0),
    }
    gen = torch.Generator(device="cuda").manual_seed(14)
    a = torch.randn(8, 16, device="cuda", generator=gen)
    b = torch.randn(8, 16, device="cuda", generator=gen)
    out = {}
    for name, (fn, want) in cases.items():
        eager = fn(a.clone())
        prog = ps.capture(fn)
        first = prog(a.clone())         # eager on the side stream, captured
        replay = prog(b.clone())        # a replay on another input
        torch.cuda.synchronize()
        for what, got, x in (("eager", eager, a), ("capture", first, a),
                             ("replay", replay, b)):
            w = want(x)
            if got.shape != w.shape or not torch.equal(got, w):
                fail(f"14: {name} {what} differs from its definition: "
                     f"{tuple(got.shape)} vs {tuple(w.shape)}, max "
                     f"{(got.float() - w.float()).abs().max().item()}")
        out[name] = "eager, captured and replayed bitwise"
    print(f"14: collectives over the mesh of one ({len(cases)} cases), "
          f"eager and replayed from a capture, bitwise their definitions  ok")
    return out


def mesh_step_phase(mx, par, cs, ck, resnet, config, card_line, counts,
                    traced_total) -> dict:
    """``Trainer(kvstore='nccl').compile_step`` on the bf16 ResNet-50 at
    batch RESNET_BATCH on each of MESH_ROUTES, MESH_STEPS captured steps
    under each of MESH_SPECS, held bitwise to the same steps without a
    kvstore (losses, parameters with the running statistics, momenta);
    launches a step and sites as the route's, 1 capture and 1 dispatch a
    step, 0 reshards; the captured step's device span with the mesh and
    without. The kvstore runs' launches add into ``counts`` and their
    traced replays into ``traced_total``."""
    spmd = par.spmd
    x, y = image_batch(RESNET_BATCH, torch.bfloat16)
    net = resnet50(mx, x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(n, a, b):
        return ce(n(a), b)

    def counters():
        return cs.trace_count(), cs.dispatch_count()

    set_compiled(config, True)
    numbers = {}
    prev = os.environ.get("MXNET_SPMD_MESH")
    try:
        for name in MESH_ROUTES:
            route = capture_route(config, name)
            want_launches, want_sites = route_gates(route)
            runs = {}
            for spec in (None,) + MESH_SPECS:
                what = (f"14: ResNet-50 bf16 b{RESNET_BATCH} compile_step, "
                        f"{name}, " + (f"kvstore='nccl', MXNET_SPMD_MESH="
                                       f"{spec}" if spec else "no kvstore"))
                os.environ["MXNET_SPMD_MESH"] = spec or "off"
                net.load_dict(init)
                net.zero_grad()
                trainer = mx.gluon.Trainer(
                    net.collect_params(), "sgd", dict(RESNET_OPT),
                    kvstore="nccl" if spec else "device")
                step = trainer.compile_step(net, loss_fn)
                spmd.reset_counters()
                c0 = ck.launch_counts()
                losses, counted, traced, _kept = run_traced_steps(
                    ck, resnet, what, lambda: step(x, y), MESH_STEPS, True,
                    want_sites, traced_total if spec else None, counters)
                check_step_launches(what, counted, traced, want_launches,
                                    True)
                if spec:
                    c1 = ck.launch_counts()
                    for k in c1:
                        counts[k] = counts.get(k, 0) + c1[k] - c0[k]
                    mesh = step.mesh
                    if mesh is None or mesh.size != 1 or \
                            mesh.device_mesh is None:
                        fail(f"{what}: mesh {mesh}")
                    if spmd.reshard_count():
                        fail(f"{what}: {spmd.reshard_count()} reshards")
                state = [p.data().clone()
                         for p in net.collect_params().values()]
                state += [s.clone() for s in trainer._init_states()]
                wall = event_ms(lambda: step(x, y))
                runs[spec] = (losses, state, wall)
                del trainer, step
                torch.cuda.empty_cache()
            la, sa, wa = runs[None]
            for spec in MESH_SPECS:
                lb, sb, wb = runs[spec]
                if not all(torch.equal(u, v) for u, v in zip(la, lb)) or \
                        not all(torch.equal(u, v) for u, v in zip(sa, sb)):
                    fail(f"14: {name}, MXNET_SPMD_MESH={spec}: losses or "
                         f"state after {MESH_STEPS} steps differ from the "
                         "steps without a kvstore")
            numbers[name] = {
                "captured_step_ms_no_kvstore": wa,
                **{f"captured_step_ms_mesh_{spec}": runs[spec][2]
                   for spec in MESH_SPECS},
                "losses": [v.item() for v in la]}
            print(f"14: ResNet-50 bf16 b{RESNET_BATCH} compile_step, {name}: "
                  f"kvstore='nccl' on {', '.join(MESH_SPECS)} bitwise the "
                  f"steps without a kvstore over {MESH_STEPS} steps "
                  f"(losses, parameters and running statistics, momenta); "
                  f"launches a step {want_launches}, 1 capture, 1 dispatch "
                  f"a step, 0 reshards; captured step (event span) "
                  f"{wa:.3f} ms without, " + ", ".join(
                      f"{runs[sp][2]:.3f} ms on {sp}" for sp in MESH_SPECS)
                  + f" [{card_line}]  ok")
    finally:
        if prev is None:
            os.environ.pop("MXNET_SPMD_MESH", None)
        else:
            os.environ["MXNET_SPMD_MESH"] = prev
        capture_route(config, "unfused")
    return numbers


def mesh_plan_phase(mx, par, ps, ck, resnet, config, card_line, counts,
                    traced_total) -> dict:
    """``ShardedTrainer`` with ``fsdp_plan()`` and
    ``tensor_parallel_plan()`` over the mesh of one, bf16 compute and fp32
    masters, the conv + BN route, MESH_STEPS captured steps: bitwise the
    plan-less ShardedTrainer on the same mesh; launches a step as the
    route's, 1 capture and 1 dispatch a step."""
    ns = ps.namespace("sharded_step")
    x, y = image_batch(RESNET_BATCH, torch.float32)
    y = y.to(torch.int32)
    net = resnet50(mx, x[:2])
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mesh = par.make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
    route = capture_route(config, "conv_bn")
    want_launches, want_sites = route_gates(route)
    set_compiled(config, True)
    runs = {}
    for name, plan in (("none", None), ("fsdp_plan", par.fsdp_plan()),
                       ("tensor_parallel_plan",
                        par.tensor_parallel_plan())):
        what = f"14: ResNet-50 ShardedTrainer over the mesh of one, {name}"
        net.load_dict(init)
        tr = par.ShardedTrainer(
            net, lambda o, lab: ce(o, lab).mean(), mesh, plan=plan,
            optimizer="sgd",
            optimizer_params={"lr": RESNET_LR, "momentum": 0.9, "wd": 1e-4},
            compute_dtype=torch.bfloat16)
        c0 = ck.launch_counts()
        losses, counted, traced, _ = run_traced_steps(
            ck, resnet, what, lambda: tr.step(x, y, sync=False), MESH_STEPS,
            True, want_sites, traced_total if plan else None,
            lambda: (ns.traces, ns.dispatches))
        check_step_launches(what, counted, traced, want_launches, True)
        if plan is not None:
            c1 = ck.launch_counts()
            for k in c1:
                counts[k] = counts.get(k, 0) + c1[k] - c0[k]
        state = list(tr.full_params().values()) + \
            [s for st in tr.full_opt_state().values() for s in st]
        runs[name] = (losses, state)
        del tr
        torch.cuda.empty_cache()
    la, sa = runs["none"]
    for name in ("fsdp_plan", "tensor_parallel_plan"):
        lb, sb = runs[name]
        if not all(torch.equal(u, v) for u, v in zip(la, lb)) or \
                not all(torch.equal(u, v) for u, v in zip(sa, sb)):
            fail(f"14: ShardedTrainer {name} over the mesh of one differs "
                 "from the plan-less one")
    capture_route(config, "unfused")
    print(f"14: ResNet-50 ShardedTrainer bf16 compute over the mesh of one, "
          f"conv_bn: fsdp_plan() and tensor_parallel_plan() bitwise the "
          f"plan-less trainer over {MESH_STEPS} steps (losses, masters with "
          f"the running statistics, momenta); launches a step "
          f"{want_launches}, 1 capture, 1 dispatch a step [{card_line}]  ok")
    return {"losses": [v.item() for v in la],
            "plans": ["fsdp_plan", "tensor_parallel_plan"]}


def mesh_phase(mx, ps, cs, ck, resnet, config, card_line, counts,
               traced_total) -> dict:
    """Phase 14 (see the module docstring)."""
    t0 = time.perf_counter()
    par = port_parallel()
    dist = mesh_world()
    try:
        out = {"collectives": collectives_phase(par, ps),
               "kvstore_step": mesh_step_phase(
                   mx, par, cs, ck, resnet, config, card_line, counts,
                   traced_total),
               "sharded_trainer_plans": mesh_plan_phase(
                   mx, par, ps, ck, resnet, config, card_line, counts,
                   traced_total)}
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    out["multi_gpu"] = "not run: one card"
    print(f"14: the mesh of one took {out['phase_s']:.1f} s")
    return out


# -- 13. the mixture-of-experts LM --------------------------------------------
def moe_config(models):
    return dataclasses.replace(bert_base(models), num_experts=MOE_EXPERTS,
                               moe_top_k=MOE_TOP_K,
                               capacity_factor=MOE_CAPACITY)


def drop_share(models, cfg, params, tokens) -> list:
    """Per layer, the share of the (token, choice) assignments a forward
    drops at the experts' capacity."""
    from mxnet_tpu_torch.parallel import moe as moe_mod

    orig, shares = moe_mod.top_k_gating, []

    def counting(x, gate_w, **kw):
        d, c, a = orig(x, gate_w, **kw)
        shares.append(1.0 - d.float().sum() / (x.shape[0] * x.shape[1]
                                               * kw["k"]))
        return d, c, a

    moe_mod.top_k_gating = counting
    try:
        with torch.no_grad():
            models.forward(params, tokens, cfg)
    finally:
        moe_mod.top_k_gating = orig
    return [float(s) for s in shares]


def moe_steps(ck, step, state, tokens, labels, t_first, n, captured,
              total):
    """n steps from step number t_first on ``state`` (params, m, v):
    (losses, counted launches of each step, launches traced in each
    replay, None for an eager or a capturing step)."""
    p, m, v = state
    losses, counted, traced = [], [], []
    for t in range(t_first, t_first + n):
        def call():
            return step(p, m, v, tokens, labels, t)
        (_p, _m, _v, loss), c, tr = traced_launches(
            ck, call, trace=captured and t != 1, total=total)
        losses.append(loss.clone())
        counted.append(c)
        traced.append(tr)
    return losses, counted, traced


def moe_phase(models, cs, ck, config, card_line, counts,
              traced_total) -> dict:
    """Phase 13: the MoE LM train step at BERT-base width (12 x 768, MLP
    3072, 12 heads, vocab 30528, bf16) with MOE_EXPERTS experts, top
    MOE_TOP_K, capacity factor MOE_CAPACITY, Adam at TRAIN_LR on a fixed
    batch of TRAIN_TOKENS, at grad_accum 1 and 2: two eager runs
    (MXNET_COMPILED_STEP=0) of MOE_EAGER_STEPS steps and one captured run,
    whose first MOE_EAGER_STEPS steps (losses, params, moments) are held
    to the eager ones by phase 8's rule and which goes on to
    MOE_CAPTURED_STEPS; gated: 1 capture and 1 dispatch a step, the flash
    kernels' launches each eager step counted by the wrappers, and each
    replay's traced by kernel name (check_step_launches), finite losses
    that fall, no flash fallback. The launches of these runs alone, counted
    by the wrappers and traced in the replays, are added into ``counts``
    and ``traced_total`` and their sums gated: the capacity-drop forwards
    and the timing loops are in neither. Printed: eager against captured
    wall, device busy and peak memory, the capacity-drop share per layer at
    init and after the steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = moe_config(models)
    L = cfg.num_layers

    def init():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return models.init_params(cfg, gen, device="cuda")

    params = init()
    n_params = sum(t.numel() for t in params.values())
    rng = np.random.RandomState(13)
    tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
    out = {"n_params": n_params, "experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
           "capacity_factor": MOE_CAPACITY,
           "drop_share_init": drop_share(models, cfg, params, tokens)}
    del params
    fallback0 = models.flash_fallback_count()
    # each run's launches the wrappers count: every eager step's, and the
    # captured run's first call twice (its eager run and its capture)
    want_counts = {k: 0 for k in TRAIN_KERNELS}
    want_traced = dict(want_counts)
    for accum in (1, 2):
        want = {k: accum * L for k in TRAIN_KERNELS}
        for k in TRAIN_KERNELS:
            want_counts[k] += (2 * MOE_EAGER_STEPS + 2) * want[k]
            want_traced[k] += (MOE_CAPTURED_STEPS - 1) * want[k]
        runs = []
        for capture in (False, False, True):
            set_compiled(config, capture)
            step = models.make_train_step(cfg, lr=TRAIN_LR, grad_accum=accum)
            p = init()
            m, v = models.init_opt_state(p)
            t0, d0 = cs.trace_count(), cs.dispatch_count()
            losses, counted, traced = moe_steps(
                ck, step, (p, m, v), tokens, labels, 1, MOE_EAGER_STEPS,
                capture, traced_total if capture else None)
            state = [x.clone() for d in (p, m, v) for x in d.values()]
            if capture:
                more, c2, t2 = moe_steps(
                    ck, step, (p, m, v), tokens, labels,
                    MOE_EAGER_STEPS + 1,
                    MOE_CAPTURED_STEPS - MOE_EAGER_STEPS, True,
                    traced_total)
                losses_all = losses + more
                counted, traced = counted + c2, traced + t2
                n = MOE_CAPTURED_STEPS
                out[f"drop_share_after_accum{accum}"] = drop_share(
                    models, cfg, p, tokens)
            else:
                n = MOE_EAGER_STEPS
            for c in counted:
                for k, cnt in c.items():
                    counts[k] = counts.get(k, 0) + cnt
            got = (cs.trace_count() - t0, cs.dispatch_count() - d0)
            if got != ((1, n) if capture else (0, 0)):
                fail(f"13: MoE step accum {accum}, capture={capture}: "
                     f"(captures, dispatches) {got} over {n} steps")
            what = f"13: MoE step accum {accum}, capture={capture}"
            if capture:
                check_step_launches(what, counted, traced, want, True)
            elif any(c != want for c in counted):
                # an eager step's launches are the wrappers' own count
                # (a trace of a 3500-kernel eager step lost a record once)
                fail(f"{what}: counted launches {counted}, want {want} a "
                     f"step")
            runs.append((losses, state))
            del p, m, v, step
        (la, sa), (lb, sb), (lc, sc) = runs
        rule = hold_captured(f"13: MoE step accum {accum} losses", la, lb,
                             lc)
        hold_captured(f"13: MoE step accum {accum} params and moments "
                      f"after {MOE_EAGER_STEPS} steps", sa, sb, sc)
        vals = [x.item() for x in losses_all]
        if not all(math.isfinite(x) for x in vals) or \
                not vals[-1] < vals[0]:
            fail(f"13: MoE step accum {accum}: losses {vals} not finite "
                 f"and falling")
        out[f"accum{accum}"] = dict(losses=vals, captured_vs_eager=rule,
                                    launches_per_step=want)
        print(f"13: MoE LM ({MOE_EXPERTS} experts, top {MOE_TOP_K}, "
              f"capacity factor {MOE_CAPACITY}) train step, grad_accum "
              f"{accum}, tokens {TRAIN_TOKENS}, Adam lr {TRAIN_LR}: "
              f"captured losses " + " ".join(f"{x:.6f}" for x in vals)
              + f"; 1 capture, 1 dispatch a step; flash launches a step "
              f"{want}  ok")
        del runs, sa, sb, sc, la, lb, lc
        torch.cuda.empty_cache()
    fallbacks = models.flash_fallback_count() - fallback0
    if fallbacks:
        fail(f"13: {fallbacks} flash fallbacks on the MoE path")
    if counts != want_counts or traced_total != want_traced:
        fail(f"13: the MoE runs' launches: counted {counts}, traced in the "
             f"replays {traced_total}; want {want_counts}, {want_traced}")
    fns, kept = {}, 0
    for mode in ("eager", "captured"):
        step = models.make_train_step(cfg, lr=TRAIN_LR)
        p = init()
        m, v = models.init_opt_state(p)
        state = [p, m, v, 1]

        def one(step=step, state=state, on=mode == "captured"):
            set_compiled(config, on)
            p_, m_, v_, t = state
            step(p_, m_, v_, tokens, labels, t)
            state[3] = t + 1

        if mode == "captured":
            _, kept = reserved_by(one)
        fns[mode] = one
    t0 = cs.trace_count()
    out["numbers"] = capture_numbers(
        f"13: MoE LM train step adam, tokens {TRAIN_TOKENS}", fns, kept,
        card_line)
    set_compiled(config, True)
    if cs.trace_count() != t0:
        fail("13: MoE LM train step: a capture after warm-up")
    del fns
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"13: MoE LM: {n_params / 1e6:.1f} M params; capacity-drop share "
          f"per layer at init {[round(x, 4) for x in out['drop_share_init']]}"
          f", after {MOE_CAPTURED_STEPS} steps (accum 1) "
          f"{[round(x, 4) for x in out['drop_share_after_accum1']]}; peak "
          f"memory {out['peak_gib']:.2f} GiB; {out['phase_s']:.1f} s "
          f"[{card_line}]")
    return out


# -- 15. the LM on a mesh --------------------------------------------------
MESH_LM_AXES = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "ep": 1}
MESH_LM_STEPS = 3          # steps of each plain and mesh run, captured
PP_AXES = {"pp": 1, "dp": 1}
PP_MICRO = (2, 4)          # micro-batches of the pp runs
PP_STEPS = 4               # pp steps against the plain step


def mesh_lm_runs(models, cs, ck, cfg, opt, mesh, tokens, labels, counts,
                 traced_total) -> dict:
    """The plain captured step and the captured step on ``mesh`` (its
    params and moments placed by ``sharding_plan``), MESH_LM_STEPS steps
    each from the same init, gated bitwise equal (losses, params,
    moments), 1 capture and 1 dispatch a step each, the mesh run's flash
    launches counted and traced (``check_step_launches``) and added into
    ``counts`` and ``traced_total``. The plain run is the yardstick, not
    the path: it is not traced."""
    L = cfg.num_layers
    plan = models.sharding_plan(cfg)
    runs = {}
    for which in ("plain", "mesh"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = models.init_params(cfg, gen, device="cuda")
        on = mesh if which == "mesh" else None
        if on is not None:
            p = plan.shard_tree(p, on)
        m, v = models.init_opt_state(p)
        if on is not None:
            m, v = plan.shard_tree(m, on), plan.shard_tree(v, on)
        step = models.make_train_step(cfg, on, optimizer=opt, lr=TRAIN_LR)
        t0, d0 = cs.trace_count(), cs.dispatch_count()
        losses, counted, traced = [], [], []
        for t in range(1, MESH_LM_STEPS + 1):
            (_p, _m, _v, loss), c, tr = traced_launches(
                ck, lambda: step(p, m, v, tokens, labels, t),
                trace=on is not None and t != 1, total=traced_total)
            losses.append(loss.clone())
            counted.append(c)
            traced.append(tr)
        what = f"15: {cfg.num_experts or 'dense'} {opt} step, {which}"
        got = (cs.trace_count() - t0, cs.dispatch_count() - d0)
        if got != (1, MESH_LM_STEPS):
            fail(f"{what}: (captures, dispatches) {got} over "
                 f"{MESH_LM_STEPS} steps")
        if on is not None:
            check_step_launches(what, counted, traced,
                                {k: L for k in TRAIN_KERNELS}, True)
            for c in counted:
                for k, n in c.items():
                    counts[k] = counts.get(k, 0) + n
        runs[which] = (losses, [x.clone() for d in (p, m, v)
                                for x in d.values()])
        del p, m, v, step
    (la, sa), (lb, sb) = runs["plain"], runs["mesh"]
    same = all(torch.equal(a, b) for a, b in zip(la + sa, lb + sb))
    vals = [x.item() for x in lb]
    if not same or not all(math.isfinite(x) for x in vals):
        fail(f"15: {opt} step on the mesh of one {mesh.shape} is not the "
             f"plain step bit for bit (losses {vals}, plain "
             f"{[x.item() for x in la]})")
    print(f"15: {'MoE' if cfg.num_experts else 'dense'} LM {opt} step on "
          f"the mesh of one {mesh.shape} with sharding_plan: "
          f"{MESH_LM_STEPS} captured steps bitwise the plain step's "
          f"(losses " + " ".join(f"{x:.6f}" for x in vals) + "), 1 "
          f"capture, 1 dispatch a step, flash launches a step "
          f"{ {k: L for k in TRAIN_KERNELS} }  ok")
    return {"losses": vals, "bitwise_plain": True}


def step_numbers(what, make_step, state0, tokens, labels, config,
                 card_line) -> dict:
    """Eager against captured numbers of one train step (``capture_numbers``
    over ``make_step()``'s step on a fresh copy of ``state0()`` each
    mode)."""
    fns, kept = {}, 0
    for mode in ("eager", "captured"):
        step = make_step()
        state = list(state0()) + [1]

        def one(step=step, state=state, on=mode == "captured"):
            set_compiled(config, on)
            p_, m_, v_, t = state
            step(p_, m_, v_, tokens, labels, t)
            state[3] = t + 1

        if mode == "captured":
            _, kept = reserved_by(one)
        fns[mode] = one
    out = capture_numbers(what, fns, kept, card_line)
    set_compiled(config, True)
    return out


def master_oracle(models, cfg, params0, tokens, labels):
    """The unpipelined Adam loop on fp32 master weights: the pp step's
    arithmetic (fp32 moments and weights, wd 0, the bf16 forward and
    backward of the weights cast to their dtypes) without the pipeline,
    its micro-batches or its tied copies. Returns (losses, master)."""
    master = {k: w.float().clone() for k, w in params0.items()}
    m = {k: torch.zeros_like(w) for k, w in master.items()}
    v = {k: torch.zeros_like(w) for k, w in master.items()}
    losses = []
    for t in range(1, PP_STEPS + 1):
        leaves = {k: w.to(params0[k].dtype).requires_grad_()
                  for k, w in master.items()}
        loss = models.loss_fn(leaves, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        lr_t = TRAIN_LR * math.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                g = g.float()
                m[k].mul_(0.9).add_(g * 0.1)
                v[k].mul_(0.999).add_(g.square() * 0.001)
                master[k] -= lr_t * m[k] / (v[k].sqrt() + 1e-8)
        losses.append(loss.item())
        del leaves, grads
    return losses, master


def pp_runs(models, cs, ck, cfg, mesh, n_micro, tokens, labels, counts,
            traced_total) -> dict:
    """``make_pp_pipeline`` at pp=1 with ``n_micro`` micro-batches through
    ``make_pp_train_step`` (Adam, captured, wd 0), PP_STEPS steps from
    the bf16 init, against (1) ``master_oracle``, the same arithmetic
    unpipelined: losses within TRAIN_LOSS_ATOL (the bound of flash against
    einsum) and every weight within PP_STEPS x (2 lr + one bf16 ulp of
    it), as an Adam update moves a weight by at most about lr and
    rounding can flip a near-zero gradient's sign; and (2) the plain step
    (Adam, captured, wd 0), which rounds its weights to bf16 each step
    where the packed buffer keeps fp32 ones: weights within the same
    bound, losses within the oracle's own distance from the plain step
    (the fp32-packing effect) plus TRAIN_LOSS_ATOL. Each step's flash
    launches (``n_micro`` x the layers of each kernel) counted and
    traced."""
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(cfg, gen, device="cuda")
    init = {k: w.clone() for k, w in params.items()}
    pipe = models.make_pp_pipeline(cfg, params, mesh,
                                   num_microbatches=n_micro,
                                   example_tokens=tokens)
    step = models.make_pp_train_step(pipe, optimizer="adam", lr=TRAIN_LR)
    packed = pipe.packed_params.clone()
    m, v = torch.zeros_like(packed), torch.zeros_like(packed)
    want = {k: n_micro * L for k in TRAIN_KERNELS}
    t0, d0 = cs.trace_count(), cs.dispatch_count()
    losses, counted, traced = [], [], []
    for t in range(1, PP_STEPS + 1):
        (_p, _m, _v, loss), c, tr = traced_launches(
            ck, lambda: step(packed, m, v, tokens, labels, t),
            trace=t != 1, total=traced_total)
        losses.append(loss.item())
        counted.append(c)
        traced.append(tr)
    what = f"15: pp=1 LM pipeline, {n_micro} micro-batches"
    got = (cs.trace_count() - t0, cs.dispatch_count() - d0)
    if got != (1, PP_STEPS):
        fail(f"{what}: (captures, dispatches) {got} over {PP_STEPS} steps")
    check_step_launches(what, counted, traced, want, True)
    for c in counted:
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
    stages = pipe.unpack_stage_params(packed)
    del pipe, step, m, v
    torch.cuda.empty_cache()
    oracle, master = master_oracle(models, cfg, init, tokens, labels)
    plain = models.make_train_step(cfg, optimizer="adam", lr=TRAIN_LR,
                                   wd=0.0)
    pm, vm = models.init_opt_state(params)
    base = [plain(params, pm, vm, tokens, labels, t)[3].item()
            for t in range(1, PP_STEPS + 1)]
    del plain, pm, vm

    def share(ref_of):
        worst = 0.0
        for part in stages:
            for name, w in part.items():
                ref = ref_of(name)
                lim = PP_STEPS * (2 * TRAIN_LR + Z_ULP[torch.bfloat16]
                                  * ref.float().abs())
                worst = max(worst, ((w.float() - ref.float()).abs() / lim)
                            .max().item())
        return worst

    def tied(name):
        return "embed.weight" if name == "head.weight" else name

    d_oracle = max(abs(a - b) for a, b in zip(losses, oracle))
    d_plain = max(abs(a - b) for a, b in zip(losses, base))
    packing = max(abs(a - b) for a, b in zip(oracle, base))
    w_oracle = share(lambda n: master[tied(n)])
    w_plain = share(lambda n: params[tied(n)])
    ok = (all(math.isfinite(x) for x in losses)
          and d_oracle <= TRAIN_LOSS_ATOL and w_oracle <= 1.0
          and d_plain <= packing + TRAIN_LOSS_ATOL and w_plain <= 1.0)
    line = (f"losses " + " ".join(f"{x:.6f}" for x in losses)
            + "; fp32-master oracle " + " ".join(f"{x:.6f}" for x in oracle)
            + f" (max |Δ| {d_oracle:.3e} <= {TRAIN_LOSS_ATOL}, weights at "
            f"{w_oracle:.3f} of their bound); plain bf16 step "
            + " ".join(f"{x:.6f}" for x in base) + f" (max |Δ| "
            f"{d_plain:.3e} <= the packing's {packing:.3e} + "
            f"{TRAIN_LOSS_ATOL}, weights at {w_plain:.3f} of their bound)")
    if not ok:
        fail(f"{what}: {line}")
    print(f"{what}, Adam lr {TRAIN_LR}: {PP_STEPS} captured steps, {line}; "
          f"1 capture, 1 dispatch a step, flash launches a step {want}  ok")
    del master, stages
    torch.cuda.empty_cache()
    return {"losses": losses, "oracle_losses": oracle, "plain_losses": base,
            "max_loss_diff_oracle": d_oracle, "max_loss_diff_plain": d_plain,
            "packing_loss_diff": packing, "weight_bound_share_oracle":
            w_oracle, "weight_bound_share_plain": w_plain,
            "launches_per_step": want}


def mesh_lm_phase(models, cs, ck, config, card_line, counts,
                  traced_total) -> dict:
    """Phase 15 (see the module docstring). Ring attention runs here at
    sp=1 only, against dense attention: a smoke check of the code on the
    card, not of the ring (a ring of more than one member needs more than
    one card)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    par = port_parallel()
    dist = mesh_world("15")
    out = {}
    try:
        mesh = par.make_mesh(MESH_LM_AXES)
        if mesh.device_mesh is None or mesh.device.type != "cuda":
            fail(f"15: the mesh of one is not over the NCCL world: {mesh}")
        cfg = bert_base(models)
        moe = moe_config(models)
        rng = np.random.RandomState(15)
        tokens, labels = batch(rng, cfg, *TRAIN_TOKENS)
        fallback0 = models.flash_fallback_count()
        for c, opts in ((cfg, ("adam", "lamb")), (moe, ("adam", "lamb"))):
            for opt in opts:
                key = f"{'moe' if c.num_experts else 'dense'}_{opt}"
                out[key] = mesh_lm_runs(models, cs, ck, c, opt, mesh,
                                        tokens, labels, counts, traced_total)
                torch.cuda.empty_cache()
        for c in (cfg, moe):
            key = f"{'moe' if c.num_experts else 'dense'}_adam"
            plan = models.sharding_plan(c)

            def state0(c=c, plan=plan):
                gen = torch.Generator(device="cuda").manual_seed(0)
                p = plan.shard_tree(models.init_params(c, gen,
                                                       device="cuda"), mesh)
                return (p,) + models.init_opt_state(p)

            out[key]["numbers"] = step_numbers(
                f"15: {key} LM step on the mesh of one, tokens "
                f"{TRAIN_TOKENS}", lambda c=c: models.make_train_step(
                    c, mesh, lr=TRAIN_LR), state0, tokens, labels, config,
                card_line)
            torch.cuda.empty_cache()
        pp_mesh = par.make_mesh(PP_AXES)
        for n_micro in PP_MICRO:
            key = f"pp1_micro{n_micro}"
            out[key] = pp_runs(models, cs, ck, cfg, pp_mesh, n_micro,
                               tokens, labels, counts, traced_total)
            torch.cuda.empty_cache()

            made = {}

            def make_pp(n_micro=n_micro, made=made):
                gen = torch.Generator(device="cuda").manual_seed(0)
                made["pipe"] = models.make_pp_pipeline(
                    cfg, models.init_params(cfg, gen, device="cuda"),
                    pp_mesh, num_microbatches=n_micro,
                    example_tokens=tokens)
                return models.make_pp_train_step(made["pipe"], lr=TRAIN_LR)

            def pp_state0(made=made):
                packed = made["pipe"].packed_params.clone()
                return packed, torch.zeros_like(packed), \
                    torch.zeros_like(packed)

            out[key]["numbers"] = step_numbers(
                f"15: pp=1 LM step, {n_micro} micro-batches, tokens "
                f"{TRAIN_TOKENS}", make_pp, pp_state0, tokens, labels,
                config, card_line)
            made.clear()
            torch.cuda.empty_cache()
        if models.flash_fallback_count() != fallback0:
            fail("15: a flash fallback on the mesh or pp path")
        # ring attention at sp=1: dense attention's numbers (smoke only)
        from mxnet_tpu_torch.parallel.ring_attention import ring_attention
        sp_mesh = par.make_mesh({"sp": 1})
        B, S = TRAIN_TOKENS
        q, k, v = attn_inputs(B * cfg.num_heads, S, cfg.head_dim,
                              torch.bfloat16, 15)
        q, k, v = (t.view(B, cfg.num_heads, S, cfg.head_dim)
                   for t in (q, k, v))
        got = ring_attention(q, k, v, "sp", mesh=sp_mesh).float()
        s_ = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            / math.sqrt(cfg.head_dim)
        want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s_, -1),
                            v.float())
        err = (got - want).abs().max().item()
        atol, rtol = OUT_TOL[torch.bfloat16]
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            fail(f"15: ring attention at sp=1 against dense: max |Δ| "
                 f"{err:.3e} (atol {atol}, rtol {rtol})")
        print(f"15: ring attention at sp=1 (smoke only) against dense "
              f"attention, bf16 ({B}, {cfg.num_heads}, {S}, "
              f"{cfg.head_dim}): max |Δ| {err:.3e}  ok")
        out["ring_sp1_max_abs_err"] = err
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    out["multi_gpu"] = "not run: one card"
    print(f"15: the LM on the mesh of one took {out['phase_s']:.1f} s, peak "
          f"memory {out['peak_gib']:.2f} GiB [{card_line}]")
    return out


# -- 16. the runtime around the step ------------------------------------------
RUNTIME_STEPS = 30         # steps of each loop of 16a
RUNTIME_DEPTH = 2          # engine.prefetch depth
RUNTIME_BATCHES = 4        # distinct numpy batches, cycled
RUNTIME_LOSS_RTOL = 1e-6   # loss metric, device against host accumulation
SENTINEL_EVERY, SENTINEL_STEPS = 4, 12
SENTINEL_RTOL = 1e-5       # parameter sum and gradient norm against the host
SENTINEL_OVERHEAD_EVERY, SENTINEL_OVERHEAD_STEPS = 20, 60
DRILL = {"steps": 12, "save_every": 4, "kill_at": 7}


def port_runtime():
    """(engine, metric, profiler, sentinel) of the port beside this file."""
    from mxnet_tpu_torch import engine, metric, profiler, sentinel
    return engine, metric, profiler, sentinel


def runtime_batches(n, classes=1000, device="cuda"):
    """n (x, y) host batches of RESNET_BATCH images from numpy seeds 100 +
    i: x bf16 NHWC and y fp32 labels, pinned where the card is used."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        x = torch.from_numpy(rng.randn(RESNET_BATCH, RESNET_IMAGE,
                                       RESNET_IMAGE, 3).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, classes, RESNET_BATCH)
                             .astype(np.float32))
        x = x.to(torch.bfloat16)
        if device == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        out.append((x, y))
    return out


def runtime_loss_fn(mx):
    """The step's loss: the fp32 per-sample cross entropy, and as a second
    head each sample's predicted class (fp32, exact) plus a zero times the
    logits' sum, so that its gradient adds exact zeros: the step returns
    the predictions beside the loss for ``Accuracy``."""
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(net, x, y):
        logits = net(x)
        pred = logits.argmax(-1).float() + 0.0 * logits.float().sum(-1)
        return ce(logits, y).float(), pred
    return loss_fn


def state_of(trainer, net):
    """Clones of every parameter (running statistics included) and
    momentum, in order."""
    tree = trainer.state_tree(net)
    return [t.detach().clone() for t in tree["params"].values()] + \
        [s.detach().clone() for s in tree["opt"].values()]


def reset_state(trainer, net, init):
    """Parameters back to ``init`` and momenta to 0, in place."""
    tree = trainer.state_tree(net)
    with torch.no_grad():
        for k, t in tree["params"].items():
            t.copy_(init[k])
        for s in tree["opt"].values():
            s.zero_()


def counters(mx, engine, metric):
    """The blocking host reads and synchronizations the port counts."""
    from mxnet_tpu_torch.ndarray import ndarray as ndmod
    return {"metric.host_sync": metric.host_sync_count(),
            "engine.host_sync": engine.sync_count(),
            "ndarray.host_sync": ndmod.host_sync_count()}


def delta(a, b):
    return {k: b[k] - a[k] for k in a}


def sync_loop(mx, rt, step, batches, device="cuda"):
    """16a's synchronous loop: each batch copied from pageable memory
    (blocking), the step dispatched, the metrics read on the host."""
    engine, metric, profiler, _s = rt
    os.environ["MXNET_METRIC_DEVICE"] = "0"
    loss_m, acc_m = metric.Loss(), metric.Accuracy()
    tl = profiler.StepTimeline("sync")
    pageable = [(x.clone(), y.clone()) for x, y in batches]
    engine.waitall()
    c0 = counters(mx, engine, metric)
    t0 = time.perf_counter()
    for i in range(RUNTIME_STEPS):
        hx, hy = pageable[i % len(pageable)]
        with tl.phase("h2d"):
            x, y = hx.to(device), hy.to(device)
        with tl.phase("dispatch"):
            loss, pred = step(x, y)
        with tl.phase("read"):
            loss_m.update(None, loss)
            acc_m.update([y], [pred])
        tl.step()
    engine.waitall()
    wall = time.perf_counter() - t0
    os.environ["MXNET_METRIC_DEVICE"] = "1"
    return {"wall_s": wall, "timeline": tl.summary(),
            "syncs": delta(c0, counters(mx, engine, metric)),
            "loss": loss_m.get()[1], "accuracy": acc_m.get()[1]}


def pipelined_loop(mx, rt, step, batches, device="cuda"):
    """16a's pipelined loop: ``engine.prefetch`` of the pinned batches,
    the metrics accumulated on the device and read once at ``.get()``.
    Returns its numbers and the port's counters over the steps alone."""
    engine, metric, profiler, _s = rt
    loss_m, acc_m = metric.Loss(), metric.Accuracy()
    tl = profiler.StepTimeline("pipelined")
    engine.waitall()
    source = (batches[i % len(batches)] for i in range(RUNTIME_STEPS))
    c0 = counters(mx, engine, metric)
    t0 = time.perf_counter()
    pf = engine.prefetch(source, depth=RUNTIME_DEPTH, device=device)
    it = iter(pf)
    for _ in range(RUNTIME_STEPS):
        with tl.phase("h2d"):
            x, y = next(it)
        with tl.phase("dispatch"):
            loss, pred = step(x, y)
        with tl.phase("read"):
            loss_m.update(None, loss)
            acc_m.update([y], [pred])
        tl.step()
    steps_syncs = delta(c0, counters(mx, engine, metric))
    pending = loss_m._dev_pending
    out = {"loss": loss_m.get()[1], "accuracy": acc_m.get()[1]}
    engine.waitall()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "timeline": tl.summary(), "syncs": steps_syncs,
            "pending_before_get": pending, "prefetch": pf.stats(), **out}


def pipeline_phase(mx, rt, ck, net, trainer, step, card_line, counts,
                   traced_total, device="cuda") -> dict:
    """16a (see the module docstring)."""
    engine = rt[0]
    batches = runtime_batches(RUNTIME_BATCHES, device=device)
    init = {k: p.data().detach().clone()
            for k, p in net.collect_params().items()}
    c0 = ck.launch_counts()
    # the capture before either loop, so that both run replays only
    step(*(t.to(device) for t in batches[0]))
    reset_state(trainer, net, init)
    sync = sync_loop(mx, rt, step, batches, device)
    final_sync = state_of(trainer, net)
    reset_state(trainer, net, init)
    pipe = pipelined_loop(mx, rt, step, batches, device)
    final_pipe = state_of(trainer, net)
    c1 = ck.launch_counts()
    for k in c1:
        if c1[k] != c0[k]:
            counts[k] = counts.get(k, 0) + c1[k] - c0[k]
    diff = [i for i, (a, b) in enumerate(zip(final_sync, final_pipe))
            if not torch.equal(a, b)]
    if diff:
        fail(f"16a: {len(diff)} parameter / momentum tensors differ between "
             f"the synchronous and the pipelined loop (first {diff[0]})")
    if pipe["accuracy"] != sync["accuracy"]:
        fail(f"16a: accuracy {pipe['accuracy']} pipelined, "
             f"{sync['accuracy']} synchronous")
    lrel = abs(pipe["loss"] - sync["loss"]) / abs(sync["loss"])
    if not lrel <= RUNTIME_LOSS_RTOL:
        fail(f"16a: loss metric {pipe['loss']} pipelined, {sync['loss']} "
             f"synchronous: relative {lrel} > {RUNTIME_LOSS_RTOL}")
    if pipe["prefetch"]["steady_ahead"] < RUNTIME_DEPTH:
        fail(f"16a: steady dispatch-ahead depth "
             f"{pipe['prefetch']['steady_ahead']} < {RUNTIME_DEPTH}: "
             f"{pipe['prefetch']}")
    if any(pipe["syncs"].values()) or pipe["pending_before_get"] != \
            RUNTIME_STEPS:
        fail(f"16a: the pipelined steps made blocking host reads or "
             f"synchronizations {pipe['syncs']}, or the metric folded "
             f"before .get() ({pipe['pending_before_get']} pending)")
    # the host path reads the loss, and the predictions and labels
    if sync["syncs"]["metric.host_sync"] != 3 * RUNTIME_STEPS:
        fail(f"16a: the synchronous loop read the metrics "
             f"{sync['syncs']['metric.host_sync']} times, want "
             f"{3 * RUNTIME_STEPS}")
    x, y = (t.to(device) for t in batches[0])
    if device == "cuda":
        _out, counted, traced = traced_launches(
            ck, lambda: step(x, y), total=traced_total)
        if counted or traced != CONV_BN.launches:
            fail(f"16a: a replay of the step counted {counted} and traced "
                 f"{traced}; want none counted and {CONV_BN.launches}")
    else:
        traced = None
    speedup = sync["wall_s"] / pipe["wall_s"]
    for name, r in (("synchronous", sync), ("pipelined", pipe)):
        t = r["timeline"]
        print(f"16a: {name} loop, {RUNTIME_STEPS} steps: wall "
              f"{r['wall_s'] * 1e3:.1f} ms, device_idle_gap_us "
              f"{t['device_idle_gap_us']} per step, phases "
              f"{t['phase_us_per_step']}, blocking reads / syncs "
              f"{r['syncs']}, loss {r['loss']!r}, accuracy "
              f"{r['accuracy']!r} [{card_line}]")
    print(f"16a: pipelined over synchronous wall {speedup:.3f}x, prefetch "
          f"{pipe['prefetch']}; params and momenta bitwise equal, loss "
          f"relative {lrel:.3g}; a replay traced {traced}  ok")
    return {"sync": sync, "pipelined": pipe, "wall_speedup": speedup,
            "loss_rel": lrel, "replay_traced": traced}


def eager_grad_norm(step, x, y) -> float:
    """The gradient norm of the step's loss at the live parameters,
    computed eagerly with the step's own forward and backward (fp64 sum of
    squares on the host)."""
    fb = step._forward_backward((x, y))
    _loss, _w, grads = fb(x, y)
    return math.sqrt(sum(float(g.double().square().sum()) for g in grads))


def sentinel_phase(mx, rt, ck, net, trainer, step, batches, card_line,
                   counts, device="cuda") -> dict:
    """16b (see the module docstring)."""
    engine, metric, _p, sentinel = rt
    from mxnet_tpu_torch import cached_step as cs
    init = {k: p.data().detach().clone()
            for k, p in net.collect_params().items()}
    staged = [tuple(t.to(device) for t in b) for b in batches]

    def run(snt_every, n, keep=True):
        """n steps from ``init``; with a sentinel and ``keep``, clones of
        the state before and after each sentinel step."""
        reset_state(trainer, net, init)
        snt = sentinel.Sentinel(step=step, every=snt_every) \
            if snt_every else None
        if snt is None:
            step._sentinel = None
        before, after = [], []
        engine.waitall()
        c0 = counters(mx, engine, metric)
        cs.reset_counters()
        tr0 = None
        t0 = time.perf_counter()
        for i in range(n):
            x, y = staged[i % len(staged)]
            if keep and snt_every and (i + 1) % snt_every == 0:
                before.append([t.detach().clone()
                               for t in step.digest_leaves()])
            step(x, y)
            if i == 0:
                tr0 = cs.trace_count()
            if keep and snt_every and (i + 1) % snt_every == 0:
                after.append([t.detach().clone()
                              for t in step.digest_leaves()])
        syncs = delta(c0, counters(mx, engine, metric))
        engine.waitall()
        wall = time.perf_counter() - t0
        return {"snt": snt, "before": before, "after": after,
                "syncs": syncs, "wall_s": wall,
                "captures_after_first": cs.trace_count() - tr0,
                "dispatches": cs.dispatch_count(),
                "final": state_of(trainer, net)}

    c0 = ck.launch_counts()
    on = run(SENTINEL_EVERY, SENTINEL_STEPS)
    c1 = ck.launch_counts()
    for k in c1:
        if c1[k] != c0[k]:
            counts[k] = counts.get(k, 0) + c1[k] - c0[k]
    off = run(0, SENTINEL_STEPS)
    snt = on["snt"]
    n_w = len(trainer._params)
    rows = []
    for k, (rec, pre, post) in enumerate(zip(snt.history, on["before"],
                                             on["after"])):
        host = sentinel.tree_digest(post)
        psum = sum(float(t.double().sum()) for t in post[:n_w])
        i = (k + 1) * SENTINEL_EVERY - 1
        with torch.no_grad():
            for p, w in zip(trainer._params, pre[:n_w]):
                p._data.copy_(w)
        gnorm = eager_grad_norm(step, *staged[i % len(staged)])
        rows.append({"step": i + 1, "fold": rec["fold"], "host_fold": host,
                     "psum": rec["psum"], "host_psum": psum,
                     "gnorm": rec["gnorm"], "host_gnorm": gnorm})
        if rec["fold"] != host:
            fail(f"16b: the digest of step {i + 1} is {rec['fold']}, "
                 f"tree_digest of the same state {host}")
        for what, a, b in (("psum", rec["psum"], psum),
                           ("gnorm", rec["gnorm"], gnorm)):
            if not abs(a - b) <= SENTINEL_RTOL * abs(b):
                fail(f"16b: {what} of step {i + 1}: {a} in the program, "
                     f"{b} on the host (rtol {SENTINEL_RTOL})")
    if len(rows) != SENTINEL_STEPS // SENTINEL_EVERY:
        fail(f"16b: {len(rows)} digests read, want "
             f"{SENTINEL_STEPS // SENTINEL_EVERY}")
    diff = [j for j, (a, b) in enumerate(zip(on["final"], off["final"]))
            if not torch.equal(a, b)]
    if diff:
        fail(f"16b: {len(diff)} tensors differ after {SENTINEL_STEPS} "
             f"steps with and without the sentinel")
    if on["captures_after_first"] or on["dispatches"] != SENTINEL_STEPS \
            or any(on["syncs"].values()):
        fail(f"16b: after the first call {on['captures_after_first']} "
             f"captures, {on['dispatches']} dispatches for "
             f"{SENTINEL_STEPS} steps, blocking reads / syncs "
             f"{on['syncs']}")
    if device == "cuda":
        pools = form_pool_bytes(step)
        fold_peak = fold_peak_bytes(step, sentinel)
    else:
        pools = fold_peak = None
    print(f"16b: memory: the captured forms' pools {pools} bytes, the "
          f"fold's peak over the live state {fold_peak} bytes (chunks of "
          f"{sentinel._FOLD_CHUNK} elements) [{card_line}]")
    print(f"16b: {len(rows)} in-program digests bitwise tree_digest, psum "
          f"and gnorm within {SENTINEL_RTOL} of the host: {rows}; "
          f"{on['dispatches']} dispatches, {on['captures_after_first']} "
          f"captures after the first call, syncs {on['syncs']}, late "
          f"reads {snt_late()}; parameters bitwise those without it  ok")
    # the cadence's cost, measured: every=20 against off
    walls = {}
    for name, every in (("off", 0), ("every20", SENTINEL_OVERHEAD_EVERY)):
        walls[name] = run(every, SENTINEL_OVERHEAD_STEPS,
                          keep=False)["wall_s"]
    overhead = 100.0 * (walls["every20"] / walls["off"] - 1.0)
    step._sentinel = None
    print(f"16b: sentinel every={SENTINEL_OVERHEAD_EVERY} over "
          f"{SENTINEL_OVERHEAD_STEPS} steps: {walls['every20']:.4f} s "
          f"against {walls['off']:.4f} s off, overhead {overhead:.3f} % "
          f"(the reference's acceptance: < 1 %, bench.py:978-980; not "
          f"gated) [{card_line}]")
    return {"digests": rows, "syncs": on["syncs"],
            "captures_after_first": on["captures_after_first"],
            "dispatches": on["dispatches"], "overhead_pct": overhead,
            "walls_s": walls, "pool_bytes": pools,
            "fold_peak_bytes": fold_peak}


def form_pool_bytes(step) -> dict:
    """The bytes of each captured form's private memory pool (the plain
    and the digest form of the step's program): the segments of
    ``torch.cuda.memory_snapshot`` that belong to the form's graph's
    pool, and the number of distinct pools. None where the card's torch
    does not say."""
    try:
        snap = torch.cuda.memory_snapshot()
        out, pools = {}, set()
        for key, prog in step._programs.items():
            graph = getattr(prog, "_graph", None)
            if graph is None:
                continue
            pid = tuple(graph.pool())
            pools.add(pid)
            name = "digest" if key[-1] == "digest" else "plain"
            out[name] = out.get(name, 0) + sum(
                seg["total_size"] for seg in snap
                if tuple(seg["segment_pool_id"]) == pid)
        out["distinct_pools"] = len(pools)
        return out
    except (AttributeError, KeyError, RuntimeError, TypeError):
        return None


def fold_peak_bytes(step, sentinel) -> int:
    """The peak of the memory the digest fold takes over the step's live
    state, run once eagerly (its temporaries, beyond what was allocated
    before it)."""
    from mxnet_tpu_torch import engine
    engine.waitall()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sentinel.fold_leaves(step.digest_leaves())
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def snt_late() -> int:
    from mxnet_tpu_torch import telemetry
    return int(telemetry.get("sentinel.late_reads").value)


def drill_phase(card_line, device="cuda", net="resnet50") -> dict:
    """16c: ``tools/torch_elastic_drill.py``'s children on the card."""
    import tempfile
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_elastic_drill.py")
    with tempfile.TemporaryDirectory(prefix="mxt_drill_") as d:
        cmd = [sys.executable, tool, "--device", device, "--net", net,
               "--dir", d, "--steps", str(DRILL["steps"]),
               "--save-every", str(DRILL["save_every"]),
               "--kill-at", str(DRILL["kill_at"])]
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=900)
    lines = p.stdout.strip().splitlines()
    if not lines:
        fail(f"16c: the drill printed nothing (exit {p.returncode}): "
             f"{p.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    if p.returncode != 0 or rec["failures"]:
        fail(f"16c: the drill's gates failed: {rec['failures']} "
             f"{p.stderr[-3000:]}")
    print(f"16c: preempted at step {DRILL['kill_at']} by SIGTERM, drained "
          f"in {rec['drain_ms']:.1f} ms, restored in "
          f"{rec['restore_ms']:.1f} ms, recovery wall (process start to the "
          f"first resumed step) {rec['recovery_wall_s']:.2f} s, "
          f"{rec['captures_on_restart']} capture(s) on restart, "
          f"{rec['steps_replayed']} steps replayed; final state bitwise the "
          f"uninterrupted child's; merged shards {rec['merged_counters']}; "
          f"children {rec['children']}  ok [{card_line}]")
    return rec


def runtime_phase(mx, ck, config, card_line, counts, traced,
                  device="cuda") -> dict:
    """Phase 16: 16a, 16b and 16c (see the module docstring)."""
    rt = port_runtime()
    set_fused(config, 0, EPILOGUE)
    set_fused(config, 1, CONV_BN)
    t0 = time.perf_counter()
    x, _y = image_batch(2, torch.float32)
    net = resnet50(mx, x)
    net.cast("bfloat16")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", RESNET_OPT)
    step = trainer.compile_step(net, runtime_loss_fn(mx))
    pipeline = pipeline_phase(mx, rt, ck, net, trainer, step, card_line,
                              counts, traced, device)
    batches = runtime_batches(SENTINEL_EVERY, device=device)
    snt = sentinel_phase(mx, rt, ck, net, trainer, step, batches, card_line,
                         counts, device)
    del net, trainer, step, batches
    if device == "cuda":
        torch.cuda.empty_cache()
    set_fused(config, 0, CONV_BN)
    drill = drill_phase(card_line, device)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return {"pipeline": pipeline, "sentinel": snt, "drill": drill}


# -- 17. mixed precision (amp) -------------------------------------------------

AMP_KERNELS = ("matmul_bn_stats", "matmul_stats", "matmul_epilogue",
               "convkxk_bn_stats")
AMP_REPLACES = {"matmul_bn_stats": 316, "matmul_stats": 512,
                "matmul_epilogue": 574, "convkxk_bn_stats": 880}
AMP_SOURCES = {"convkxk_bn_stats": "convkxk_bn_stats.cu"}
# fused sites a step under fp16 AMP: the Gluon gates fuse on an fp32 or
# bf16 INPUT only, as the reference's do, and a fused site's output is in
# the conv's dtype, fp16, so a conv fed by one stays unfused (the cast
# inside the op is what brings fp16 to the kernels); bf16 fuses every site
AMP16_CONV_BN = {"matmul_bn_stats": 28, "convkxk_bn_stats": 4}
AMP16_CONV_BN_SITES = {"1x1": 28, "kxk": 4, "refused": 21}
AMP16_EPILOGUE = {"matmul_stats": 17, "matmul_epilogue": 17}
# the first steps overflow at this init (the reference's Xavier fans on
# OHWI weights give weight gradients of ~1e3 and more, summed over the
# batch's per-sample losses), so the scale halves from 2^16 until a step
# is clean; AMP_STEPS leave room for that before the forced overflow
AMP_STEPS, AMP_OVERFLOW_AT, AMP_OVERFLOW_X = 20, 17, 1e6
AMP_SCALE0 = 2.0 ** 16     # LossScaler's first scale
AMP_BF16_STEPS, AMP_EPI_STEPS = 3, 3
# the first step's mean loss under fp16 AMP against the fp32 step's on the
# same weights (no update before it): 50 layers of fp16 operands with fp32
# accumulation and fp32 batch norm; measured 1e-3 or less on the narrow
# net (tests/test_torch_amp_step.py)
AMP_LOSS_RTOL = 1e-2
# convert_hybrid_block(net, "float16") logits against the fp32 net's, the
# same batch in training mode: relative L2 (fp16 weights and activations
# through 50 layers; measured 3.09e-2 on the card)
AMP_INFER_RTOL = 5e-2


def port_amp():
    """(amp, the compiled step module, the ndarray module) of the port."""
    from mxnet_tpu_torch import amp, cached_step
    from mxnet_tpu_torch.ndarray import ndarray as ndmod
    return amp, cached_step, ndmod


def amp_kernel_phase(ck) -> dict:
    """Phase 17k: the fp16 forms of B4, B5, B6 and B8 against their plain
    versions, with bf16's bounds scaled to fp16's ulp, at the edges of
    phases 5 and 5b, at their KxK cases and at every site shape of the
    ResNet-50 step at batch RESNET_BATCH; every output and statistic
    bitwise repeatable. Returns the max abs err of each at the site
    shapes."""
    dt, first = torch.float16, (lambda t: t[0])
    edge = {k: (-1.0, None) for k in AMP_KERNELS}
    seed = 3000
    for m, k, n in [(m, k, n) for m in EPI_EDGE_MS for k in EPI_EDGE_KS
                    for n in STATS_EDGE_NS] + STATS_WALK_CASES:
        seed += 1
        x, w = epi_inputs(m, k, n, dt, seed)[:2]
        what = f"({m}, {k}, {n}) fp16"
        edge["matmul_stats"] = max(edge["matmul_stats"], (check_stats(
            ck, x, w, what), (m, k, n)), key=first)
        for relu in (False, True):
            edge["matmul_bn_stats"] = max(edge["matmul_bn_stats"], (
                check_bn_stats(ck, x, w, relu, f"{what} relu {relu}"),
                (m, k, n, relu)), key=first)
    for m in EPI_EDGE_MS:
        for k in EPI_EDGE_KS:
            for n in EPI_EDGE_NS:
                seed += 1
                x, w, sc, sh, r = epi_inputs(m, k, n, dt, seed)
                for res in (None, r):
                    for relu in (False, True):
                        edge["matmul_epilogue"] = max(
                            edge["matmul_epilogue"], (check_epilogue(
                                ck, x, w, sc, sh, res, relu,
                                f"edge ({m}, {k}, {n}) fp16"),
                                (m, k, n, res is not None, relu)), key=first)
    for i, (xshape, cout, kernel, pad) in enumerate(KXK_CASES):
        x, w = kxk_inputs(xshape, cout, kernel, dt, seed=3100 + i)
        edge["convkxk_bn_stats"] = max(edge["convkxk_bn_stats"], (
            check_convkxk(ck, x, w, pad, f"{xshape} -> {cout}, kernel "
                          f"{kernel}, pad {pad}, fp16"), xshape), key=first)
    print("fp16 conv + BN kernels vs plain at the edges and cases of phases "
          "5 and 5b, within bf16's bounds scaled to fp16's ulp and bitwise "
          "repeatable; largest abs err " + ", ".join(
              f"{k} {e:.3e} at {at}" for k, (e, at) in edge.items())
          + "  ok")
    site = {k: (-1.0, None) for k in AMP_KERNELS}
    for i, (side, k, n, res, relu) in enumerate(RESNET_SITE_SHAPES):
        m = RESNET_BATCH * side * side
        x, w, sc, sh, r = epi_inputs(m, k, n, dt, seed=3200 + i)
        what = f"site ({m}, {k}, {n}) fp16"
        site["matmul_stats"] = max(site["matmul_stats"], (check_stats(
            ck, x, w, what), (m, k, n)), key=first)
        site["matmul_epilogue"] = max(site["matmul_epilogue"], (
            check_epilogue(ck, x, w, sc, sh, r if res else None, relu, what),
            (m, k, n)), key=first)
        del x, w, sc, sh, r
    for i, (side, k, n) in enumerate(C1X1_SITE_SHAPES):
        m = RESNET_BATCH * side * side
        x, w = epi_inputs(m, k, n, dt, seed=3300 + i)[:2]
        site["matmul_bn_stats"] = max(site["matmul_bn_stats"], (
            check_bn_stats(ck, x, w, False, f"site ({m}, {k}, {n}) fp16"),
            (m, k, n)), key=first)
    for i, (side, c) in enumerate(KXK_SITE_SHAPES):
        xshape = (RESNET_BATCH, side, side, c)
        x, w = kxk_inputs(xshape, c, (3, 3), dt, seed=3400 + i)
        site["convkxk_bn_stats"] = max(site["convkxk_bn_stats"], (
            check_convkxk(ck, x, w, (1, 1), f"site {xshape} fp16"), xshape),
            key=first)
    torch.cuda.synchronize()
    print("fp16 conv + BN kernels vs plain at every site shape of the "
          f"ResNet-50 step, batch {RESNET_BATCH}: within bounds, bitwise "
          "repeatable; largest abs err " + ", ".join(
              f"{k} {e:.3e} at {at}" for k, (e, at) in site.items())
          + "  ok")
    return {k: e for k, (e, _) in site.items()}


def amp_kernel_timings(ck, card_line) -> dict:
    """Phase 17t: each fp16 kernel beside its bf16 form at every site shape
    of the step (interleaved CUDA-graph replays in one call), summed over
    a step's launches; and at its first timed site (stage-1 conv3, stage
    1's 3x3) the fp16 kernel, its plain version and the library call of
    the bare product or conv, beside the bound (the same as bf16's: the
    same bytes and the same tensor-core rate)."""
    import torch.nn.functional as F
    dts = {"fp16": torch.float16, "bf16": torch.bfloat16}
    sites = {k: [] for k in AMP_KERNELS}

    def add(name, shape, count, fns, bound):
        t = time_ms(fns)
        sites[name].append(dict(shape=shape, launches=count,
                                bound_ms=bound[0], bound_by=bound[1],
                                **{f"{d}_ms": statistics.median(t[d])
                                   for d in dts}))
    launches = dict.fromkeys(C1X1_SITE_SHAPES, 0)
    for (side, k, n, _r, _l), c in zip(RESNET_SITE_SHAPES,
                                       RESNET_SITE_LAUNCHES):
        launches[(side, k, n)] += c
    for i, ((side, k, n), count) in enumerate(launches.items()):
        m = RESNET_BATCH * side * side
        xs = {d: epi_inputs(m, k, n, t, seed=3500 + i)[:2]
              for d, t in dts.items()}
        for name in STATS_KERNELS:
            fn = getattr(ck, name)
            add(name, [m, k, n], count,
                {d: (lambda fn=fn, x=x, w=w: fn(x, w))
                 for d, (x, w) in xs.items()}, stats_bound_ms(name, m, k, n))
        del xs
    for i, ((side, k, n, res, relu), count) in enumerate(zip(
            RESNET_SITE_SHAPES, RESNET_SITE_LAUNCHES)):
        m = RESNET_BATCH * side * side
        xs = {d: epi_inputs(m, k, n, t, seed=3600 + i)
              for d, t in dts.items()}
        add("matmul_epilogue", [m, k, n], count, {
            d: (lambda x=x, w=w, sc=sc, sh=sh, r=r: ck.matmul_epilogue(
                x, w, sc, sh, r if res else None, relu))
            for d, (x, w, sc, sh, r) in xs.items()},
            epi_bound_ms(m, k, n, True, res))
        del xs
    for i, ((side, c), count) in enumerate(zip(KXK_SITE_SHAPES,
                                               KXK_SITE_LAUNCHES)):
        xshape = (RESNET_BATCH, side, side, c)
        xs = {d: kxk_inputs(xshape, c, (3, 3), t, seed=3700 + i)
              for d, t in dts.items()}
        m = RESNET_BATCH * side * side
        add("convkxk_bn_stats", [*xshape, c], count, {
            d: (lambda x=x, w=w: ck.convkxk_bn_stats(x, w, (1, 1)))
            for d, (x, w) in xs.items()},
            conv_bn_bound_ms(2 * (2 * m * c + 9 * c * c) + 8 * c,
                             2 * m * 9 * c * c))
        del xs
    out = {}
    for name in AMP_KERNELS:
        step = {key: sum(s["launches"] * s[key] for s in sites[name])
                for key in ("fp16_ms", "bf16_ms", "bound_ms")}
        # the first timed site: the kernel, plain and library in fp16
        if name == "convkxk_bn_stats":
            side, c = KXK_SITE_SHAPES[0]
            xshape = (RESNET_BATCH, side, side, c)
            x, w = kxk_inputs(xshape, c, (3, 3), torch.float16, seed=3800)
            xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
            fns = {"ms": lambda: ck.convkxk_bn_stats(x, w, (1, 1)),
                   "plain_ms": lambda: ck.convkxk_bn_stats_reference(
                       x, w, (1, 1)),
                   "library_ms": lambda: F.conv2d(xc, wc, padding=1)}
            shape, at = [*xshape, c, "fp16"], sites[name][0]
        else:
            m, k, n = EPI_SITES[0]
            x, w, sc, sh, r = epi_inputs(m, k, n, torch.float16, seed=3800)
            kernel = {"matmul_bn_stats": lambda: ck.matmul_bn_stats(x, w),
                      "matmul_stats": lambda: ck.matmul_stats(x, w),
                      "matmul_epilogue": lambda: ck.matmul_epilogue(
                          x, w, sc, sh, r, True)}[name]
            plain = {"matmul_bn_stats": lambda: ck.matmul_bn_stats_reference(
                         x, w),
                     "matmul_stats": lambda: ck.matmul_stats_reference(x, w),
                     "matmul_epilogue": lambda: ck.matmul_epilogue_reference(
                         x, w, sc, sh, r, True)}[name]
            fns = {"ms": kernel, "plain_ms": plain,
                   "library_ms": lambda: torch.matmul(x, w)}
            shape = [m, k, n, "fp16"]
            at = (stats_bound_ms(name, m, k, n) if name != "matmul_epilogue"
                  else epi_bound_ms(m, k, n, True))
            at = dict(bound_ms=at[0], bound_by=at[1])
        t = time_ms(fns)
        row = {key: statistics.median(v) for key, v in t.items()}
        out[name] = dict(shape=shape, bound_ms=at["bound_ms"],
                         bound_by=at["bound_by"], **row, per_step=step,
                         sites=sites[name])
        del fns, x, w
        print(f"{name} fp16 at {shape}: kernel {spread(t['ms'])}, plain "
              f"{spread(t['plain_ms'])}, library {spread(t['library_ms'])}"
              f"; bound {at['bound_ms']:.5f} ms ({at['bound_by']}). Over a "
              f"step's {sum(s['launches'] for s in sites[name])} launches "
              f"at every site shape: fp16 {step['fp16_ms']:.4f} ms, bf16 "
              f"{step['bf16_ms']:.4f} ms (interleaved, the same call), "
              f"bound {step['bound_ms']:.4f} ms [{card_line}]")
    torch.cuda.empty_cache()
    return out


def amp_tally(ck, counts, counted_fp16) -> None:
    """Add the wrappers' launch counts since the last reset into
    ``counts``, and their fp16 launches into ``counted_fp16``."""
    for k, n in ck.launch_counts().items():
        if n:
            counts[k] = counts.get(k, 0) + n
    for (k, d), n in ck.launch_counts_by_dtype().items():
        if d == "fp16":
            counted_fp16[k] = counted_fp16.get(k, 0) + n


def same_bits(a, b) -> bool:
    """a and b bitwise equal, NaNs included (the overflow batch leaves NaN
    in the running statistics, which torch.equal would call unequal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.is_floating_point():
        n = a.element_size()
        return torch.equal(a.contiguous().view(ints[n]),
                           b.contiguous().view(ints[n]))
    return torch.equal(a, b)


def trained_state(trainer):
    """Clones of the trainable parameters and their optimizer states (the
    batch-norm running statistics, which every forward updates, apart)."""
    states = trainer._init_states()
    return [p.data().detach().clone() for p in trainer._params] + \
        [t.detach().clone() for st in states
         for t in (st if isinstance(st, (list, tuple)) else [st])]


def amp_trace(ck, fn, by_dtype):
    """fn() traced: (result, traced launches by wrapper, by (wrapper,
    dtype))."""
    seen = {}
    out, _counted, traced = traced_launches(ck, fn, by_dtype=seen)
    for key, n in seen.items():
        by_dtype[key] = by_dtype.get(key, 0) + n
    return out, traced, seen


def amp_net(mx, amp, config, route_modes, dtype, lag):
    """A fresh ResNet-50 (seed 0, fp32 parameters) hybridized, AMP on in
    ``dtype``, an SGD momentum trainer with the scaler, its compiled step:
    (net, trainer, step)."""
    for route, mode in route_modes:
        set_fused(config, mode, route)
    os.environ["MXNET_AMP_LAG"] = str(lag)
    config.refresh("MXNET_AMP_LAG")
    x, _y = image_batch(2, torch.float32)
    net = resnet50(mx, x)
    net.hybridize()
    amp.init(dtype)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_OPT))
    amp.init_trainer(trainer)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(net, lambda n, a, b: ce(n(a), b))
    return net, trainer, step


def amp_fp16_run(mx, ck, config, lag, batches, counts, traced, by_dtype,
                 counted_fp16, card_line):
    """17a: AMP_STEPS fp16 steps on the conv + BN route with the gate at
    ``lag``; the batch of step AMP_OVERFLOW_AT scaled by AMP_OVERFLOW_X to
    overflow fp16. Returns the run's record."""
    amp, cs, ndmod = port_amp()
    engine = port_runtime()[0]
    net, trainer, step = amp_net(mx, amp, config, ((EPILOGUE, 0),
                                                   (CONV_BN, 1)),
                                 "float16", lag)
    scaler = trainer._amp_loss_scaler
    ck.reset_launch_counts()
    resnet_mod = port_gluon()[2]
    resnet_mod.reset_fused_conv_bn_counts()
    losses, scales, before, after = [], [], None, None

    def marks():
        return (cs.dispatch_count(), cs.deferred_read_count(),
                ndmod.host_sync_count(), engine.sync_count(),
                cs.trace_count())
    r0 = cs.deferred_read_count()
    for i in range(AMP_STEPS):
        if i == 1:
            c0 = marks()      # the window: the replays after the capture
        x, y = batches[i % len(batches)]
        if i == AMP_OVERFLOW_AT:
            x = x * AMP_OVERFLOW_X
            before = trained_state(trainer)
        losses.append(step(x, y, batch_size=RESNET_BATCH))
        scales.append(scaler.loss_scale)
        if i == AMP_OVERFLOW_AT:
            after = trained_state(trainer)
        if i == 0:
            sites = resnet_mod.fused_conv_bn_counts()
            first = ck.launch_counts_by_dtype()
    c1 = marks()
    window = dict(zip(("dispatches", "deferred_reads", "host_reads",
                       "engine_syncs", "captures"),
                      (b - a for a, b in zip(c0, c1))))
    window["deferred_reads_in_run"] = cs.deferred_read_count() - r0
    # a traced replay (outside the counted window)
    x, y = batches[0]
    _out, tr, seen = amp_trace(ck, lambda: step(x, y,
                                                batch_size=RESNET_BATCH),
                               by_dtype)
    engine.waitall()
    wall = event_ms(lambda: step(x, y, batch_size=RESNET_BATCH))
    engine.waitall()
    amp_tally(ck, counts, counted_fp16)
    for k, n in tr.items():
        traced[k] = traced.get(k, 0) + n
    rec = dict(lag=lag, losses=[float(l.float().mean()) for l in losses],
               scales=scales, final_scale=scaler.loss_scale,
               unskipped=scaler._unskipped, window=window, sites=sites,
               first_call=first, traced=seen, wall_ms=wall,
               state=state_of(trainer, net), before=before, after=after)
    amp.uninit()
    del net, trainer, step
    torch.cuda.empty_cache()
    return rec


def amp_fp32_loss(mx, config, batch):
    """The mean loss of the fp32 step's forward on the initial weights
    (training mode, no AMP, unfused), and the largest |gradient| of a
    trainable parameter of that step's backward (the scale fp16 can
    hold is below 65504 over it)."""
    set_fused(config, 0, EPILOGUE)
    set_fused(config, 0, CONV_BN)
    x, y = batch
    net = resnet50(mx, image_batch(2, torch.float32)[0])
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = ce(net(x), y)
    mx.autograd.backward(loss)
    gmax = max(float(p.grad().abs().max())
               for p in net.collect_params().values()
               if p.grad_req != "null")
    loss = float(loss.mean())
    del net
    torch.cuda.empty_cache()
    return loss, gmax


def amp_short_run(mx, ck, config, route_modes, dtype, steps, batches,
                  counts, traced, by_dtype, counted_fp16):
    """17b / 17c: ``steps`` steps under AMP in ``dtype`` on the routes of
    ``route_modes``, the last one traced. Returns (losses, traced launches
    by (wrapper, dtype) of that replay, fused sites of the first call)."""
    amp = port_amp()[0]
    engine = port_runtime()[0]
    resnet_mod = port_gluon()[2]
    net, trainer, step = amp_net(mx, amp, config, route_modes, dtype, 1)
    ck.reset_launch_counts()
    resnet_mod.reset_fused_conv_bn_counts()
    losses = []
    for i in range(steps - 1):
        x, y = batches[i % len(batches)]
        losses.append(step(x, y, batch_size=RESNET_BATCH))
    x, y = batches[(steps - 1) % len(batches)]
    out, tr, seen = amp_trace(ck, lambda: step(x, y,
                                               batch_size=RESNET_BATCH),
                              by_dtype)
    losses.append(out)
    engine.waitall()
    amp_tally(ck, counts, counted_fp16)
    for k, n in tr.items():
        traced[k] = traced.get(k, 0) + n
    amp.uninit()
    del net, trainer, step
    torch.cuda.empty_cache()
    return [float(l.float().mean()) for l in losses], seen


def amp_infer_phase(mx, ps, config) -> dict:
    """17d: ``convert_hybrid_block(net, "float16")`` hybridized against the
    fp32 net on one batch in training mode (batch statistics), recording
    nothing; then captures: the first call captures, the next replays,
    ``amp.init`` and ``amp.uninit`` each make the next call capture."""
    amp = port_amp()[0]
    set_fused(config, 0, EPILOGUE)
    set_fused(config, 0, CONV_BN)
    x, _y = image_batch(RESNET_BATCH, torch.float32)
    net = resnet50(mx, image_batch(2, torch.float32)[0])
    with mx.autograd.train_mode():
        ref = net(x).float()
        amp.convert_hybrid_block(net, "float16")
        net.hybridize()
        ns = ps.namespace("hybrid_forward")
        caps = []

        def call():
            t0 = ns.traces
            out = net(x)
            caps.append(ns.traces - t0)
            return out
        got = call().float()
        call()
        amp.init("float16")
        call()
        amp.uninit()
        call()
    torch.cuda.synchronize()
    err = float((got - ref).norm() / ref.norm())
    dtypes = sorted({str(p.data().dtype)[6:]
                     for p in net.collect_params().values()})
    if not torch.isfinite(got).all() or err > AMP_INFER_RTOL:
        fail(f"17d: convert_hybrid_block fp16 logits vs fp32: relative L2 "
             f"{err:.3e} > {AMP_INFER_RTOL}")
    if caps != [1, 0, 1, 1]:
        fail(f"17d: captures of the calls (first, again, after amp.init, "
             f"after amp.uninit) {caps}, want [1, 0, 1, 1]")
    print(f"17d: convert_hybrid_block(net, 'float16') hybridized, logits vs "
          f"the fp32 net's relative L2 {err:.3e} (bound {AMP_INFER_RTOL}), "
          f"parameter dtypes {dtypes}; captures {caps} (init / uninit "
          f"capture anew)  ok")
    del net
    torch.cuda.empty_cache()
    return {"rel_l2": err, "captures": caps, "param_dtypes": dtypes}


def amp_phase(mx, ck, config, card_line, counts, traced) -> dict:
    """Phase 17 (see the module docstring)."""
    t0 = time.perf_counter()
    ps = port_capture()[0]
    amp = port_amp()[0]
    cudnn_det = torch.backends.cudnn.deterministic
    kernels = amp_kernel_phase(ck)
    times = amp_kernel_timings(ck, card_line)
    batches = [image_batch(RESNET_BATCH, torch.float32)]
    by_dtype, counted_fp16 = {}, {}
    keyed = lambda d: {f"{k}/{t}": n for (k, t), n in d.items()}
    # (a): the lag-0 and lag-1 runs must end bitwise equal, so cuDNN takes
    # deterministic algorithms at the unfused sites of both
    torch.backends.cudnn.deterministic = True
    try:
        runs = [amp_fp16_run(mx, ck, config, lag, batches, counts, traced,
                             by_dtype, counted_fp16, card_line)
                for lag in (0, 1)]
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    sync, lagged = runs
    for a, b in zip(sync["state"], lagged["state"]):
        if not same_bits(a, b):
            fail("17a: the MXNET_AMP_LAG=1 run's parameters and momenta are "
                 "not bitwise the MXNET_AMP_LAG=0 run's")
    if (sync["final_scale"], sync["unskipped"]) != \
            (lagged["final_scale"], lagged["unskipped"]):
        fail(f"17a: scaler state lag 0 {sync['final_scale']}, "
             f"{sync['unskipped']} != lag 1 {lagged['final_scale']}, "
             f"{lagged['unskipped']}")
    for rec in runs:
        if not all(same_bits(a, b) for a, b in zip(rec["before"],
                                                    rec["after"])):
            fail(f"17a lag {rec['lag']}: the overflow step changed a "
                 f"trainable parameter or a momentum")
        if not math.isnan(rec["losses"][AMP_OVERFLOW_AT]) and \
                math.isfinite(rec["losses"][AMP_OVERFLOW_AT]):
            fail(f"17a lag {rec['lag']}: the overflow step's loss is finite "
                 f"({rec['losses'][AMP_OVERFLOW_AT]})")
        # the first call runs the step eagerly and then captures it
        want_sites = {k: 2 * n for k, n in AMP16_CONV_BN_SITES.items()}
        if rec["sites"] != want_sites:
            fail(f"17a: fused sites of the first call {rec['sites']}, want "
                 f"{want_sites} (its eager run and its capture)")
        want = {(k, "fp16"): n for k, n in AMP16_CONV_BN.items()}
        if rec["traced"] != want:
            fail(f"17a lag {rec['lag']}: a traced replay ran "
                 f"{rec['traced']}, want {want}")
    # the scale of the overflow step halves: the synchronous gate has read
    # its flag by the step's return
    s = sync["scales"]
    if s[AMP_OVERFLOW_AT] != s[AMP_OVERFLOW_AT - 1] / 2 and \
            s[AMP_OVERFLOW_AT - 1] > 1.0:
        fail(f"17a: the overflow step took the scale {s[AMP_OVERFLOW_AT - 1]}"
             f" to {s[AMP_OVERFLOW_AT]}, not half")
    w = lagged["window"]
    n = AMP_STEPS - 1
    want_w = {"dispatches": n, "deferred_reads": n, "host_reads": n,
              "engine_syncs": 0, "captures": 0,
              "deferred_reads_in_run": AMP_STEPS - 1}
    if w != want_w:
        fail(f"17a lag 1: over the {n} replays {w}, want {want_w} (one "
             f"dispatch a step, each flag read one step late, no other host "
             f"read, and the steps less one flags read before waitall)")
    loss32, gmax = amp_fp32_loss(mx, config, batches[0])
    rel = abs(sync["losses"][0] - loss32) / abs(loss32)
    if not math.isfinite(sync["losses"][0]) or rel > AMP_LOSS_RTOL:
        fail(f"17a: first step's mean loss {sync['losses'][0]} vs fp32 "
             f"{loss32}: relative {rel:.3e} > {AMP_LOSS_RTOL}")
    clean = sum(1 for a, b in zip([AMP_SCALE0] + s[:-1], s) if b >= a)
    print(f"17a: fp16 AMP conv + BN step at batch {RESNET_BATCH}: {clean} "
          f"of {AMP_STEPS} steps clean (lag 0's reads); losses "
          f"{lagged['losses']}, scales {lagged['scales']} (lag 1; lag 0 "
          f"{sync['scales']}), final {lagged['final_scale']} after "
          f"waitall (the fp32 step's largest weight gradient {gmax:.4g}, so "
          f"fp16 holds scales up to {65504 / gmax:.4g}); lag 1 bitwise "
          f"lag 0; the overflow step left every "
          f"parameter and momentum as it was; lag window {w}; first loss vs "
          f"fp32 {rel:.3e} (bound {AMP_LOSS_RTOL}); a replay traced "
          f"{lagged['traced']}; captured step wall {lagged['wall_ms']:.2f} "
          f"ms (deterministic cuDNN; the bf16 conv + BN step, PERF.md §5: "
          f"73.2 ms) [{card_line}]  ok")
    # (b) the epilogue route in fp16
    epi_losses, epi_seen = amp_short_run(
        mx, ck, config, ((CONV_BN, 0), (EPILOGUE, 1)), "float16",
        AMP_EPI_STEPS, batches, counts, traced, by_dtype, counted_fp16)
    want = {(k, "fp16"): n for k, n in AMP16_EPILOGUE.items()}
    if epi_seen != want:
        fail(f"17b: a traced fp16 epilogue-route replay ran {epi_seen}, want "
             f"{want}")
    print(f"17b: fp16 AMP epilogue-route steps, losses {epi_losses}; a "
          f"replay traced {epi_seen}  ok")
    # (c) bf16, no scaler
    bf_losses, bf_seen = amp_short_run(
        mx, ck, config, ((EPILOGUE, 0), (CONV_BN, 1)), "bfloat16",
        AMP_BF16_STEPS, batches, counts, traced, by_dtype, counted_fp16)
    want = {(k, "bf16"): n for k, n in CONV_BN.launches.items()}
    if bf_seen != want or not all(map(math.isfinite, bf_losses)):
        fail(f"17c: a traced bf16 AMP replay ran {bf_seen}, want {want}; "
             f"losses {bf_losses}")
    print(f"17c: bf16 AMP conv + BN steps (no scaler), losses {bf_losses}; "
          f"a replay traced {bf_seen}  ok")
    infer = amp_infer_phase(mx, ps, config)
    amp.uninit()
    set_fused(config, 0, CONV_BN)
    set_fused(config, 0, EPILOGUE)
    seconds = time.perf_counter() - t0
    print(f"phase 17 took {seconds:.1f} s")
    return {"card": card_line, "seconds": seconds, "kernel_err": kernels,
            "timings": times,
            "fp16_conv_bn": dict(
                {k: lagged[k] for k in ("losses", "scales", "final_scale",
                                        "window", "sites", "wall_ms")},
                traced=keyed(lagged["traced"]),
                lag0_scales=sync["scales"]),
            "fp16_first_loss_vs_fp32": rel, "fp16_clean_steps": clean,
            "fp32_grad_max": gmax,
            "fp16_epilogue": {"losses": epi_losses,
                              "traced": keyed(epi_seen)},
            "bf16_conv_bn": {"losses": bf_losses, "traced": keyed(bf_seen)},
            "inference": infer, "traced_by_dtype": keyed(by_dtype),
            "launches_fp16": dict(counted_fp16)}


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

    torch.cuda.empty_cache()

    # -- 11. serving ----------------------------------------------------------
    serving, sd, lat = port_serving()
    ck.reset_launch_counts()
    t11 = time.perf_counter()
    decode, _model, _params = decode_storm_phase(sd, lat, card_line)
    del _model, _params
    torch.cuda.empty_cache()
    oneshot = oneshot_nets_phase(serving, mx, card_line)
    lanes = lanes_phase(lat, card_line)
    torch.cuda.synchronize()
    serving_counts = ck.launch_counts()
    print(f"phase 11 launch counts (no TPU kernel lies on the serving "
          f"paths): {serving_counts}; {time.perf_counter() - t11:.1f} s; "
          f"program store {json.dumps(ps.stats())}")
    print(json.dumps({"serving": {"card": card_line, "decode": decode,
                                  "oneshot": oneshot, "lanes": lanes}},
                     default=str))
    torch.cuda.empty_cache()

    # -- 12. speculative decoding ---------------------------------------------
    ck.reset_launch_counts()
    spec = spec_phase(sd, lat, ck, card_line)
    torch.cuda.synchronize()
    spec_counts = ck.launch_counts()
    print(json.dumps({"speculative": {"card": card_line, **spec}},
                     default=str))
    torch.cuda.empty_cache()

    # -- 13. the mixture-of-experts LM ----------------------------------------
    moe_counts, moe_traced = {}, {}
    moe = moe_phase(models, cs, ck, config, card_line, moe_counts,
                    moe_traced)
    torch.cuda.synchronize()
    print(f"phase 13 launch counts of the MoE runs: counted by the "
          f"wrappers {moe_counts}; traced on the device in the replays "
          f"{moe_traced}")
    print(json.dumps({"moe": {"card": card_line, **moe}}, default=str))
    torch.cuda.empty_cache()

    # -- 14. the mesh of one ----------------------------------------------------
    mesh_counts, mesh_traced = {}, {}
    mesh = mesh_phase(mx, ps, cs, ck, resnet, config, card_line, mesh_counts,
                      mesh_traced)
    if not all(mesh_counts.get(k) for k in CONV_BN_KERNELS + EPI_KERNELS):
        fail(f"14: a kernel of the conv + BN or epilogue route never "
             f"launched on the mesh path: {mesh_counts}")
    print(f"phase 14 launch counts of the kvstore and planned runs: counted "
          f"by the wrappers {mesh_counts}; traced on the device in the "
          f"replays {mesh_traced}")
    print(json.dumps({"mesh": {"card": card_line, **mesh}}, default=str))
    torch.cuda.empty_cache()

    # -- 15. the LM on a mesh ---------------------------------------------------
    mesh_lm_counts, mesh_lm_traced = {}, {}
    mesh_lm = mesh_lm_phase(models, cs, ck, config, card_line,
                            mesh_lm_counts, mesh_lm_traced)
    if not all(mesh_lm_counts.get(k) for k in TRAIN_KERNELS):
        fail(f"15: a flash kernel never launched on the mesh or pp path: "
             f"{mesh_lm_counts}")
    print(f"phase 15 launch counts of the mesh and pp runs: counted by the "
          f"wrappers {mesh_lm_counts}; traced on the device in the replays "
          f"{mesh_lm_traced}")
    print(json.dumps({"mesh_lm": {"card": card_line, **mesh_lm}},
                     default=str))
    torch.cuda.empty_cache()

    # -- 16. the runtime around the step ----------------------------------------
    runtime_counts, runtime_traced = {}, {}
    ck.reset_launch_counts()
    runtime = runtime_phase(mx, ck, config, card_line, runtime_counts,
                            runtime_traced)
    if not all(runtime_counts.get(k) for k in CONV_BN_KERNELS):
        fail(f"16: a conv + BN kernel never launched on the runtime path: "
             f"{runtime_counts}")
    print(f"phase 16 launch counts of the pipelined, synchronous and "
          f"sentinel runs: counted by the wrappers {runtime_counts}; traced "
          f"on the device in the replay {runtime_traced}")
    print(json.dumps({"runtime": {"card": card_line, **runtime}},
                     default=str))
    torch.cuda.empty_cache()

    # -- 17. mixed precision --------------------------------------------------
    amp_counts, amp_traced = {}, {}
    amp = amp_phase(mx, ck, config, card_line, amp_counts, amp_traced)
    if not all(amp_counts.get(k) for k in AMP_KERNELS):
        fail(f"17: a conv + BN kernel never launched on the amp path: "
             f"{amp_counts}")
    print(f"phase 17 launch counts of the AMP steps: counted by the "
          f"wrappers {amp_counts}; traced on the device in the replays "
          f"{amp_traced}")
    print(json.dumps({"amp": amp}, default=str))
    torch.cuda.empty_cache()

    # -- 10. results --------------------------------------------------------
    paths = {"forward": fwd_counts, "train": train_counts,
             "resnet_train": resnet_counts, "resnet_conv_bn": cbn_counts,
             "capture": capture_counts, "compiled_steps": steps_counts,
             "nd": nd_counts, "int8": int8_counts,
             "serving": serving_counts, "speculative": spec_counts,
             "moe": moe_counts, "mesh": mesh_counts,
             "mesh_lm": mesh_lm_counts, "runtime": runtime_counts,
             "amp": amp_counts}

    # launches the wrappers counted (a capture's once, a replay's not at
    # all), and those a profiler trace saw run in the replays that were
    # checked (the captured runs of the train and capture phases)
    traced_paths = {"train": train_traced, "capture": capture_traced,
                    "compiled_steps": steps_traced, "nd": nd_traced,
                    "moe": moe_traced, "mesh": mesh_traced,
                    "mesh_lm": mesh_lm_traced, "runtime": runtime_traced,
                    "amp": amp_traced}

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
    # the fp16 forms (phase 17): launches by kernel name and element type
    # in the AMP replays traced, beside the wrappers' count of the path
    fp16_traced = {k.split("/")[0]: n
                   for k, n in amp["traced_by_dtype"].items()
                   if k.endswith("/fp16")}
    for name in AMP_KERNELS:
        t = amp["timings"][name]
        kernels.append({
            "name": f"{name}_fp16", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/"
                      + AMP_SOURCES.get(name, "conv_bn_epilogue.cu"),
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:"
                        f"{AMP_REPLACES[name]}",
            "design": "the same TMA + wgmma GEMM core as the bf16 form, "
                      "templated on the 16-bit element type (f16 wgmma, "
                      "FLOAT16 tensor maps, __half2 stores)",
            "launches": amp["launches_fp16"].get(name, 0),
            "launches_by_path": {"amp": amp["launches_fp16"].get(name, 0)},
            "traced_replay_launches_by_path": {
                "amp": fp16_traced.get(name, 0)},
            "max_abs_err": amp["kernel_err"][name],
            **{k: t[k] for k in keys},
            "library": "torch.matmul of the same fp16 product" if name !=
                       "convkxk_bn_stats" else "cuDNN F.conv2d of the same "
                       "fp16 conv",
            "shape": t["shape"], "per_step": t["per_step"],
        })
    print(f"traces of launches by kernel name in this run: {TRACES[0]}; "
          f"{TRACE_LOSS['short']} lost records of their prefix of "
          f"{TRACE_PREFIX + 1} markers, at most {TRACE_LOSS['most']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
