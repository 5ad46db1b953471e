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
   backward; never called by the port) at the main paths' shapes, timed the
   same way in interleaved rounds, each beside its bound; median forward
   time per request shape and median train-step time; ``torch.profiler``
   traces of a few forwards and train steps (device-busy time, idle share,
   top kernels).
5. The kernels' JSON line, then the result line.

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
TIMING_ROUNDS = 5         # interleaved rounds of TIMING_ITERS launches each
TIMING_ITERS = 50
PROFILE_FORWARDS = 5
PROFILE_STEPS = 3


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


def time_ms(fns) -> dict:
    """CUDA-event ms per call of each ``fns[name]``: TIMING_ROUNDS rounds,
    each timing every function over TIMING_ITERS back-to-back calls, in an
    order that alternates between rounds. Returns {name: sorted per-round
    times}."""
    names = list(fns)
    for name in names:
        for _ in range(5):
            fns[name]()
    times = {name: [] for name in names}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for rnd in range(TIMING_ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            start.record()
            for _ in range(TIMING_ITERS):
                fns[name]()
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
              f"interleaved rounds of {TIMING_ITERS}: " + ", ".join(
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
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal)
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
                  f"interleaved rounds of {TIMING_ITERS}: kernel "
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


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    models, ck, _build = port()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = build_phase(_build)
    ck.reset_launch_counts()
    fwd_err = fwd_kernel_phase(ck)
    bwd_err = bwd_kernel_phase(ck)
    print(f"launch counts after the comparisons: {ck.launch_counts()}")

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

    # -- 5. results ---------------------------------------------------------
    t = attn_times[(96, 512)]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:49",
        "launches": fwd_counts["flash_attention_fwd"]
        + train_counts["flash_attention_fwd"],
        "launches_by_path": {
            "forward": fwd_counts["flash_attention_fwd"],
            "train": train_counts["flash_attention_fwd"]},
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
            "launches": train_counts[name],
            "launches_by_path": {"forward": fwd_counts[name],
                                 "train": train_counts[name]},
            "max_abs_err": bwd_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": "scaled_dot_product_attention backward, against "
                       "dq + dk/dv + delta",
            "shape": [bh, s, 64, "bf16"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
