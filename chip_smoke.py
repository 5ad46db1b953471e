#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card and build: print the card's name and power limit (nvidia-smi), build
   every CUDA kernel from ``mxnet_tpu_torch/ops/csrc`` and print the seconds.
2. Kernel vs. plain version on the card: the flash-attention forward's
   ``out`` and ``lse`` against ``flash_attention_fwd_reference`` on the same
   inputs, at the LM's shapes and at ragged / fp32 / fp16 / other head-dim /
   sharp-softmax cases, each within its stated tolerance. This phase is the
   gate on the kernel: its inputs give scores of std 1 (or 8), where a wrong
   q k^T or a wrong rescale across k-tiles shows. 16-bit cases are also held
   to the rounding the kernel's design allows (see ``check_p16``).
3. The main path: the BERT-base-width LM (vocab 30528, 12 x 768, 12 heads,
   MLP 3072, bf16; random weights from a seeded generator) serves requests
   of tokens (4, 128) and (8, 512) through ``forward`` and ``loss_fn``, with
   the launch counts zeroed just before and read just after. Each forward
   must launch the kernel once per layer with no fallback and agree with the
   einsum attention path; ``loss_fn`` must match a plain masked NLL
   (``F.cross_entropy``) of the einsum path's logits. At random init the
   scores are near zero, so this phase checks the model around the kernel,
   not the kernel.
4. Timings: the kernel, its plain version and ``scaled_dot_product_attention``
   (the library yardstick, never called by the port) at the main path's
   shapes, timed the same way in interleaved rounds, each beside its bound;
   median forward time per request shape; a ``torch.profiler`` trace of a
   few forwards per request shape (device-busy time, idle share, top
   kernels).
5. The kernels' JSON line, then the result line.

Exits non-zero without a result when no CUDA device is available, and when
the ``mxnet_tpu_torch`` package is not beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor-core / fp32 CUDA-core

# (bh, s, d, dtype, causal, q scale); the first three are the main path's
# shapes. q, k, v are standard normal, so the scores have std q scale: 8
# makes the softmax sharp, and its max move between k-tiles.
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
TIMING_ROUNDS = 5         # interleaved rounds of TIMING_ITERS launches each
TIMING_ITERS = 50
PROFILE_FORWARDS = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def attn_inputs(bh, s, d, dtype, seed, q_scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda")
               for _ in range(3))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


def check_p16(out, q, k, v, causal, scale):
    """Hold a 16-bit kernel ``out`` to its design's rounding. Returns (max
    |out - exact|, the p-rounding gap, the largest excess over half an ulp).

    exact: the fp32 attention of the same inputs. p16: the same with p
    rounded to the input dtype before p v, the row sum l still over the
    unrounded p, as in the kernel's tensor-core path."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device)
                          .triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    exact = (p @ vf) / l
    gap = ((p.to(q.dtype).float() @ vf) / l - exact).abs().max().item()
    got = out.float()
    _, e = torch.frexp(got)
    half_ulp = torch.ldexp(torch.full_like(got, torch.finfo(out.dtype).eps),
                           e - 2)
    err = (got - exact).abs()
    excess = (err - half_ulp).max().item()
    if excess > P16_GAP_FACTOR * gap + 1e-6:
        fail(f"16-bit out exceeds its rounding: max excess over half an ulp "
             f"{excess:.3e} > {P16_GAP_FACTOR} x p-rounding gap {gap:.3e}")
    return err.max().item(), gap, excess


def attn_bound_ms(bh, s, d, dtype, causal):
    """Least time for the work: q, k, v read once, out and lse written
    once; 4*d flops per (query, key) pair that the mask keeps."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * s * d * esz + 4 * bh * s
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * pairs * d
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


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


def profile_forward(models, params, tokens, cfg, card_line) -> None:
    """Trace PROFILE_FORWARDS forwards: wall and device-busy ms per forward,
    the device's idle share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    B, S = tokens.shape
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_FORWARDS):
            models.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_FORWARDS
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n_t = kernels.setdefault(evt.name, [0, 0.0])
            n_t[0] += 1
            n_t[1] += evt.time_range.elapsed_us() / 1e3
    busy = sum(t for _, t in kernels.values()) / PROFILE_FORWARDS
    if not busy:
        print(f"profile tokens ({B}, {S}): the trace holds no device time; "
              f"device busy and idle share not measured")
        return
    print(f"profile tokens ({B}, {S}), traced: wall {wall:.3f} ms/fwd, "
          f"device busy {busy:.3f} ms/fwd, idle share {1 - busy / wall:.1%} "
          f"[{card_line}]")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        t /= PROFILE_FORWARDS
        print(f"  {t:8.4f} ms/fwd {n // PROFILE_FORWARDS:4d} launches/fwd "
              f"{t / busy:6.1%}  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build --------------------------------------------------
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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernel vs plain version ----------------------------------------
    ck.reset_launch_counts()
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
    print(f"launch counts after the comparisons: {ck.launch_counts()}")

    # -- 3. the main path: BERT-base-width LM forward ----------------------
    cfg = models.TransformerLMConfig(
        vocab_size=30528, num_layers=12, num_heads=12, hidden=768,
        mlp_hidden=3072, max_len=512, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(cfg, gen, device="cuda")
    rng = np.random.RandomState(0)
    requests = []
    for B, S in REQUESTS:
        tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
        labels = np.where(rng.rand(B, S) < 0.15, tokens, -1)
        requests.append((torch.as_tensor(tokens, device="cuda"),
                         torch.as_tensor(labels, device="cuda")))
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
    main_counts = ck.launch_counts()
    fallbacks = models.flash_fallback_count() - fallback0
    print(f"main path launch counts: {main_counts}, flash fallbacks "
          f"{fallbacks}")
    if fallbacks:
        fail(f"{fallbacks} flash fallbacks on the main path")
    if any(n == 0 for n in main_counts.values()):
        fail(f"a kernel of the main path never launched: {main_counts}")

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

    # -- 4. timings ---------------------------------------------------------
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
        spread = ", ".join(
            f"{what} median {statistics.median(t):.4f} ms "
            f"(min {t[0]:.4f}, max {t[-1]:.4f})"
            for what, t in zip(("kernel", "plain", "sdpa"), times.values()))
        print(f"flash fwd bh={bh} s={s} d={d} bf16, {TIMING_ROUNDS} "
              f"interleaved rounds of {TIMING_ITERS}: {spread}; bound "
              f"{bound:.5f} ms ({bound_by}) [{card_line}]")
    with torch.inference_mode():
        for (tokens, _labels), (B, S) in zip(requests, REQUESTS):
            for _ in range(3):
                models.forward(params, tokens, cfg)
            times = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models.forward(params, tokens, cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            bh = B * cfg.num_heads
            share = cfg.num_layers * attn_times[(bh, S)]["ms"] / med \
                if (bh, S) in attn_times else float("nan")
            print(f"forward tokens ({B}, {S}): median {med:.3f} ms over 10 "
                  f"(min {min(times):.3f}); flash kernel x{cfg.num_layers} "
                  f"~ {share:.1%} of it [{card_line}]")
        for tokens, _labels in requests:
            profile_forward(models, params, tokens, cfg, card_line)

    # -- 5. results ---------------------------------------------------------
    t = attn_times[(96, 512)]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:49",
        "launches": main_counts["flash_attention_fwd"],
        "max_abs_err": main_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": [96, 512, 64, "bf16"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
