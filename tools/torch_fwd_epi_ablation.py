#!/usr/bin/env python3
"""Ablations of the port's 16-bit flash-attention forward (B1) and bf16
matmul epilogue (B6) on one GPU.

    python3 tools/torch_fwd_epi_ablation.py

Builds ``mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu`` and
``conv_bn_epilogue.cu`` as they are and in variants made by named text
edits of the source (each into its own directory under the git-ignored
``ops/_build/``, all ``nvcc`` runs started together), holds every variant
against its plain version with ``chip_smoke.OUT_TOL`` / ``LSE_TOL`` or
``EPI_TOL``, and times every variant as interleaved CUDA-graph replays
(``chip_smoke.time_ms``) beside the library call, at the LM forward's
shapes and at the two timed ResNet-50 sites. Every variant is a correct
kernel; the table says what each design choice is worth:

- forward: 64-key tiles in place of 128; a 3-stage ring in place of 2 at
  d <= 64 (three do not fit at d = 128); one CTA per (head, q-tile) in
  place of one per SM walking them; the accurate libdevice ``exp2f`` in
  place of one ``ex2.approx``; the mask on every tile, not only on tiles
  that touch the ragged edge or the diagonal; 64-row or 128-row q-tiles at
  every shape in place of the rule that picks one;
- epilogue: the wt box reloaded into every ring stage for every tile where
  one tile covers all of N and K (stage 1); the 2-stage ring of 256-column
  tiles at every K (no deep ring); 128-column tiles wherever N > 256, or
  wherever N > 128.

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD, EPI = "flash_attention_fwd", "conv_bn_epilogue"
VARIANTS = {
    FWD: {
        "as built": [],
        "64-key tiles": [("constexpr int KT = 128;",
                          "constexpr int KT = 64;")],
        "3-stage ring at d <= 64": [
            ("static constexpr int NST = 2;",
             "static constexpr int NST = HDP == 64 ? 3 : 2;")],
        "one CTA per item": [("const int grid = (int)(items < sms ? items : "
                              "sms);", "const int grid = (int)items;")],
        "libdevice exp2f": [("fast_exp2(", "exp2f(")],
        "mask on every tile": [("if (k0 + KT > s ||",
                                "if (true || k0 + KT > s ||")],
        "64-row q-tiles": [("return (long long)bh * ((s + 127) / 128) >= sms "
                            "? 128 : 64;", "return 64;")],
        "128-row q-tiles": [("return (long long)bh * ((s + 127) / 128) >= "
                             "sms ? 128 : 64;", "return 128;")],
    },
    EPI: {
        "as built": [],
        "wt reloaded for every tile": [("const bool w_fixed = n_kb == 1 && "
                                        "gridDim.x % n_nt == 0;",
                                        "const bool w_fixed = false;")],
        "2-stage ring at every K": [("constexpr int DEEP_K = 256;",
                                     "constexpr int DEEP_K = 1 << 30;")],
        "128-column tiles above 256": [
            ("return N <= 64 ? 64 : N <= 128 ? 128 : 256;",
             "return N <= 64 ? 64 : N <= 128 ? 128 : N <= 256 ? 256 : 128;")],
        "128-column tiles above 128": [
            ("return N <= 64 ? 64 : N <= 128 ? 128 : 256;",
             "return N <= 64 ? 64 : 128;")],
    },
}
# held against the plain version: (bh, s, d, dtype, causal) and
# (M, K, N, residual, relu)
FWD_CHECKS = [(96, 512, 64, torch.bfloat16, True),
              (4, 200, 128, torch.float16, True),
              (2, 77, 24, torch.bfloat16, False),
              (3, 1, 8, torch.float16, True),
              (200, 130, 64, torch.bfloat16, False),
              (150, 300, 128, torch.bfloat16, True)]
EPI_CHECKS = [(3001, 256, 2048, True, True), (77, 8, 8, True, True),
              (129, 24, 72, False, False), (1000, 1024, 320, True, False),
              (1000, 256, 256, True, True), (2000, 512, 136, False, True),
              (6272, 512, 2048, True, True), (100, 1024, 512, True, True)]
FWD_TIMED = [(48, 128), (96, 512), (384, 128)]   # (bh, s), d 64, bf16


def build_variants(_build) -> dict:
    """{(source, variant): loaded library}, each built from an edited copy
    of csrc/."""
    nvcc = _build.nvcc_path()
    procs = {}
    for source, variants in VARIANTS.items():
        for name, edits in variants.items():
            out = (_build.BUILD_DIR / "ablation" / source
                   / name.replace(" ", "_"))
            shutil.rmtree(out, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, out / "csrc")
            src = out / "csrc" / f"{source}.cu"
            # each edit applies to the source where it holds the edit's
            # text, else to the one header that does
            headers = sorted((out / "csrc").glob("*.cuh"))
            for old, new in edits:
                hits = [src] if old in src.read_text() else [
                    f for f in headers if old in f.read_text()]
                if len(hits) != 1:
                    raise SystemExit(f"variant {name!r}: {old!r} is in "
                                     f"{[f.name for f in hits]}, want one "
                                     f"file")
                hits[0].write_text(hits[0].read_text().replace(old, new))
            lib = out / f"lib{source}.so"
            procs[(source, name)] = (subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {key!r} failed to build:\n"
                             f"{log[-4000:]}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fwd_epi_ablation: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    _models, ck, _build = cs.port()
    card = cs.card()
    print(card)
    _build.build([FWD, EPI])
    regular = {src: _build.load(src) for src in VARIANTS}
    libs = build_variants(_build)

    def use(source, name):
        _build._LIBS[source] = libs[(source, name)]

    def close(got, want, atol, rtol):
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= atol + rtol * want.abs()).all())

    for i, (bh, s, d, dtype, causal) in enumerate(FWD_CHECKS):
        q, k, v = cs.attn_inputs(bh, s, d, dtype, seed=600 + i)
        scale = 1.0 / math.sqrt(d)
        ref = ck.flash_attention_fwd_reference(q, k, v, causal, scale)
        _build._LIBS[FWD] = regular[FWD]
        want = ck._fwd(q, k, v, causal, scale)
        for name in VARIANTS[FWD]:
            use(FWD, name)
            got = ck._fwd(q, k, v, causal, scale)
            if not (close(got[0], ref[0], *cs.OUT_TOL[dtype])
                    and close(got[1], ref[1], *cs.LSE_TOL[dtype])):
                raise SystemExit(f"forward variant {name!r} "
                                 f"{(bh, s, d, dtype, causal)} off the plain "
                                 f"version")
            if name == "as built" and not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit("the unedited forward copy differs from the "
                                 "package's own build")
    for i, (m, k, n, res, relu) in enumerate(EPI_CHECKS):
        x, w, sc, sh, r = cs.epi_inputs(m, k, n, torch.bfloat16, 650 + i)
        r = r if res else None
        ref = ck.matmul_epilogue_reference(x, w, sc, sh, r, relu)
        _build._LIBS[EPI] = regular[EPI]
        want = ck.matmul_epilogue(x, w, sc, sh, r, relu)
        for name in VARIANTS[EPI]:
            use(EPI, name)
            got = ck.matmul_epilogue(x, w, sc, sh, r, relu)
            if not close(got, ref, *cs.EPI_TOL[torch.bfloat16]):
                raise SystemExit(f"epilogue variant {name!r} "
                                 f"{(m, k, n, res, relu)} off the plain "
                                 f"version")
            if name == "as built" and not torch.equal(got, want):
                raise SystemExit("the unedited epilogue copy differs from "
                                 "the package's own build")
    print(f"every variant within chip_smoke's tolerances of the plain "
          f"version on {len(FWD_CHECKS)} forward and {len(EPI_CHECKS)} "
          f"epilogue cases; the unedited copies bitwise equal to the "
          f"package's builds")

    for bh, s in FWD_TIMED:
        q, k, v = cs.attn_inputs(bh, s, 64, torch.bfloat16, seed=100)
        q4, k4, v4 = (t.view(bh // 12, 12, s, 64) for t in (q, k, v))
        fns = {"sdpa": lambda: torch.nn.functional.
               scaled_dot_product_attention(q4, k4, v4)}
        for name in VARIANTS[FWD]:
            def fwd(name=name):
                use(FWD, name)
                ck._fwd(q, k, v, False, 0.125)
            fns[name] = fwd
        times = cs.time_ms(fns)
        bound, by = cs.attn_bound_ms(bh, s, 64, torch.bfloat16, False)
        for name, t in times.items():
            print(f"B1 ({bh}, {s}, 64) bf16 {name:27s}: {cs.spread(t)}; "
                  f"bound {bound:.5f} ms ({by}) [{card}]")
    for m, k, n in cs.EPI_SITES:
        x, w, sc, sh, r = cs.epi_inputs(m, k, n, torch.bfloat16, seed=700)
        fns = {"torch.matmul": lambda: torch.matmul(x, w)}
        for name in VARIANTS[EPI]:
            def epi(name=name):
                use(EPI, name)
                ck.matmul_epilogue(x, w, sc, sh, r, True)
            fns[name] = epi
        times = cs.time_ms(fns)
        bound, by = cs.epi_bound_ms(m, k, n, True)
        for name, t in times.items():
            print(f"B6 ({m}, {k}, {n}) residual + relu {name:27s}: "
                  f"{cs.spread(t)}; bound {bound:.5f} ms ({by}) [{card}]")
    for src in VARIANTS:
        _build._LIBS[src] = regular[src]
    print("medians above; every variant correct")
    return 0


if __name__ == "__main__":
    sys.exit(main())
