#!/usr/bin/env python3
"""Ablations of the port's 16-bit flash-attention backward on one GPU.

    python3 tools/torch_bwd_ablation.py

Builds ``mxnet_tpu_torch/ops/csrc/flash_attention_bwd.cu`` as it is and in
variants made by named text edits of the source (each into its own
directory under the git-ignored ``ops/_build/``, all ``nvcc`` runs started
together), holds every variant's dq, dk, dv against the plain version with
``chip_smoke.BWD_TOL``, and times the dq kernel, the dk/dv kernel and
``_bwd`` of every variant as interleaved CUDA-graph replays
(``chip_smoke.time_ms``) at the LM train path's shapes. Every variant is a
correct kernel; the table says what each design choice is worth:

- libdevice exp2f: the accurate ``exp2f`` in place of one ``ex2.approx``;
- mask on every tile: the causal / ragged mask evaluated for every element
  of every tile, not only on tiles that touch the edge or the diagonal;
- 4-stage ring: the streaming ring twice as deep.

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
SOURCE = "flash_attention_bwd"
EXP2F = [("fast_exp2(", "exp2f(")]
MASK_ALL = [("const bool edge = ", "const bool edge = true || ")]
VARIANTS = {
    "as built": [],
    "libdevice exp2f": EXP2F,
    "mask on every tile": MASK_ALL,
    "exp2f + mask on every tile": EXP2F + MASK_ALL,
    "4-stage ring": [("constexpr int NST = 2;", "constexpr int NST = 4;")],
}
# (bh, s, d, dtype, causal) held against the plain version
CHECKS = [(96, 512, 64, torch.bfloat16, True),
          (4, 200, 128, torch.float16, True),
          (2, 77, 24, torch.bfloat16, False)]
TIMED = [(384, 128), (96, 512)]   # (bh, s) at d = 64, bf16, non-causal


def build_variants(_build) -> dict:
    """{variant: loaded library}, each built from an edited copy of csrc/."""
    nvcc = _build.nvcc_path()
    procs = {}
    for name, edits in VARIANTS.items():
        out = _build.BUILD_DIR / "ablation" / name.replace(" ", "_")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, out / "csrc")
        src = out / "csrc" / f"{SOURCE}.cu"
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in {SOURCE}.cu")
            text = text.replace(old, new)
        src.write_text(text)
        lib = out / f"lib{SOURCE}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_ablation: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    _models, ck, _build = cs.port()
    card = cs.card()
    print(card)
    _build.build([SOURCE, "flash_attention_fwd"])
    regular = _build.load(SOURCE)
    libs = build_variants(_build)

    def use(name):
        _build._LIBS[SOURCE] = libs[name]

    for i, (bh, s, d, dtype, causal) in enumerate(CHECKS):
        q, k, v, do = cs.attn_inputs(bh, s, d, dtype, seed=500 + i, n=4)
        scale = 1.0 / math.sqrt(d)
        out, lse = ck._fwd(q, k, v, causal, scale)
        refs = ck.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                causal, scale)
        _build._LIBS[SOURCE] = regular
        want = ck._bwd(q, k, v, out, lse, do, causal, scale)
        for name in libs:
            use(name)
            got = ck._bwd(q, k, v, out, lse, do, causal, scale)
            errs = [((g.float() - r.float()).abs().max()
                     / r.float().abs().max()).item()
                    for g, r in zip(got, refs)]
            if max(errs) > cs.BWD_TOL[dtype]:
                raise SystemExit(f"variant {name!r} {(bh, s, d, dtype, causal)}"
                                 f": relative errors {errs}")
            if name == "as built" and not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit("the unedited copy differs from the package's"
                                 " own build")
    print(f"every variant within chip_smoke.BWD_TOL of the plain version on "
          f"{len(CHECKS)} cases; the unedited copy bitwise equal to the "
          f"package's build")

    for bh, s in TIMED:
        q, k, v, do = cs.attn_inputs(bh, s, 64, torch.bfloat16, seed=200, n=4)
        out, lse = ck._fwd(q, k, v, False, 0.125)
        fns = {}
        for name in libs:
            use(name)
            _, delta = ck._launch_bwd_dq(q, k, v, out, do, lse, False, 0.125)

            def dq(name=name):
                use(name)
                ck._launch_bwd_dq(q, k, v, out, do, lse, False, 0.125)

            def dkv(name=name, delta=delta):
                use(name)
                ck._launch_bwd_dkv(q, k, v, do, lse, delta, False, 0.125)

            def bwd(name=name):
                use(name)
                ck._bwd(q, k, v, out, lse, do, False, 0.125)

            fns[(name, "dq")], fns[(name, "dk/dv")] = dq, dkv
            fns[(name, "_bwd")] = bwd
        times = cs.time_ms(fns)
        for (name, what), t in times.items():
            print(f"({bh}, {s}, 64) bf16 {name:27s} {what:5s}: "
                  f"{cs.spread(t)} [{card}]")
    _build._LIBS[SOURCE] = regular
    return 0


if __name__ == "__main__":
    sys.exit(main())
