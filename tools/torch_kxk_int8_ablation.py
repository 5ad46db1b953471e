#!/usr/bin/env python3
"""Ablations of the port's KxK conv-statistics kernel, B8
(``convkxk_bn_stats``), and int8 matmul, B7 (``int8_matmul``), on one GPU.

    python3 tools/torch_kxk_int8_ablation.py [--first-dir DIR]

Builds ``mxnet_tpu_torch/ops/csrc/convkxk_bn_stats.cu`` as it is and in
variants made by named text edits of the sources (each edit applies to the
source where it holds the edit's text, else to the one header that does;
each variant into its own directory under the git-ignored ``ops/_build/``,
all ``nvcc`` runs started together), holds every variant that computes
B8's function against the plain version with ``chip_smoke``'s checks
(``check_z``'s bound, ``STATS_RTOL``), and times them as interleaved
CUDA-graph replays (``chip_smoke.time_ms``) beside cuDNN ``F.conv2d`` and
the first, ``mma.sync`` kernel: at the four 3x3 sites of the bf16
batch-128 ResNet-50 step, with the sums over a step's 16 launches. Then B7
at the microbench shape and the two timed 1x1 sites: as built (w's panel
transposed by each CTA), with w transposed per call (``w.t().contiguous()``
and the kernel's wt path, both in the timed call), and the first kernel,
each held bitwise against the plain version.

B8's variants undo one design choice each:

- 2-stage ring in place of the deepest that fits;
- 128-column tiles: no 256-column tiles at any width (stage 4);
- 256-column tiles from 256 channels whatever M (stage 3 too).

The diagnostic variants change what the kernel computes, so they are timed
and not checked; they show where a tile's time goes: "products only"
writes no z and keeps no statistics, "no z store" issues no TMA store,
"loads only" does neither and issues no wgmma, "loads and epilogue only"
issues no wgmma.

The first kernels are those of commit ``FIRST_COMMIT``
(``convkxk_bn_stats.cu`` and ``int8_matmul.cu`` on ``conv_gemm_sm90.cuh``;
B8 with dtype 1, its per-m-tile partial rows summed by torch as the
wrapper did then), built beside today's other headers. The tool reads them
with ``git show``; where the checkout has no ``.git``, extract them first
and pass the directory as ``--first-dir``:

    mkdir -p d && for f in convkxk_bn_stats.cu int8_matmul.cu \\
        conv_gemm_sm90.cuh; do \\
        git show FIRST_COMMIT:mxnet_tpu_torch/ops/csrc/$f > d/$f; done

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KXK, INT8 = "convkxk_bn_stats", "int8_matmul"
FIRST_COMMIT = "c20a37a"
FIRST_FILES = (f"{KXK}.cu", f"{INT8}.cu", "conv_gemm_sm90.cuh")
FIRST = "mma.sync (first kernel)"
# edits of the diagnostic variants: the tile's products, z's writes into
# the tile buffer, the statistics, z's TMA store (handshakes kept)
WGMMA = ("    wgmma_ss<0>(Op<T>(), acc, desc_k_major(xs + 32 * kk),\n"
         "                desc_k_major(ws + 32 * kk), 1);", "    ;")
Z_WRITE = ("        *reinterpret_cast<typename Elem<T>::Pair*>(\n"
           "            pair_at(tb, f.rl + 8 * i, j, f.c4)) =\n"
           "            Elem<T>::pack(acc[4 * j + 2 * i], acc[4 * j + 2 * i + "
           "1]);", "        (void)tb;")
ADD_TILE = ("  add_tile<BN>(rs, rq, acc);\n}", "}")
Z_STORE = ("          tma_store_3d(&tout, tb + c * TM * RB, n0 + 64 * c, m0, "
           "0);", "          (void)tb;")
# name: (edits, computes B8's function)
VARIANTS = {
    "as built": ([], True),
    "2-stage ring": ([("static constexpr int NST = FIT < 8 ? FIT : 8;",
                       "static constexpr int NST = FIT < 2 ? FIT : 2;")],
                     True),
    "128-column tiles": ([("  return cout >= 256 && w256 <= w128 ? 256 : "
                           "128;", "  return 128;")], True),
    "256-column tiles from 256 channels whatever M": ([
        ("  return cout >= 256 && w256 <= w128 ? 256 : 128;",
         "  return cout >= 256 ? 256 : 128;")], True),
    "products only": ([Z_WRITE, ADD_TILE], False),
    "no z store": ([Z_STORE], False),
    "loads only": ([WGMMA, Z_WRITE, ADD_TILE, Z_STORE], False),
    "loads and epilogue only": ([WGMMA], False),
}


def first_sources(first_dir) -> dict:
    """{file name: text} of FIRST_FILES as of FIRST_COMMIT: from
    ``first_dir``, or ``git show``."""
    out = {}
    for name in FIRST_FILES:
        if first_dir:
            with open(os.path.join(first_dir, name)) as f:
                out[name] = f.read()
            continue
        try:
            out[name] = subprocess.run(
                ["git", "-C", ROOT, "show",
                 f"{FIRST_COMMIT}:mxnet_tpu_torch/ops/csrc/{name}"],
                check=True, capture_output=True, text=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            raise SystemExit(f"no git history here ({e}); pass --first-dir "
                             f"with {FIRST_FILES} as of {FIRST_COMMIT}")
    return out


def apply_edits(csrc, source, name, edits) -> None:
    """Each (old, new) edit replaces text in ``source``.cu where it holds
    the text, else in the one header that does; exits if none or several
    do."""
    src, headers = csrc / f"{source}.cu", sorted(csrc.glob("*.cuh"))
    for old, new in edits:
        hits = [src] if old in src.read_text() else [
            f for f in headers if old in f.read_text()]
        if len(hits) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} is in "
                             f"{[f.name for f in hits]}, want one file")
        hits[0].write_text(hits[0].read_text().replace(old, new))


def build_all(_build, first: dict) -> dict:
    """{(source, variant): loaded library}: B8's variants, and the first
    kernels of B8 and B7 from their own sources beside today's headers."""
    nvcc = _build.nvcc_path()
    jobs = [(KXK, name, edits) for name, (edits, _) in VARIANTS.items()]
    jobs += [(KXK, FIRST, None), (INT8, FIRST, None)]
    dirs = {}
    for source, name, edits in jobs:   # every edit checked before a build
        out = dirs[(source, name)] = (_build.BUILD_DIR / "ablation"
                                      / "kxk_int8" / source
                                      / re.sub(r"\W+", "_", name))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, out / "csrc")
        if edits is None:
            for fname, text in first.items():
                (out / "csrc" / fname).write_text(text)
        else:
            apply_edits(out / "csrc", source, name, edits)
    procs = {}
    for (source, name), out in dirs.items():
        lib = out / f"lib{source}.so"
        procs[(source, name)] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / "csrc" / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key} failed to build:\n{log[-4000:]}")
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"{key[0]} {key[1]!r}: built, {spill} bytes of spill stores")
        libs[key] = bind(ctypes.CDLL(str(lib)))
    return libs


def bind(lib):
    """lib with the argument types of its entry points set (a pointer
    passed without them is cut to 32 bits)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "mxt_convkxk_bn_stats_wgmma"):
        lib.mxt_convkxk_bn_stats_wgmma.argtypes = [vp] * 5 + [ci] * 11 + [vp]
    if hasattr(lib, "mxt_convkxk_bn_stats"):
        lib.mxt_convkxk_bn_stats.argtypes = [vp] * 5 + [ci] * 10 + [vp]
    if hasattr(lib, "mxt_int8_matmul"):   # the first kernel's: no wt
        lib.mxt_int8_matmul.argtypes = [vp] * 3 + [ci] * 3 + [cf, ci, ci,
                                                             cf, vp]
    return lib


class Kxk:
    """B8 through one library's C entry point: (z, mean, var)."""

    def __init__(self, lib, first: bool = False):
        self.lib, self.first = lib, first

    def __call__(self, x, w, pad=(1, 1)):
        n, h, wd, cin = x.shape
        cout, kh, kw, _ = w.shape
        ph, pw = pad
        ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
        m = n * ho * wo
        z = torch.empty(n, ho, wo, cout, dtype=x.dtype, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        geometry = (n, h, wd, cin, cout, kh, kw, ph, pw)
        if self.first:     # per-m-tile rows of 128 pixels, summed by torch
            parts = torch.empty(2, -(-m // 128), cout, device="cuda")
            rc = self.lib.mxt_convkxk_bn_stats(
                x.data_ptr(), w.data_ptr(), z.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), *geometry, 1, st)
            s, ss = parts.sum(1)
        else:
            rows = self.lib.mxt_convkxk_stats_rows(m, cout)
            scratch = torch.empty(2 * rows * cout + -(-cout // 64),
                                  device="cuda")
            sums = torch.empty(2, cout, device="cuda")
            rc = self.lib.mxt_convkxk_bn_stats_wgmma(
                x.data_ptr(), w.data_ptr(), z.data_ptr(), scratch.data_ptr(),
                sums.data_ptr(), *geometry, rows, 1, st)
            s, ss = sums
        if rc:
            raise SystemExit(f"B8 launch: cudaError_t {rc}")
        mean = s / m
        return z, mean, torch.clamp_min(ss / m - mean * mean, 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-dir", help=f"{FIRST_FILES} as of "
                    f"{FIRST_COMMIT} (default: git show)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kxk_int8_ablation: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch.nn.functional as F
    _models, ck, _build = cs.port()
    card = cs.card()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    first = first_sources(args.first_dir)
    _build.build([KXK, INT8])
    libs = build_all(_build, first)
    kxk = {name: Kxk(libs[(KXK, name)]) for name in VARIANTS}
    kxk[FIRST] = Kxk(libs[(KXK, FIRST)], first=True)
    checked = [name for name, (_, ok) in VARIANTS.items() if ok] + [FIRST]

    # B8: every variant that computes the function, against the plain
    # version, with chip_smoke's bounds (check_convkxk on a stand-in ck)
    class Ck:
        convkxk_bn_stats_reference = staticmethod(
            ck.convkxk_bn_stats_reference)
    cases = [(xs, co, kn, pd) for xs, co, kn, pd in cs.KXK_CASES]
    cases += [((cs.RESNET_BATCH, s, s, c), c, (3, 3), (1, 1))
              for s, c in cs.KXK_SITE_SHAPES]
    for i, (xshape, cout, kernel, pad) in enumerate(cases):
        x, w = cs.kxk_inputs(xshape, cout, kernel, torch.bfloat16, 640 + i)
        want = ck.convkxk_bn_stats(x, w, pad)
        for name in checked:
            Ck.convkxk_bn_stats = staticmethod(kxk[name])
            cs.check_convkxk(Ck, x, w, pad, f"variant {name!r} {xshape} -> "
                             f"{cout}, {kernel}, {pad}")
            if name == "as built" and not all(
                    torch.equal(a, b) for a, b in zip(kxk[name](x, w, pad),
                                                      want)):
                raise SystemExit("the unedited copy differs from the "
                                 "package's own build")
        del x, w, want
    torch.cuda.synchronize()
    print(f"every checked B8 variant within chip_smoke's bounds of the plain "
          f"version on {len(cases)} cases; the unedited copy bitwise equal "
          f"to the package's build")

    step = {}
    for (side, c), launches in zip(cs.KXK_SITE_SHAPES, cs.KXK_SITE_LAUNCHES):
        xshape = (cs.RESNET_BATCH, side, side, c)
        x, w = cs.kxk_inputs(xshape, c, (3, 3), torch.bfloat16, 730)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
        calls = {"cuDNN F.conv2d": lambda: F.conv2d(xc, wc, padding=1)}
        for name, fn in kxk.items():
            calls[name] = lambda fn=fn: fn(x, w)
        med = {key: statistics.median(t)
               for key, t in cs.time_ms(calls).items()}
        bound = cs.conv_bn_bound_ms(2 * (2 * x.numel() + w.numel()) + 8 * c,
                                    2 * x.shape[0] * side * side * 9 * c * c)
        step["bound"] = step.get("bound", 0.0) + launches * bound[0]
        for key, t in med.items():
            step[key] = step.get(key, 0.0) + launches * t
            print(f"B8 {key:32s} {xshape} -> {c}, x{launches}: {t:.4f} ms, "
                  f"{t / bound[0]:.2f}x the bound {bound[0]:.5f} ms "
                  f"({bound[1]}) [{card}]")
        del x, w, xc, wc
    for key, t in step.items():
        print(f"B8 over the 16 launches of a step, {key:32s}: {t:.4f} ms "
              f"[{card}]")

    # B7: as built, w transposed per call, the first kernel; bitwise
    new, old = _build.load(INT8), libs[(INT8, FIRST)]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    new.mxt_int8_matmul.argtypes = [vp] * 4 + [ci] * 3 + [cf, ci, ci, cf, vp]

    def b7(x, w, per_call=False, lib_first=False, requant=False):
        (m, k), n = x.shape, w.shape[1]
        out = torch.empty(m, n, device="cuda",
                          dtype=torch.int8 if requant else torch.float32)
        st = torch.cuda.current_stream().cuda_stream
        rest = (m, n, k, float(cs.INT8_SCALE), int(requant), int(requant),
                float(cs.INT8_OUT_SCALE) if requant else 0.0, st)
        if lib_first:
            rc = old.mxt_int8_matmul(x.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), *rest)
        else:
            wt = w.t().contiguous() if per_call else None
            rc = new.mxt_int8_matmul(x.data_ptr(), w.data_ptr(),
                                     None if wt is None else wt.data_ptr(),
                                     out.data_ptr(), *rest)
        if rc:
            raise SystemExit(f"B7 launch: cudaError_t {rc}")
        return out

    b7_variants = {"as built (w transposed by each CTA)": {},
                   "w transposed per call": {"per_call": True},
                   FIRST: {"lib_first": True}}
    for m, k, n in [cs.INT8_MICRO, *cs.INT8_TIMED_SITES, (1000, 48, 80)]:
        x, w = cs.int8_operands(m, k, n, seed=950)
        for requant in (False, True):
            want = ck.int8_matmul_reference(
                x, w, cs.INT8_SCALE, relu=requant,
                out_scale=cs.INT8_OUT_SCALE if requant else None)
            for name, kw in b7_variants.items():
                if not torch.equal(b7(x, w, requant=requant, **kw), want):
                    raise SystemExit(f"B7 {name!r} ({m}, {k}, {n}) requant "
                                     f"{requant}: not bitwise equal")
        calls = {}
        for name, kw in b7_variants.items():
            calls[name] = lambda kw=kw: b7(x, w, **kw)
            calls[f"{name}, requant"] = lambda kw=kw: b7(x, w, requant=True,
                                                         **kw)
        med = {key: statistics.median(t)
               for key, t in cs.time_ms(calls).items()}
        bound = cs.int8_bound_ms(m, k, n, 4)[0]
        for key, t in med.items():
            print(f"B7 {key:44s} ({m}, {k}, {n}): {t:.4f} ms, "
                  f"{t / bound:.2f}x the fp32-output bound {bound:.5f} ms "
                  f"[{card}]")
        del x, w
    print("medians above; every checked variant correct, every B7 call "
          "bitwise equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
