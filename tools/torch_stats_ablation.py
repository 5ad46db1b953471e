#!/usr/bin/env python3
"""Ablations of the port's bf16 batch-norm statistics kernels, B4
(``matmul_bn_stats``) and B5 (``matmul_stats``), on one GPU.

    python3 tools/torch_stats_ablation.py [--first-dir DIR]

Builds ``mxnet_tpu_torch/ops/csrc/conv_bn_epilogue.cu`` as it is and in
variants made by named text edits of the sources (each edit applies to the
source where it holds the edit's text, else to the one header that does;
each variant into its own directory under the git-ignored ``ops/_build/``,
all ``nvcc`` runs started together), holds every variant against the plain
versions with ``chip_smoke``'s statistics checks (``STATS_RTOL``,
``Z_ULP``), and times
them as interleaved CUDA-graph replays (``chip_smoke.time_ms``) beside
``torch.matmul`` of the bare product and the first, per-tile ``mma.sync``
kernels: at the two timed ResNet-50 sites, then at every distinct 1x1 site
of the bf16 batch-128 step with the sums over its 36 launches. Last, the
host's time per call, eager, of the final sum in the kernel and by torch.

The first kernels are those of ``conv_bn_epilogue.cu`` as of commit
``FIRST_COMMIT`` (``mxt_matmul_stats`` / ``mxt_matmul_bn_stats`` with
dtype 1, their per-m-tile partial rows summed by torch as the wrappers did
then), built with that commit's ``conv_gemm_sm90.cuh`` (whose ``mma.sync``
tiles they run on) beside today's other headers. The tool reads both with
``git show``; where the checkout has no ``.git``, extract them first and
pass their directory as ``--first-dir``:

    mkdir -p d && for f in conv_bn_epilogue.cu conv_gemm_sm90.cuh; do \\
        git show FIRST_COMMIT:mxnet_tpu_torch/ops/csrc/$f > d/$f; done

Each variant undoes one design choice:

- the final sum left to torch: the kernel writes its (2, R, N) rows and
  ``sum(1)`` adds them, one more launch, in place of the last CTA of each
  n-tile (and of the memset that zeroes the counters it counts on);
- a per-tile warp reduction: every tile's column sums are added over the
  warp's lanes (shuffles) before they join the running sums, as the first
  kernel reduced every tile, in place of once per CTA at the end;
- a 2-stage ring in place of the deepest that fits;
- 256-column tiles wherever N > 128 (lanes g and g ^ 4 splitting the
  column groups, one shuffle per value kept, since a thread's running sums
  of 64 columns would not fit the registers beside its 128 accumulators:
  the split the KxK conv kernel's 256-column tiles use) in place of 128.

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
import time

import torch

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
EPI = "conv_bn_epilogue"
FIRST_COMMIT = "8552156"
FIRST_FILES = (f"{EPI}.cu", "conv_gemm_sm90.cuh")
FIRST = "mma.sync, per tile (first kernel)"
ADD_TILE = "  add_tile<BN>(rs, rq, acc);"
VARIANTS = {
    "as built": [],
    "final sum by torch": [
        ("      fold_rows<BN>(parts, sums, counters, last, R, nt, N);", ""),
        ("  err = cudaMemsetAsync(c, 0, n_nt * sizeof(unsigned), st);\n"
         "  if (err != cudaSuccess) return err;\n", "")],
    "per-tile warp reduction": [
        (ADD_TILE, """  {
    float ts[Cols<BN>::NV], tq[Cols<BN>::NV];
#pragma unroll
    for (int i = 0; i < Cols<BN>::NV; ++i) ts[i] = tq[i] = 0.f;
    add_tile<BN>(ts, tq, acc);
    warp_rows<BN>(ts, tq);
#pragma unroll
    for (int i = 0; i < Cols<BN>::NV; ++i) {
      rs[i] += ts[i];
      rq[i] += tq[i];
    }
  }"""),
        ("      warp_rows<BN>(rs, rq);\n      consumer_sync();",
         "      consumer_sync();")],
    "2-stage ring": [("static constexpr int NST = FIT < 8 ? FIT : 8;",
                      "static constexpr int NST = FIT < 2 ? FIT : 2;")],
    "256-column tiles above 128": [
        ("inline int stats_tile_n(int N) { return N <= 64 ? 64 : 128; }",
         "inline int stats_tile_n(int N) { return N <= 64 ? 64 : N <= 128 ? "
         "128 : 256; }"),
        ("return stats_tile_n(N) == 64 ? f(Tag<64, NRB>{}) : f(Tag<128, "
         "NRB>{});", "return stats_tile_n(N) == 64 ? f(Tag<64, NRB>{}) : "
         "stats_tile_n(N) == 128 ? f(Tag<128, NRB>{}) : f(Tag<256, NRB>{});")],
}
# (M, K, N) held against the plain versions: edges, several n-tiles, the
# CTAs' walk over several m-tiles, the two timed sites
CHECKS = [(77, 8, 8), (1000, 24, 72), (77, 8, 264), (3001, 256, 264),
          (40000, 64, 2048), (10000, 136, 1032), (401408, 64, 256),
          (6272, 512, 2048)]


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


def apply_edits(csrc, name, edits) -> None:
    """Each (old, new) edit replaces text in conv_bn_epilogue.cu where it
    holds the text, else in the one header that does; exits if none or
    several do."""
    src, headers = csrc / f"{EPI}.cu", sorted(csrc.glob("*.cuh"))
    for old, new in edits:
        hits = [src] if old in src.read_text() else [
            f for f in headers if old in f.read_text()]
        if len(hits) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} is in "
                             f"{[f.name for f in hits]}, want one file")
        hits[0].write_text(hits[0].read_text().replace(old, new))


def build_variants(_build, first: dict) -> dict:
    """{variant: loaded library}, each built from an edited copy of csrc/,
    and the first kernels from their own sources beside today's other
    headers."""
    nvcc = _build.nvcc_path()
    dirs = {}
    for name, edits in [*VARIANTS.items(), (FIRST, None)]:
        out = dirs[name] = _build.BUILD_DIR / "ablation" / "stats" / re.sub(
            r"\W+", "_", name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, out / "csrc")
        if edits is None:
            for fname, text in first.items():
                (out / "csrc" / fname).write_text(text)
        else:
            apply_edits(out / "csrc", name, edits)
    procs = {}
    for name, out in dirs.items():
        src = out / "csrc" / f"{EPI}.cu"
        lib = out / f"lib{EPI}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n"
                             f"{log[-4000:]}")
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"variant {name!r}: built, {spill} bytes of spill stores")
        libs[name] = bind(ctypes.CDLL(str(lib)))
    return libs


def bind(lib):
    """lib with the argument types of its statistics entry points set (a
    pointer passed without them is cut to 32 bits)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr, n_int in (("mxt_matmul_stats_wgmma", 4, 4),
                             ("mxt_matmul_bn_stats_wgmma", 5, 5),
                             ("mxt_matmul_stats", 4, 4),
                             ("mxt_matmul_bn_stats", 5, 5)):
        if hasattr(lib, fn):   # the first kernels' library has no wgmma
            getattr(lib, fn).argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
    if hasattr(lib, "mxt_stats_rows"):
        lib.mxt_stats_rows.argtypes = [ci, ci]
    return lib


class Stats:
    """Calls of one library's statistics kernels through its C entry
    points; ``y`` given: matmul_bn_stats. Returns (y, s, ss)."""

    def __init__(self, lib, fold: bool = True, per_tile: bool = False):
        self.lib, self.fold, self.per_tile = lib, fold, per_tile

    def __call__(self, x, wt, y=None):
        (m, k), n = x.shape, wt.shape[0]
        st = torch.cuda.current_stream().cuda_stream
        p = lambda t: t.data_ptr()
        if self.per_tile:    # the first kernel: one row per m-tile
            parts = torch.empty((2, -(-m // 128), n), device="cuda")
            if y is None:
                rc = self.lib.mxt_matmul_stats(p(x), p(wt), p(parts[0]),
                                               p(parts[1]), m, n, k, 1, st)
            else:
                rc = self.lib.mxt_matmul_bn_stats(
                    p(x), p(wt), p(y), p(parts[0]), p(parts[1]), m, n, k, 0,
                    1, st)
            if rc:
                raise SystemExit(f"mma.sync kernel: cudaError_t {rc}")
            s, ss = parts.sum(1)
            return y, s, ss
        rows = self.lib.mxt_stats_rows(m, n)
        # the partial rows, then the counters (the wrapper's layout)
        scratch = torch.empty(2 * rows * n + -(-n // 64), device="cuda")
        sums = torch.empty((2, n), device="cuda")
        if y is None:
            rc = self.lib.mxt_matmul_stats_wgmma(
                p(x), p(wt), p(scratch), p(sums), m, n, k, rows, st)
        else:
            rc = self.lib.mxt_matmul_bn_stats_wgmma(
                p(x), p(wt), p(y), p(scratch), p(sums), m, n, k, rows, 0,
                st)
        if rc:
            raise SystemExit(f"wgmma kernel: cudaError_t {rc}")
        if not self.fold:
            sums = scratch[:2 * rows * n].view(2, rows, n).sum(1)
        return y, sums[0], sums[1]


def host_us(fn, calls: int = 400, reps: int = 7) -> float:
    """The host's median time per call, in microseconds, of ``calls``
    eager calls in a row (the device drained before each rep, and its work
    per call shorter than the host's, so the host's clock reads the host's
    cost)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-dir", help=f"{FIRST_FILES} as of "
                    f"{FIRST_COMMIT} (default: git show)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stats_ablation: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    _models, ck, _build = cs.port()
    card = cs.card()
    print(card)
    first = first_sources(args.first_dir)
    _build.build([EPI])
    libs = build_variants(_build, first)
    fns = {name: Stats(lib, fold=name != "final sum by torch",
                       per_tile=name == FIRST)
           for name, lib in libs.items()}

    for i, (m, k, n) in enumerate(CHECKS):
        x, w = cs.epi_inputs(m, k, n, torch.bfloat16, 660 + i)[:2]
        wt = w.t()
        z = x.float() @ w.float()
        y_ref = z.to(torch.bfloat16)
        mag = x.float().abs() @ w.float().abs()
        want = ck.matmul_stats(x, w)
        for name, fn in fns.items():
            what = f"variant {name!r} ({m}, {k}, {n})"
            _, s, ss = fn(x, wt)
            cs.check_col_sums(what, "matmul_stats", s, ss, z)
            if name == "as built" and not (torch.equal(s, want[0])
                                           and torch.equal(ss, want[1])):
                raise SystemExit("the unedited copy differs from the "
                                 "package's own build")
            y = torch.empty_like(y_ref)
            _, s, ss = fn(x, wt, y)
            cs.check_col_sums(what, "matmul_bn_stats", s, ss, z)
            cs.check_z(what, "matmul_bn_stats", y, y_ref, mag)
    torch.cuda.synchronize()
    print(f"every variant within chip_smoke's tolerances of the plain "
          f"versions on {len(CHECKS)} cases; the unedited copy bitwise "
          f"equal to the package's build")

    def timings(m, k, n, seed):
        x, w = cs.epi_inputs(m, k, n, torch.bfloat16, seed)[:2]
        wt = w.t()
        y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        calls = {"torch.matmul": lambda: torch.matmul(x, w)}
        for name, fn in fns.items():
            calls[f"B5 {name}"] = lambda fn=fn: fn(x, wt)
            calls[f"B4 {name}"] = lambda fn=fn: fn(x, wt, y)
        return {key: statistics.median(t)
                for key, t in cs.time_ms(calls).items()}

    for m, k, n in cs.EPI_SITES:
        med = timings(m, k, n, 700)
        for kernel in ("B5", "B4"):
            name = "matmul_stats" if kernel == "B5" else "matmul_bn_stats"
            bound, by = cs.stats_bound_ms(name, m, k, n)
            for key, t in med.items():
                if key.startswith(kernel):
                    print(f"{key:36s} ({m}, {k}, {n}): {t:.4f} ms, "
                          f"{t / bound:.2f}x the bound {bound:.5f} ms "
                          f"({by}) [{card}]")
        print(f"torch.matmul ({m}, {k}, {n}): {med['torch.matmul']:.4f} ms "
              f"[{card}]")

    launches = dict.fromkeys(cs.C1X1_SITE_SHAPES, 0)
    for (side, k, n, _res, _relu), count in zip(cs.RESNET_SITE_SHAPES,
                                               cs.RESNET_SITE_LAUNCHES):
        launches[(side, k, n)] += count
    step = {}
    for i, ((side, k, n), count) in enumerate(launches.items()):
        m = cs.RESNET_BATCH * side * side
        med = timings(m, k, n, 820 + i)
        for key, t in med.items():
            step[key] = step.get(key, 0.0) + count * t
        for kernel, name in (("B5", "matmul_stats"),
                             ("B4", "matmul_bn_stats")):
            bound = cs.stats_bound_ms(name, m, k, n)[0]
            step[f"{kernel} bound"] = step.get(f"{kernel} bound", 0.0) + \
                count * bound
        print(f"site ({m}, {k}, {n}) x{count}: " + ", ".join(
            f"{key} {t:.4f}" for key, t in med.items()) + f" ms [{card}]")
    for key, t in step.items():
        print(f"over the 36 launches of a step, {key:36s}: {t:.4f} ms "
              f"[{card}]")

    # the host's cost per call, eager, at stage 4 (whose kernel is short):
    # the final sum in the kernel (its counters zeroed by a memset in the
    # same C call) against a torch sum launched after it; the wrappers add
    # their own checks and allocations to either
    m, k, n = cs.EPI_SITES[-1]
    x, w = cs.epi_inputs(m, k, n, torch.bfloat16, 990)[:2]
    wt = w.t()
    calls = {"wrapper ck.matmul_stats": lambda: ck.matmul_stats(x, w),
             "B5 as built": lambda: fns["as built"](x, wt),
             "B5 final sum by torch": lambda: fns["final sum by torch"](x,
                                                                       wt)}
    for key, fn in calls.items():
        print(f"host per call, eager, {key:28s} ({m}, {k}, {n}): "
              f"{host_us(fn):.2f} us [{card}]")
    print("medians above; every variant correct")
    return 0


if __name__ == "__main__":
    sys.exit(main())
