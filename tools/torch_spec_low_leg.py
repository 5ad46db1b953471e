#!/usr/bin/env python3
"""Where the speculative lane's low-agreement leg spends its time.

    python3 tools/torch_spec_low_leg.py [--device cuda|cpu] [--runs N]

Runs the ``--speculative`` lane's baseline pass and its low-agreement
pass (``tools/torch_serving_latency.py``: the same pair, prompts, pool and
engines) ``--runs`` times, interleaved, and times on the host clock every
call the scheduler makes in each pass: the prefills, the draft prefills,
each speculative round split into its draft-round program, its verify
program and the round's host work after verify, and the plain decode
steps. Each call's time includes its one host read, so a program's time
is its device time plus the host's launch and read. Prints a JSON line a
run and the medians: the leg's ratio to the baseline, the rounds before
the arbiter disables the draft, each category's count and total ms in
both passes, and the low leg's extra wall split into those categories
and the rest (the scheduler's own work between calls).
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_serving_latency as lat  # noqa: E402
from mxnet_tpu_torch import serving_decode as sd  # noqa: E402

CATEGORIES = ("prefill", "draft_prefill", "draft_round", "verify",
              "round_host", "decode")


class _Timeline:
    """Host-clock time of the scheduler's calls, by category, while
    installed on ``GenerativeEngine``."""

    def __init__(self):
        self.ms = {c: 0.0 for c in CATEGORIES}
        self.n = {c: 0 for c in CATEGORIES}
        self._saved = {}

    def _wrap(self, name, category):
        real = getattr(sd.GenerativeEngine, name)
        self._saved[name] = real
        tl = self

        def timed(eng, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(eng, *a, **kw)
            finally:
                if category is not None:
                    tl.add(category, time.perf_counter() - t0)

        setattr(sd.GenerativeEngine, name, timed)

    def add(self, category, secs):
        self.ms[category] += secs * 1e3
        self.n[category] += 1

    def __enter__(self):
        self._wrap("_prefill", "prefill")
        self._wrap("_draft_prefill", "draft_prefill")
        self._wrap("_decode_step", "decode")
        # a round: its draft and verify programs are the engine's own
        # samples of ("spec", "draft") and ("spec_verify", k); the rest of
        # the round is host work
        real_round = sd.GenerativeEngine._spec_round
        real_ema = sd.GenerativeEngine._ema
        self._saved["_spec_round"] = real_round
        self._saved["_ema"] = real_ema
        tl = self

        def ema(eng, key, secs, alpha=0.3):
            if key == ("spec", "draft"):
                tl.add("draft_round", secs)
            elif isinstance(key, tuple) and key[0] == "spec_verify":
                tl.add("verify", secs)
            return real_ema(eng, key, secs, alpha)

        def spec_round(eng, k):
            t0 = time.perf_counter()
            before = tl.ms["draft_round"] + tl.ms["verify"]
            try:
                return real_round(eng, k)
            finally:
                programs = tl.ms["draft_round"] + tl.ms["verify"] - before
                tl.add("round_host",
                       time.perf_counter() - t0 - programs / 1e3)

        sd.GenerativeEngine._ema = ema
        sd.GenerativeEngine._spec_round = spec_round
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(sd.GenerativeEngine, name, real)
        return False


def one_run(target, tp, low_draft, low_params, prompts, new_tokens, k,
            device) -> dict:
    out = {}
    for label, spec_on in (("base", False), ("low", True)):
        with _Timeline() as tl:
            kw = dict(draft=low_draft, dparams=low_params, k=k) \
                if spec_on else {}
            res = lat._spec_pass(target, tp, prompts, new_tokens, spec_on,
                                 label=label, device=device, **kw)
        out[label] = dict(wall_ms=res["wall_s"] * 1e3,
                          tokens_s=res["tokens_s"], rounds=res["rounds"],
                          disabled=res["disabled"],
                          decode_steps=res["decode_steps"],
                          ms={c: tl.ms[c] for c in CATEGORIES},
                          n={c: tl.n[c] for c in CATEGORIES})
    base, low = out["base"], out["low"]
    out["ratio"] = low["tokens_s"] / base["tokens_s"]
    extra = low["wall_ms"] - base["wall_ms"]
    split = {c: low["ms"][c] - base["ms"][c] for c in CATEGORIES}
    split["rest"] = extra - sum(split.values())
    out["extra_ms"] = extra
    out["extra_split_ms"] = split
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_spec_low_leg: no CUDA device available",
              file=sys.stderr)
        return 1
    # the lane's setup (torch_serving_latency.run_speculative)
    target, tp, _d, _dp = sd.high_agreement_pair(
        vocab=128, d_model=64, target_layers=8, draft_layers=1, n_heads=4,
        max_seq=96, seed=0, device=args.device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, size=rng.randint(4, 13)).tolist()
               for _ in range(12)]
    low_draft = sd.TinyCausalLM(vocab=128, d_model=64, n_layers=1,
                                n_heads=4, max_seq=96)
    low_params = low_draft.init_params(99, device=args.device)
    runs = []
    for i in range(args.runs):
        r = one_run(target, tp, low_draft, low_params, prompts, 24, 4,
                    args.device)
        runs.append(r)
        print(json.dumps({"run": i + 1, **r}), flush=True)

    def med(f):
        return statistics.median(f(r) for r in runs)

    summary = {
        "device": args.device, "runs": len(runs),
        "ratio_median": med(lambda r: r["ratio"]),
        "ratio_min": min(r["ratio"] for r in runs),
        "ratio_max": max(r["ratio"] for r in runs),
        "rounds_before_disable": sorted({r["low"]["rounds"] for r in runs}),
        "base_wall_ms": med(lambda r: r["base"]["wall_ms"]),
        "low_wall_ms": med(lambda r: r["low"]["wall_ms"]),
        "extra_ms": med(lambda r: r["extra_ms"]),
        "extra_split_ms": {c: med(lambda r: r["extra_split_ms"][c])
                           for c in CATEGORIES + ("rest",)},
        "low_calls": {c: med(lambda r: r["low"]["n"][c])
                      for c in CATEGORIES},
        "low_ms_a_call": {c: med(lambda r: r["low"]["ms"][c]
                                 / max(r["low"]["n"][c], 1))
                          for c in CATEGORIES},
        "base_ms_a_call": {c: med(lambda r: r["base"]["ms"][c]
                                  / max(r["base"]["n"][c], 1))
                           for c in CATEGORIES},
    }
    if args.device == "cuda":
        import subprocess

        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
