#!/usr/bin/env python3
"""Host ms of the eager ResNet-50 step, this checkout's port against
another tree's, paired in one process.

    python3 tools/torch_host_ab.py OTHER_ROOT [PAIRS]

Card only. Loads this checkout's ``mxnet_tpu_torch`` and OTHER_ROOT's (for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory) side by side, the second under another module name; builds each
one's kernels; makes the same ResNet-50 v1 in each (NHWC, Xavier from seed
0, pure bf16, hybridized, conv + BN route, MXNET_COMPILED_STEP=0: the eager
classic loop of ``chip_smoke.py`` phase 8g) and one batch of 128 images;
then runs PAIRS (default 40) pairs of steps, alternating which package goes
first, each step and each recorded forward timed on the host clock from an
idle device to its return (the host's own work, with no queue to wait
on). Prints, for the forward and for the whole step, each side's median
and the median of the paired differences with the count of pairs this
checkout was slower, and each side's Python function calls (``cProfile``'s
count over 3 calls, a number that does not vary from run to run); then
the card's name and power limit. Cross-process comparisons of these host
times move by 10-20 ms between runs; paired steps in one process share
the host's state.
"""
import cProfile
import importlib.util
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def load(name, root):
    pkg = os.path.join(os.path.abspath(root), "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def setup(mx, x, y):
    from importlib import import_module
    import_module(mx.__name__ + ".ops._build").build()
    net = mx.gluon.model_zoo.get_model("resnet50_v1", classes=1000,
                                       layout="NHWC", input_layout="NHWC")
    net.initialize(mx.initializer.Xavier(
        generator=torch.Generator().manual_seed(0)))
    with torch.no_grad():
        net(x[:2].float())
    net.cast("bfloat16")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-3, "momentum": 0.9,
                                "wd": 1e-4})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward():
        with mx.autograd.record():
            return ce(net(x), y)

    def step():
        mx.autograd.backward(forward())
        trainer.step(x.shape[0])

    return forward, step


def host(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    dt = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return dt


def python_calls(fn, n=3):
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    return pstats.Stats(prof).total_calls / n


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_host_ab: no CUDA device", file=sys.stderr)
        return 1
    other_root = sys.argv[1]
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    os.environ["MXNET_FUSED_CONV_BN"] = "1"
    os.environ["MXNET_FUSED_EPILOGUE"] = "0"
    os.environ["MXNET_COMPILED_STEP"] = "0"
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(128, 224, 224, 3).astype(np.float32),
                        device="cuda").to(torch.bfloat16)
    y = torch.as_tensor(rng.randint(0, 1000, 128).astype(np.float32),
                        device="cuda")
    sys.path.insert(0, HERE)
    sides = {"this": setup(load("mxnet_tpu_torch", HERE), x, y),
             "other": setup(load("mxnet_tpu_torch_other", other_root), x,
                            y)}
    for fwd, step in sides.values():
        for _ in range(3):
            step()
    out = {}
    for what, k in (("forward", 0), ("step", 1)):
        t = {"this": [], "other": []}
        for i in range(pairs):
            order = ("this", "other") if i % 2 else ("other", "this")
            for side in order:
                t[side].append(host(sides[side][k]))
        diffs = [a - b for a, b in zip(t["this"], t["other"])]
        out[what] = {"this_median_ms": statistics.median(t["this"]),
                     "other_median_ms": statistics.median(t["other"]),
                     "diff_median_ms": statistics.median(diffs),
                     "this_slower_pairs": sum(d > 0 for d in diffs),
                     "pairs": pairs,
                     **{f"{side}_python_calls": python_calls(sides[side][k])
                        for side in ("this", "other")}}
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
