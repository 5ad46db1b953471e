#!/usr/bin/env python3
"""The host cost of the port's imperative substrate, per call.

    python3 tools/torch_nd_overhead.py [CALLS]

Card only. Times CALLS calls (default 20000, after 1000 warm-up) of each
form on small CUDA tensors, host clock, no synchronisation inside the
timed loop (a full queue then paces the host; the tensors are small enough
that it does not fill), and prints the host microseconds a call:

- ``relu``: ``torch.relu(t)``, the op itself;
- ``invoke relu, tensor``: ``invoke("relu", [t], {})`` as a layer inside a
  block's call runs it (the dispatch count, the registry lookup);
- ``invoke relu, NDArray``: ``invoke`` on an NDArray (unwrap, grad mode
  off, wrap);
- ``invoke relu, NDArray, recorded``: the same under ``autograd.record()``;
- ``Activation block, tensor`` / ``NDArray``: a Gluon ``Activation`` block
  called with each flavor (``Block.__call__``'s flavor check, unwrap and
  wrap, and the ``invoke`` inside).

Then the card's name and power limit. The ResNet-50 classic loop's
dispatches a step (``chip_smoke.py`` phase 8h prints them) times the
per-call difference bounds what the substrate adds to its host ms.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def per_call_us(fn, calls):
    for _ in range(1000):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nd_overhead: no CUDA device", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import invoke

    calls = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    t = torch.randn(64, 64, device="cuda")
    a = mx.nd.array(t)
    act = mx.gluon.nn.Activation("relu")

    def recorded():
        with mx.autograd.record():
            invoke("relu", [a], {})

    def record_only():
        with mx.autograd.record():
            pass

    forms = {
        "relu": lambda: torch.relu(t),
        "invoke relu, tensor": lambda: invoke("relu", [t], {}),
        "invoke relu, NDArray": lambda: invoke("relu", [a], {}),
        "record() scope alone": record_only,
        "invoke relu, NDArray, recorded": recorded,
        "Activation block, tensor": lambda: act(t),
        "Activation block, NDArray": lambda: act(a),
    }
    for name, fn in forms.items():
        print(f"{name}: {per_call_us(fn, calls):.2f} us a call "
              f"(host, {calls} calls)")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
