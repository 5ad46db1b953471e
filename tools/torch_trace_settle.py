#!/usr/bin/env python3
"""How often a profiler trace misses kernels of a replayed CUDA graph.

    python3 tools/torch_trace_settle.py [N]

Card only. Builds the port's kernels, captures the BERT-base-width LM train
step (Adam, tokens (32, 128), ``chip_smoke.py``'s phase 3b setup) and then
traces N replays of it in each of five modes, twice over, counting by
kernel name (``cuda_kernels.kernel_of``) the flash-attention launches each
trace saw against the 12 of each that every replay runs:

- ``none``: the replay starts as soon as the trace does;
- ``warm_kernel``: a one-element kernel runs and is synchronised inside
  the trace first;
- ``host_sleep``: the host waits 50 ms inside the trace first
  (``chip_smoke.TRACE_SETTLE_S``, what ``chip_smoke.traced_launches``
  does);
- ``device_sleep``: the device spins about 100 M cycles first;
- ``both``: the host wait, then the device spin.

Prints, per mode and round, how many traces were short and the first few
short counts, and the card's name and power limit.
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

MODES = ("none", "warm_kernel", "host_sleep", "device_sleep", "both")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trace_settle: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile as trace_

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    models, ck, _build = cs.port()
    card = cs.build_phase(_build)
    cfg = cs.bert_base(models)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens, labels = cs.batch(np.random.RandomState(0), cfg,
                              *cs.TRAIN_TOKENS)
    step = models.make_train_step(cfg, optimizer="adam", lr=cs.TRAIN_LR)
    m, v = models.init_opt_state(params)
    want = {k: cfg.num_layers for k in cs.TRAIN_KERNELS}
    t = [1]

    def one():
        step(params, m, v, tokens, labels, t[0])
        t[0] += 1

    one()                                   # the capture
    with trace_(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def traced(mode):
        torch.cuda.synchronize()
        with trace_(activities=[ProfilerActivity.CUDA]) as prof:
            if mode == "warm_kernel":
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            if mode in ("host_sleep", "both"):
                time.sleep(cs.TRACE_SETTLE_S)
            if mode in ("device_sleep", "both"):
                torch.cuda._sleep(100_000_000)
            one()
            torch.cuda.synchronize()
        got = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = ck.kernel_of(evt.name)
                if name:
                    got[name] = got.get(name, 0) + 1
        return got

    for rnd in range(2):
        for mode in MODES:
            short = [(i, got) for i in range(n)
                     for got in [traced(mode)] if got != want]
            print(f"round {rnd + 1}, mode {mode}: {len(short)} of {n} "
                  f"traces short of {want}; first: {short[:3]} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
