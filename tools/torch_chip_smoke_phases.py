#!/usr/bin/env python3
"""Phases 11 (serving), 12 (speculative decoding), 13 (the
mixture-of-experts LM), 14 (the mesh of one), 15 (the LM on a mesh), 16
(the runtime around the step: prefetch, device metrics, the sentinel, the
preemption drill) and 17 (mixed precision: the fp16 conv + batch-norm
kernels, the AMP steps with the loss scaler and the deferred gate) of
``chip_smoke.py`` alone, on one card: a quicker look at those paths than
the whole script.

    python3 tools/torch_chip_smoke_phases.py [11] [12] [13] [14] [15] [16]
        [17]

A phase may be named more than once (``12 12 12`` runs phase 12 three
times in one process). With no argument it runs 12 to 17. It
builds the port's kernels first (phase 1 of the script: phases 13 and 15
run the flash-attention kernels, phase 14 the conv + batch-norm and
epilogue kernels, phase 16 the conv + batch-norm kernels, phase 17 both
routes' kernels in fp16 and bf16) and exits with
the script's failure code at the first failed gate.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main(which) -> int:
    if not torch.cuda.is_available():
        print("torch_chip_smoke_phases: no CUDA device available",
              file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    models, ck, _build = c.port()
    mx, config, _resnet, _nn_ops = c.port_gluon()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = c.build_phase(_build)
    ps, cs = c.port_capture()
    serving, sd, lat = c.port_serving()
    for phase in which:
        t0 = time.perf_counter()
        ck.reset_launch_counts()
        if phase == "11":
            decode, _model, _params = c.decode_storm_phase(sd, lat,
                                                           card_line)
            del _model, _params
            out = {"decode": decode,
                   "oneshot": c.oneshot_nets_phase(serving, mx, card_line)}
        elif phase == "12":
            out = c.spec_phase(sd, lat, ck, card_line)
        elif phase == "13":
            counts, traced = {}, {}
            out = c.moe_phase(models, cs, ck, config, card_line, counts,
                              traced)
            print(f"phase 13 launch counts of the MoE runs {counts}, traced "
                  f"in the replays {traced}")
        elif phase == "14":
            counts, traced = {}, {}
            out = c.mesh_phase(mx, ps, cs, ck, _resnet, config, card_line,
                               counts, traced)
            print(f"phase 14 launch counts of the kvstore and planned runs "
                  f"{counts}, traced in the replays {traced}")
        elif phase == "15":
            counts, traced = {}, {}
            out = c.mesh_lm_phase(models, cs, ck, config, card_line, counts,
                                  traced)
            print(f"phase 15 launch counts of the mesh and pp runs {counts}, "
                  f"traced in the replays {traced}")
        elif phase == "16":
            counts, traced = {}, {}
            out = c.runtime_phase(mx, ck, config, card_line, counts, traced)
            print(f"phase 16 launch counts of the pipelined, synchronous and "
                  f"sentinel runs {counts}, traced in the replay {traced}")
        elif phase == "17":
            counts, traced = {}, {}
            out = c.amp_phase(mx, ck, config, card_line, counts, traced)
            print(f"phase 17 launch counts of the AMP steps {counts}, traced "
                  f"in the replays {traced}")
        else:
            print(f"torch_chip_smoke_phases: no phase {phase}",
                  file=sys.stderr)
            return 2
        print(json.dumps({f"phase_{phase}": out}, default=str), flush=True)
        print(f"phase {phase} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
    print(f"phases {' '.join(which)} ok [{card_line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["12", "13", "14", "15", "16", "17"]))
