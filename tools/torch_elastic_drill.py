#!/usr/bin/env python3
"""Preemption and restart of a compiled ResNet train loop in real
processes: the elastic drill of the PyTorch/CUDA port.

    python3 tools/torch_elastic_drill.py [--device cuda|cpu]
        [--net resnet50|narrow] [--steps 12] [--save-every 4]
        [--kill-at 7] [--dir DIR] [--twice]

Three children run, each a fresh ``python3`` of this file (``--child
...``), over one checkpoint directory: the first two side by side, the
third after them:

1. ``plain``: ``--steps`` steps of ``Trainer.compile_step`` without
   interruption (with ``--twice`` a second one, to measure whether two
   processes agree bitwise).
2. ``preempt``: ``run_elastic(preemption=True)`` with
   ``CheckpointManager(async_save=True)`` every ``--save-every`` steps; the
   child sends itself SIGTERM right after dispatching step ``--kill-at``.
   The handler only flags the drain; the loop drains at the step's end
   (``engine.waitall()``), force-saves the last completed step blocking,
   and exits with the preemption code.
3. ``restart``: the same loop restores the latest checkpoint, pushes it
   into the live parameters and optimizer states in place
   (``Trainer.load_state_tree``) and finishes.

The net is the Gluon ResNet-50 v1 (NHWC, bf16 at batch 128 and 224x224
on the card, ``MXNET_FUSED_CONV_BN=1``: the B4 and B8 kernels) or, for
the CPU tests, a narrow ResNet v1 in fp32 through the kernels' plain
versions. Weights are Xavier from seed 0; step i's batch comes from
numpy seed 1000 + i. Every child writes its final parameters and
optimizer states (``final-<child>.pt``) and a JSON record; the parent
(:func:`drill`) checks: the preempted child exited with the preemption
code at the step after the kill, the restart replayed 0 steps, the
restored state's sha256 is the saved one, the final state is bitwise the
uninterrupted child's, no temp file is left, the kernels launched in
every child; and it reads ``telemetry.merge`` of the three children's
flight-recorder shards (``elastic.recovery_s``, ``preemption.drain_s``).
It prints one JSON line and exits 1 if a gate fails.
"""
import argparse
import concurrent.futures
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

T_START = time.time()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NETS = {
    # name: (layers, channels, classes, batch, image, dtype, conv+BN knob
    #        mode on the device it runs)
    "resnet50": (None, None, 1000, 128, 224, "bfloat16", 1),
    "narrow": ([2, 1], [8, 32, 64], 10, 4, 16, "float32", 2),
}
LR, MOMENTUM, WD = 1e-3, 0.9, 1e-4


def batch(i, net_name, device):
    _l, _c, classes, n, image, dtype, _m = NETS[net_name]
    rng = np.random.RandomState(1000 + i)
    x = torch.from_numpy(rng.randn(n, image, image, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, classes, n).astype(np.float32))
    if device == "cuda":
        x, y = x.pin_memory(), y.pin_memory()
    return (x.to(device, getattr(torch, dtype), non_blocking=True),
            y.to(device, non_blocking=True))


def build(net_name, device):
    """(mx, net, trainer, step) from seed 0, hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    layers, channels, classes, _n, image, dtype, _m = NETS[net_name]
    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    if layers is None:
        net = mx.gluon.model_zoo.get_model(
            "resnet50_v1", classes=classes, layout="NHWC",
            input_layout="NHWC", ctx=ctx)
    else:
        net = resnet.ResNetV1(resnet.BottleneckV1, layers, channels,
                              classes=classes, layout="NHWC",
                              input_layout="NHWC")
    net.initialize(mx.initializer.Xavier(
        generator=torch.Generator().manual_seed(0)), ctx=ctx)
    with torch.no_grad():
        net(torch.zeros(2, image, image, 3, device=device))
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR, "momentum": MOMENTUM,
                                "wd": WD})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(net, lambda n, a, b: ce(n(a), b))
    return mx, net, trainer, step


def state_sha(tree) -> str:
    """sha256 over the bytes of every tensor of a state tree, in order."""
    from mxnet_tpu_torch._pytree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def child(args) -> int:
    """One child: ``plain``, ``preempt`` or ``restart`` (see the module
    docstring). Writes ``<dir>/child-<name>.json`` and
    ``final-<name>.pt``."""
    os.environ["MXNET_FUSED_CONV_BN"] = str(NETS[args.net][6])
    os.environ["MXNET_TELEMETRY_DIR"] = os.path.join(args.dir, "telemetry")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mx, net, trainer, step = build(args.net, args.device)
    from mxnet_tpu_torch import cached_step, engine, preemption, telemetry
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.parallel import elastic

    ck.reset_launch_counts()
    cached_step.reset_counters()
    live = trainer.state_tree(net)
    rec = {"child": args.child, "pid": os.getpid(), "t_start": T_START,
           "steps_done": 0}

    def step_fn(state, i):
        x, y = batch(i, args.net, args.device)
        step(x, y)
        rec["steps_done"] = i + 1
        if "t_first_step" not in rec:
            engine.synchronize()
            rec["t_first_step"] = time.time()
            rec["first_step"] = i + 1
        if args.child == "preempt" and i + 1 == args.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return state

    def on_restore(tree, at):
        rec["restored_step"] = at
        rec["restored_sha"] = state_sha(tree)
        trainer.load_state_tree(tree, net)
        return live

    code = 0
    ckdir = os.path.join(args.dir, "ckpt")
    if args.child.startswith("plain"):
        for i in range(args.steps):
            step_fn(live, i)
    else:
        mgr = elastic.CheckpointManager(ckdir, keep=3, async_save=True)
        try:
            elastic.run_elastic(step_fn, live, list(range(args.steps)), mgr,
                                save_every=args.save_every, max_restarts=0,
                                on_restore=on_restore,
                                preemption=args.child == "preempt")
        except preemption.Preempted as e:
            code = int(e.code)
            rec["saved_step"] = mgr.latest_step()
            rec["saved_sha"] = state_sha(live)
        rec["snapshot_stats"] = dict(mgr.snapshot_stats)
        mgr.close()
    engine.waitall()
    rec["launches"] = {k: v for k, v in ck.launch_counts().items() if v}
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    rec["sites"] = resnet.fused_conv_bn_counts()
    rec["captures"] = cached_step.trace_count()
    rec["dispatches"] = cached_step.dispatch_count()
    snap = telemetry.snapshot()
    rec["counters"] = {k: snap.get(k) for k in (
        "elastic.recovery_s", "elastic.restores", "elastic.steps_replayed",
        "preemption.drain_s", "preemption.notices")}
    rec["final_sha"] = state_sha(live)
    from mxnet_tpu_torch._pytree import tree_flatten, tree_unflatten

    leaves, struct = tree_flatten({"params": live["params"],
                                   "opt": live["opt"]})
    torch.save(tree_unflatten(struct, [t.detach().cpu() for t in leaves]),
               os.path.join(args.dir, f"final-{args.child}.pt"))
    telemetry.flush()
    with open(os.path.join(args.dir, f"child-{args.child}.json"), "w") as f:
        json.dump(rec, f, default=str)
    return code


def _run_child(args, name, timeout) -> tuple:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
           "--dir", args.dir, "--device", args.device, "--net", args.net,
           "--steps", str(args.steps), "--save-every", str(args.save_every),
           "--kill-at", str(args.kill_at)]
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    wall = time.time() - t0
    if p.returncode not in (0, 83) or p.stderr.strip():
        sys.stderr.write(p.stderr[-4000:])
    with open(os.path.join(args.dir, f"child-{name}.json")) as f:
        rec = json.load(f)
    rec.update(returncode=p.returncode, wall_s=wall, t_spawn=t0)
    return rec


def _final(args, name):
    return torch.load(os.path.join(args.dir, f"final-{name}.pt"))


def _max_dist(a, b) -> float:
    from mxnet_tpu_torch._pytree import tree_leaves

    worst = 0.0
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        worst = max(worst, float((u.double() - v.double()).abs().max()))
    return worst


def drill(args, kernels=("matmul_bn_stats", "convkxk_bn_stats"),
          timeout=600) -> dict:
    """Run the children and hold them to the gates; returns the record,
    with ``failures`` listing every missed gate. ``kernels`` must have
    launched in every child (none on the CPU, where the wrappers run their
    plain versions; the fused sites are held there)."""
    from mxnet_tpu_torch import preemption, telemetry

    os.makedirs(args.dir, exist_ok=True)
    code = preemption.exit_code()
    # the uninterrupted children run beside the preempted one (they share
    # no file but the telemetry directory, where each writes its own
    # shard); the restart runs alone, so that its recovery wall is its own
    first = ["plain"] + (["plain2"] if args.twice else []) + ["preempt"]
    with concurrent.futures.ThreadPoolExecutor(len(first)) as ex:
        futs = {n: ex.submit(_run_child, args, n, timeout) for n in first}
        recs = {n: f.result() for n, f in futs.items()}
    recs["restart"] = _run_child(args, "restart", timeout)
    fails = []
    plain, pre, rst = recs["plain"], recs["preempt"], recs["restart"]
    if plain["returncode"] != 0 or rst["returncode"] != 0:
        fails.append("a child failed: " + str(
            {n: r["returncode"] for n, r in recs.items()}))
    if pre["returncode"] != code:
        fails.append(f"preempted child exited {pre['returncode']}, "
                     f"want {code}")
    if pre.get("saved_step") != args.kill_at or \
            pre["steps_done"] != args.kill_at:
        fails.append(f"drain saved step {pre.get('saved_step')} after "
                     f"{pre['steps_done']} steps; want {args.kill_at}")
    if rst.get("restored_step") != args.kill_at:
        fails.append(f"restart restored step {rst.get('restored_step')}")
    if rst["counters"]["elastic.steps_replayed"] != 0:
        fails.append(f"replayed {rst['counters']['elastic.steps_replayed']}")
    if rst.get("restored_sha") != pre.get("saved_sha"):
        fails.append("restored state hash differs from the saved one")
    a, b = _final(args, "plain"), _final(args, "restart")
    dist = _max_dist(a, b)
    if rst["final_sha"] != plain["final_sha"]:
        fails.append(f"final state differs from the uninterrupted child "
                     f"(max |d| {dist})")
    twice = None
    if args.twice:
        twice = _max_dist(a, _final(args, "plain2"))
    leaked = [f for f in os.listdir(os.path.join(args.dir, "ckpt"))
              if ".tmp" in f]
    if leaked:
        fails.append(f"temp files left behind: {leaked}")
    for n, r in recs.items():
        missing = [k for k in kernels if not r["launches"].get(k)]
        if missing:
            fails.append(f"child {n}: {missing} never launched")
        if not (r["sites"].get("1x1") and r["sites"].get("kxk")):
            fails.append(f"child {n}: no fused conv + BN site ran "
                         f"({r['sites']})")
    merged = telemetry.merge(os.path.join(args.dir, "telemetry"))
    for k in ("elastic.recovery_s", "preemption.drain_s"):
        if not merged["counters"].get(k):
            fails.append(f"telemetry.merge holds no {k}")
    out = {
        "children": {n: {k: r.get(k) for k in (
            "returncode", "wall_s", "steps_done", "captures", "dispatches",
            "launches", "sites", "counters", "snapshot_stats",
            "restored_step",
            "saved_step")} for n, r in recs.items()},
        "recovery_wall_s": rst["t_first_step"] - rst["t_spawn"],
        "first_resumed_step": rst.get("first_step"),
        "restore_ms": 1e3 * rst["counters"]["elastic.recovery_s"],
        "drain_ms": 1e3 * pre["counters"]["preemption.drain_s"],
        "captures_on_restart": rst["captures"],
        "steps_replayed": rst["counters"]["elastic.steps_replayed"],
        "final_bitwise": rst["final_sha"] == plain["final_sha"],
        "final_max_abs_diff": dist,
        "two_uninterrupted_max_abs_diff": twice,
        "merged_counters": {k: merged["counters"].get(k) for k in (
            "elastic.recovery_s", "preemption.drain_s",
            "elastic.restores", "preemption.notices")},
        "shards": merged["shards"],
        "failures": fails,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--child", default=None)
    p.add_argument("--dir", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--net", default="resnet50", choices=sorted(NETS))
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--save-every", type=int, default=4)
    p.add_argument("--kill-at", type=int, default=7)
    p.add_argument("--twice", action="store_true",
                   help="run the uninterrupted child twice and report the "
                        "distance between the two")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_elastic_drill: no CUDA device available",
              file=sys.stderr)
        return 1
    if args.child is not None:
        return child(args)
    kernels = () if args.device == "cpu" else ("matmul_bn_stats",
                                               "convkxk_bn_stats")
    if args.dir is None:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="elastic-drill-") as d:
            args.dir = d
            out = drill(args, kernels=kernels)
    else:
        out = drill(args, kernels=kernels)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
