#!/usr/bin/env python3
"""Gate: the ResNet routes send every fusible conv + batch-norm site through
the port's fused path, its kernels launch as often as the sites ask, and
the retired int8 route refuses.

    python3 tools/torch_check_fusion_budget.py [--device cuda|cpu]

The port of ``tools/check_fusion_budget.py`` in the port's terms: the port
compiles no XLA fusions to count, so where the reference counts fusions
and a ``pallas_call`` marker, this gate counts the routed sites and, on
the card, the kernels' launches in a replayed step.

- **fused** (reference :20-26, :117-180): on each route (unfused; the
  epilogue, ``MXNET_FUSED_EPILOGUE``; conv + BN, ``MXNET_FUSED_CONV_BN``;
  mode 1 on the card, 2 on the CPU, where the kernels' plain versions
  run) one recorded training forward of the hybridized net routes every
  fusible site (``resnet.fused_epilogue_counts()``,
  ``basic_layers.fused_conv_bn_counts()``) as the net's structure says:
  each ``BottleneckV1`` has two 1x1 sites plus its downsample and one 3x3
  site, and every other conv + BN pair (the 7x7 stem) is refused by the
  conv + BN route. The fused loss matches the unfused one within
  ``chip_smoke.py``'s fp32 step-1 bound (relative 1e-5).
- **launches**, on the card only (the wrappers run their plain versions
  on the CPU): the bf16 net's step through ``Trainer.compile_step`` is
  captured, then one replay is traced by kernel name
  (``cuda_kernels.kernel_of``): at ResNet-50 v1's full width (224², the
  model zoo's net) the epilogue route launches ``matmul_stats`` (B5) and
  ``matmul_epilogue`` (B6) 36 times each, the conv + BN route
  ``matmul_bn_stats`` (B4) 36 times and ``convkxk_bn_stats`` (B8) 16
  times, and the unfused route none of them.
- **int8** (:269): ``MXNET_INT8_PALLAS=1`` refuses with the port's error
  (which names where the int8 kernel is measured), and the default path
  counts every conv the retired route would have claimed
  (``quantization.pallas_skipped_count``).

The reference's **pad** lane (:253, ``MXNET_PAD_CHANNELS``) stays out: the
port does not pad channels, by design (ROADMAP "Differences by design").
The reference's own gate is red (``test_fusion_budget_gate``), so the
port's is held to the reference's site routing, which the tests compute
on the narrow net, not to that gate's exit code.

Prints one JSON line a lane and exits 1 when a check fails.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools.torch_check_dispatch_budget import knobs  # noqa: E402

ROUTES = ("unfused", "epilogue", "conv_bn")
KNOBS = {"epilogue": "MXNET_FUSED_EPILOGUE", "conv_bn": "MXNET_FUSED_CONV_BN"}
# chip_smoke.py's bound on the fused step-1 fp32 loss against the unfused
FIRST_LOSS_RTOL = 1e-5
# the kernels of the fused routes (ops.cuda_kernels wrapper names)
KERNELS = ("matmul_stats", "matmul_epilogue", "matmul_bn_stats",
           "convkxk_bn_stats")
NETS = {"resnet50": {"image": 224, "batch": 4, "classes": 1000},
        "narrow": {"image": 16, "batch": 2, "classes": 10}}
# a traced replay's first records can be lost (PERF.md §6): each trace
# first runs this many marker kernels and one long one
TRACE_PREFIX = 1024


def route_knobs(route: str, device: str) -> dict:
    """The knobs of ``route``: its own at mode 1 (the card) or 2 (the
    CPU), the other off."""
    mode = 1 if device == "cuda" else 2
    return {k: (mode if r == route else 0) for r, k in KNOBS.items()}


def build_net(device: str, net: str = "resnet50", seed: int = 0):
    """(the hybridized NHWC ResNet v1, its initial values, a seeded batch):
    the model zoo's resnet50_v1, or the narrow bottleneck net of the port's
    tests (layers [2, 1], channels [8, 32, 64]); Xavier from a seeded
    generator, probed once."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    shape = NETS[net]
    ctx = mx.cpu() if device == "cpu" else mx.gpu(0)
    if net == "resnet50":
        m = mx.gluon.model_zoo.get_model("resnet50_v1", classes=1000,
                                         layout="NHWC", input_layout="NHWC",
                                         ctx=ctx)
    else:
        m = resnet.ResNetV1(resnet.BottleneckV1, [2, 1], [8, 32, 64],
                            classes=shape["classes"], layout="NHWC",
                            input_layout="NHWC")
    m.initialize(mx.initializer.Xavier(
        generator=torch.Generator().manual_seed(seed)), ctx=ctx)
    rng = onp.random.RandomState(seed)
    n, hw = shape["batch"], shape["image"]
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    x = torch.tensor(rng.randn(n, hw, hw, 3), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.randint(0, shape["classes"], n),
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        m(x[:2])
    m.hybridize()
    init = {k: p.data().clone() for k, p in m.collect_params().items()}
    return m, init, x, y


def expected_sites(net) -> dict:
    """The sites each route must take, from the net's structure:
    ``epilogue`` {fused, refused}, ``conv_bn`` {1x1, kxk, refused}."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    blocks = []
    pairs = 0

    def walk(b):
        nonlocal pairs
        if isinstance(b, resnet.BottleneckV1):
            blocks.append(b)
        kids = list(b._children.values())
        for a, c in zip(kids, kids[1:]):
            if isinstance(a, nn.Conv2D) and isinstance(c, nn.BatchNorm):
                pairs += 1
        for k in kids:
            walk(k)

    walk(net)
    one = sum(2 + (b.downsample is not None) for b in blocks)
    return {"unfused": {"epilogue": {"fused": 0, "refused": 0},
                        "conv_bn": {"1x1": 0, "kxk": 0, "refused": 0}},
            "epilogue": {"epilogue": {"fused": one, "refused": 0},
                         "conv_bn": {"1x1": 0, "kxk": 0, "refused": 0}},
            "conv_bn": {"epilogue": {"fused": 0, "refused": 0},
                        "conv_bn": {"1x1": one, "kxk": len(blocks),
                                    "refused": pairs - one - len(blocks)}}}


def expected_launches(sites: dict) -> dict:
    """A step's launches of the fused kernels on each route."""
    epi, cbn = sites["epilogue"]["epilogue"], sites["conv_bn"]["conv_bn"]
    return {"unfused": {},
            "epilogue": {"matmul_stats": epi["fused"],
                         "matmul_epilogue": epi["fused"]},
            "conv_bn": {"matmul_bn_stats": cbn["1x1"],
                        "convkxk_bn_stats": cbn["kxk"]}}


def site_counts() -> dict:
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.gluon.nn import basic_layers

    return {"epilogue": resnet.fused_epilogue_counts(),
            "conv_bn": basic_layers.fused_conv_bn_counts()}


def _delta(a: dict, b: dict) -> dict:
    return {g: {k: b[g][k] - a[g][k] for k in b[g]} for g in b}


def forward_route(net, init, x, y, route: str, device: str):
    """One recorded training forward of ``net`` from ``init`` on
    ``route`` (the eager tape: MXNET_COMPILED_STEP=0 runs the hybridized
    forward traced, once): (the mean loss in fp64, its sites)."""
    import mxnet_tpu_torch as mx

    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with knobs(MXNET_COMPILED_STEP=0, **route_knobs(route, device)):
        net.load_dict(init)
        s0 = site_counts()
        with mx.autograd.record():
            loss = ce(net(x), y)
        s1 = site_counts()
    return float(loss.detach().double().mean()), _delta(s0, s1)


def net_of(device: str) -> str:
    """ResNet-50 on the card, the narrow net on the CPU."""
    return "resnet50" if device == "cuda" else "narrow"


def measure_fused(device: str = "cuda") -> dict:
    """The fused lane: each route's sites and loss."""
    net_name = net_of(device)
    net, init, x, y = build_net(device, net_name)
    want = expected_sites(net)
    rows = {}
    for route in ROUTES:
        loss, sites = forward_route(net, init, x, y, route, device)
        rows[route] = {"loss": loss, "sites": sites}
    ul = rows["unfused"]["loss"]
    return {
        "mode": "fused", "device": device, "net": net_name,
        "batch": int(x.shape[0]), "image": int(x.shape[1]),
        "expected_sites": want,
        "sites": {r: rows[r]["sites"] for r in ROUTES},
        "losses": {r: rows[r]["loss"] for r in ROUTES},
        "loss_rel_diff": {r: abs(rows[r]["loss"] - ul) / abs(ul)
                          for r in ROUTES if r != "unfused"},
    }


def fused_failures(row: dict) -> list:
    failures = []
    for route in ROUTES:
        if row["sites"][route] != row["expected_sites"][route]:
            failures.append(
                f"{route} route: sites {row['sites'][route]}, the net's "
                f"structure asks {row['expected_sites'][route]}")
    for route, d in row["loss_rel_diff"].items():
        if not d <= FIRST_LOSS_RTOL:
            failures.append(
                f"{route} route: fused loss {row['losses'][route]} against "
                f"unfused {row['losses']['unfused']} (relative {d:.3e} > "
                f"{FIRST_LOSS_RTOL})")
    return failures


def _traced(ck, fn) -> dict:
    """fn() under a profiler tracing the device: the port's kernels it
    launched, by wrapper name, after a settle and a marker prefix (a
    trace can lose its first records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        for _ in range(TRACE_PREFIX):
            torch.cuda._sleep(1)
        torch.cuda._sleep(1 << 24)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = ck.kernel_of(evt.name)
            if name:
                out[name] = out.get(name, 0) + 1
    return out


def measure_launches() -> dict:
    """On the card: ResNet-50 in bf16 at 224², ``NETS["resnet50"]``'s
    batch, through ``compile_step`` on each route: the capture, then one
    replay traced by kernel name; the sites of each call."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    net, _init, x, y = build_net("cuda", "resnet50")
    want_sites = expected_sites(net)
    want = expected_launches(want_sites)
    net.cast("bfloat16")
    init = {k: p.data().clone() for k, p in net.collect_params().items()}
    batch = NETS["resnet50"]["batch"]
    rng = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, 224, 224, 3), generator=rng, device="cuda",
                    dtype=torch.bfloat16)
    y = y[:1].repeat(batch)
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rows = {}
    for route in ROUTES:
        with knobs(MXNET_COMPILED_STEP=1, **route_knobs(route, "cuda")):
            net.load_dict(init)
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 1e-3,
                                        "momentum": 0.9, "wd": 1e-4})
            step = trainer.compile_step(net, lambda n, a, b: ce(n(a), b))
            s0 = site_counts()
            step(x, y)                      # the eager run and the capture
            s1 = site_counts()
            traced = _traced(ck, lambda: step(x, y))
            s2 = site_counts()
            rows[route] = {
                "compiled": step.last_step_compiled,
                "capture_sites": _delta(s0, s1),
                "replay_sites": _delta(s1, s2),
                "traced": {k: traced.get(k, 0) for k in KERNELS},
                "want": {k: want[route].get(k, 0) for k in KERNELS},
                "want_capture_sites": {g: {k: 2 * v for k, v in d.items()}
                                       for g, d in want_sites[route].items()},
            }
        del step, trainer
        torch.cuda.empty_cache()
    return {"mode": "launches", "device": "cuda", "net": "resnet50",
            "batch": batch, "image": 224, "dtype": "bf16", "routes": rows}


def launches_failures(row: dict) -> list:
    failures = []
    for route, r in row["routes"].items():
        if not r["compiled"]:
            failures.append(f"{route}: the step ran the eager tape")
        if r["traced"] != r["want"]:
            failures.append(f"{route}: a replay launched {r['traced']}, "
                            f"the route asks {r['want']}")
        if r["capture_sites"] != r["want_capture_sites"]:
            failures.append(f"{route}: the first call routed "
                            f"{r['capture_sites']}, want "
                            f"{r['want_capture_sites']} (its eager run "
                            "and its capture)")
        if any(v for d in r["replay_sites"].values() for v in d.values()):
            failures.append(f"{route}: a replay ran Python of the body "
                            f"({r['replay_sites']})")
    return failures


def measure_int8(device: str = "cuda") -> dict:
    """The retired int8 route: the knob refuses; the default path counts
    the convs the route would have claimed."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.contrib import quantization as q

    rng = onp.random.RandomState(5)
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    qd = torch.tensor(rng.randint(-127, 128, (2, 8, 8, 32)),
                      dtype=torch.int8, device=dev)
    qw = torch.tensor(rng.randint(-127, 128, (64, 1, 1, 32)),
                      dtype=torch.int8, device=dev)
    kw = dict(kernel=(1, 1), num_filter=64, layout="NHWC", no_bias=True,
              data_scale=0.02, w_scale=0.015)
    with knobs(MXNET_INT8_PALLAS=None):
        s0 = q.pallas_skipped_count()
        q.quantized_conv([qd, qw], **kw)
        skips = q.pallas_skipped_count() - s0
    refused, names = False, False
    with knobs(MXNET_INT8_PALLAS=1):
        try:
            q.quantized_conv([qd, qw], **kw)
        except MXNetError as e:
            refused = True
            names = "B7" in str(e) and "chip_smoke.py" in str(e)
    return {"mode": "int8", "device": device, "skips_counted": skips,
            "knob_refused": refused, "refusal_names_measurement": names}


def int8_failures(row: dict) -> list:
    failures = []
    if not row["knob_refused"]:
        failures.append("MXNET_INT8_PALLAS=1 did not refuse")
    if not row["refusal_names_measurement"]:
        failures.append("the int8 refusal does not name where the kernel "
                        "is measured")
    if row["skips_counted"] < 1:
        failures.append("an eligible int8 conv did not count a skip")
    return failures


def _line(row: dict) -> str:
    return f"torch_check_fusion_budget: {json.dumps(row, default=str)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_check_fusion_budget: no CUDA device (pass "
                  "--device cpu)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx

    failures = []
    with mx.cpu() if a.device == "cpu" else contextlib.nullcontext():
        fused = measure_fused(a.device)
        print(_line(fused))
        failures += [f"fused: {f}" for f in fused_failures(fused)]
        if a.device == "cuda":
            launches = measure_launches()
            print(_line(launches))
            failures += [f"launches: {f}"
                         for f in launches_failures(launches)]
        int8 = measure_int8(a.device)
        print(_line(int8))
        failures += [f"int8: {f}" for f in int8_failures(int8)]
    if failures:
        print("torch_check_fusion_budget: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("torch_check_fusion_budget: every fusible site routed, the "
          "fused losses within the unfused bound"
          + (", the replays' launches as the routes ask"
             if a.device == "cuda" else "") + ", the int8 route refused")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
