"""The port's recorded hybridized forward (``gluon.block``: a hybridized
block called under ``autograd.record()`` as one graphed tape node,
``_GraphedNode`` over ``program_store.VjpProgram``) held against the port's
eager tape (the same net with ``hybridize(False)``) and against the JAX
package's recorded node (``mxnet_tpu/gluon/block.py:659-689``) on the CPU,
where the node's programs run their bodies through the static buffers:

- gradients of every parameter and of the input, and the running
  statistics, on the narrow bottleneck ResNet: bitwise against the eager
  tape on the unfused route, within the fused route's bounds of the
  reference on the fused routes (an eager net that is not hybridized runs
  unfused in both packages);
- two calls before one backward (the second runs eagerly and names its
  reason), ``grad_req='add'``, a dropped output, a backward through a
  replaced call, a second-order backward (``tests/test_autograd_
  advanced.py:159``), and a call where nothing takes a gradient;
- one capture, then one dispatch a call.

The ``cuda``-marked tests replay the node's graphs on the card against
the eager tape and skip without one.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

from test_torch_gluon_resnet import (CHANNELS, CLASSES, LAYERS, STEP_TOL,
                                     _narrow_pair)
from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jmx = LazyModule("mxnet_tpu")
jag = LazyModule("mxnet_tpu.autograd")
jconfig = LazyModule("mxnet_tpu.config")
jgluon = LazyModule("mxnet_tpu.gluon")

ROUTES = {"unfused": {}, "epilogue": {"MXNET_FUSED_EPILOGUE": "2"},
          "conv_bn": {"MXNET_FUSED_CONV_BN": "2"}}
# the fused routes' gradients against the reference's: one fused conv +
# BN pair's fp32 sums in other orders, through the net (the bound of
# test_torch_fused_conv_bn.py)
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-3)


def _knobs(monkeypatch, configs):
    names = []

    def set_(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
            for c in configs:
                c.refresh(k)
            names.append(k)

    yield set_
    for k in names:
        monkeypatch.delenv(k, raising=False)
        for c in configs:
            c.refresh(k)


@pytest.fixture
def knobs(monkeypatch):
    """set(**env): knobs in both packages, undone after."""
    yield from _knobs(monkeypatch, (jconfig, tconfig))


@pytest.fixture
def port_knobs(monkeypatch):
    """set(**env): knobs of the port only (the card has no reference)."""
    yield from _knobs(monkeypatch, (tconfig,))


def _batch(n=2, seed=0, hw=16):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, hw, hw, 3).astype(onp.float32),
            rng.randint(0, CLASSES, n).astype(onp.float32))


def _net(seed=0, device="cpu"):
    net = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                           classes=CLASSES, layout="NHWC", input_layout="NHWC")
    net.initialize(tmx.initializer.Xavier(
        generator=torch.Generator().manual_seed(seed)),
        ctx=tmx.cpu() if device == "cpu" else tmx.gpu(0))
    with torch.no_grad():
        net(torch.from_numpy(_batch()[0]).to(device))
    return net


def _twin(net):
    twin = _net(device=next(iter(net.collect_params().values()))
                ._data.device.type)
    twin.load_dict({k: p.data().clone()
                    for k, p in net.collect_params().items()})
    return twin


_ce = tgluon.loss.SoftmaxCrossEntropyLoss()


def _grads_and_state(net, x, y, calls=1):
    """``calls`` recorded forwards of the loss summed, one backward:
    (loss, input gradient, parameter gradients, all parameter values)."""
    x = x.clone().requires_grad_()
    with tag.record():
        loss = sum(_ce(net(x), y) for _ in range(calls))
    tag.backward(loss)
    params = net.collect_params()
    return ([loss.detach(), x.grad]
            + [p.grad() for p in params.values() if p.grad_req != "null"]
            + [p.data().clone() for p in params.values()])


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i


# ---------------------------------------------------------------------------
# against the eager tape and the reference
# ---------------------------------------------------------------------------


def test_recorded_node_equals_the_eager_tape_bitwise():
    x, y = (torch.from_numpy(a) for a in _batch())
    net = _net()
    twin = _twin(net)
    net.hybridize()
    ns = tps.namespace("hybrid_forward")
    t0, d0 = ns.traces, ns.dispatches
    for i in range(3):
        got = _grads_and_state(net, x, y)
        want = _grads_and_state(twin, x, y)
        assert net.last_eager_reason is None
        _assert_bitwise(got, want)
    assert (ns.traces - t0, ns.dispatches - d0) == (1, 3)


@pytest.mark.parametrize("route", list(ROUTES))
def test_recorded_node_matches_the_jax_recorded_node(route, knobs):
    """Both packages hybridized, one recorded forward and backward and an
    SGD step, 3 times: logits, input and parameter gradients, running
    statistics and parameters against the reference's; the fused sites a
    call as the reference's trace fuses them."""
    knobs(**ROUTES[route])
    x, y = _batch()
    jnet, tnet = _narrow_pair(x)
    jnet.hybridize()
    tnet.hybridize()
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tol = STEP_TOL if route == "unfused" else FUSED_GRAD_TOL
    for step in range(3):
        jx = jmx.nd.array(x)
        jx.attach_grad()
        with jag.record():
            jl = jce(jnet(jx), jmx.nd.array(y))
        jl.backward()
        tx = torch.from_numpy(x).requires_grad_()
        tresnet.reset_fused_epilogue_counts()
        tresnet.reset_fused_conv_bn_counts()
        with tag.record():
            tl = _ce(tnet(tx), torch.from_numpy(y))
        tag.backward(tl)
        assert tnet.last_eager_reason is None
        if route == "epilogue":
            assert tresnet.fused_epilogue_counts()["fused"] == 8
        if route == "conv_bn":
            assert tresnet.fused_conv_bn_counts() == \
                {"1x1": 8, "kxk": 3, "refused": 1}
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    err_msg=f"loss {step}", **tol)
        onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                    err_msg=f"dx {step}", **tol)
        jparams = jnet.collect_params()
        for k, tp in tnet.collect_params().items():
            if tp.grad_req != "null":
                onp.testing.assert_allclose(
                    tp.grad().numpy(), jparams[k].grad().asnumpy(),
                    err_msg=f"grad {k} {step}", **tol)
        jtr.step(2)
        ttr.step(2)
    jparams = jnet.collect_params()
    for k, tp in tnet.collect_params().items():
        onp.testing.assert_allclose(tp.data().numpy(),
                                    jparams[k].data().asnumpy(),
                                    err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the cases around one graphed call
# ---------------------------------------------------------------------------


def test_two_calls_before_one_backward():
    """The program holds the activations of its last call only: a second
    call while the first's backward is pending runs eagerly and names its
    reason; the gradients are the eager tape's, and the running statistics
    move twice."""
    x, y = (torch.from_numpy(a) for a in _batch(seed=1))
    net = _net()
    twin = _twin(net)
    net.hybridize()
    _grads_and_state(net, x, y)                  # the program exists
    _grads_and_state(twin, x, y)
    got = _grads_and_state(net, x, y, calls=2)
    assert "awaits its backward" in net.last_eager_reason
    want = _grads_and_state(twin, x, y, calls=2)
    _assert_bitwise(got, want)
    _grads_and_state(net, x, y)                  # released: graphed again
    assert net.last_eager_reason is None


def test_grad_req_add_accumulates_through_the_node():
    x, y = (torch.from_numpy(a) for a in _batch(seed=2))
    net = _net()
    twin = _twin(net)
    net.hybridize()
    for n in (net, twin):
        for p in n.collect_params().values():
            if p.grad_req != "null":
                p.grad_req = "add"
    for _ in range(3):
        got = _grads_and_state(net, x, y)
        want = _grads_and_state(twin, x, y)
    assert net.last_eager_reason is None
    _assert_bitwise(got[2:], want[2:])


def test_a_dropped_output_releases_the_program():
    x, _ = _batch(seed=3)
    net = _net()
    net.hybridize()
    with tag.record():
        out = net(torch.from_numpy(x))
    del out
    with tag.record():
        out = net(torch.from_numpy(x))
    assert net.last_eager_reason is None
    assert type(out.grad_fn).__name__ == "_GraphedNodeBackward"


def test_backward_through_a_replaced_call_raises():
    """With ``retain_graph`` a call's node outlives its backward and may
    run it again; once a later call has replaced the program's
    activations, a backward through the first call raises instead of
    reading them."""
    x, _ = _batch(seed=4)
    net = _net()
    net.hybridize()
    w = net.collect_params()["output.weight"]
    with tag.record():
        first = net(torch.from_numpy(x)).sum()
    first.backward(retain_graph=True)
    g1 = w.grad().clone()
    first.backward(retain_graph=True)            # again: the same grads
    assert torch.equal(w.grad(), g1)
    with tag.record():
        second = net(torch.from_numpy(x)).sum()
    second.backward()
    with pytest.raises(RuntimeError, match="replaced its activations"):
        first.backward()


def test_second_order_backward_runs_eagerly():
    """create_graph through a hybridized block (test_autograd_advanced.py:
    159): d/dx of |d/dx sum(Dense(x)^2)|^2 = 8 x (W^T W)^2; the backward
    that builds a graph recomputes the forward eagerly and says so."""
    net = tgluon.nn.Dense(3, use_bias=False, in_units=4)
    net.initialize(ctx=tmx.cpu())
    net.hybridize()
    x = torch.from_numpy(onp.random.RandomState(0).rand(2, 4)
                         .astype(onp.float32)).requires_grad_()
    with tag.record():
        y = (net(x) ** 2).sum()
    (gx,) = torch.autograd.grad(y, [x], create_graph=True)
    z = (gx ** 2).sum()
    z.backward()
    assert "second-order" in net.last_eager_reason
    w = net.weight.data().numpy()
    wtw = w.T @ w
    onp.testing.assert_allclose(x.grad.numpy(),
                                8 * x.detach().numpy() @ (wtw @ wtw),
                                rtol=1e-4)


def test_second_order_backward_leaves_the_running_statistics():
    x, _ = _batch(seed=5)
    net = _net()
    net.hybridize()
    tx = torch.from_numpy(x).requires_grad_()
    with tag.record():
        y = (net(tx) ** 2).sum()
    stats = [p.data().clone() for k, p in net.collect_params().items()
             if "running" in k]
    (gx,) = torch.autograd.grad(y, [tx], create_graph=True)
    assert gx.requires_grad
    after = [p.data() for k, p in net.collect_params().items()
             if "running" in k]
    _assert_bitwise(stats, after)


def test_nothing_to_differentiate_runs_the_forward_program():
    """Under record, with no parameter taking a gradient and no input
    requiring one, the block runs its forward program (no tape node)."""
    x, _ = _batch(seed=6)
    net = _net()
    net.hybridize()
    for p in net.collect_params().values():
        p.grad_req = "null"
    with tag.record():
        out = net(torch.from_numpy(x))
    assert not out.requires_grad


@pytest.mark.parametrize("route", ["unfused", "conv_bn"])
def test_compiled_step_off_records_eagerly_fused_as_the_node(route,
                                                           port_knobs):
    """``MXNET_COMPILED_STEP=0``: a hybridized block under record runs its
    forward eagerly, naming the knob, still as the port's trace: the same
    fused sites and the same values as the graphed node, bitwise."""
    port_knobs(**ROUTES[route])
    x, y = (torch.from_numpy(a) for a in _batch(seed=7))
    net = _net()
    twin = _twin(net)
    net.hybridize()
    twin.hybridize()
    got = _grads_and_state(net, x, y)
    s0 = tresnet.fused_conv_bn_counts()
    port_knobs(MXNET_COMPILED_STEP="0")
    want = _grads_and_state(twin, x, y)
    s1 = tresnet.fused_conv_bn_counts()
    assert twin.last_eager_reason == "MXNET_COMPILED_STEP=0"
    assert net.last_eager_reason is None
    _assert_bitwise(got, want)
    if route == "conv_bn":
        assert s1["1x1"] - s0["1x1"] == 8 and s1["kxk"] - s0["kxk"] == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hold(a, b, c):
    """c against a where two eager runs a, b are bitwise equal, else
    within 3x their spread."""
    for u, v, w in zip(a, b, c):
        if torch.equal(u, v):
            assert torch.equal(w, u)
        else:
            assert (w - u).abs().max() <= 3 * (v - u).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_graphed_node_replays_like_the_eager_tape_on_card(cuda_device,
                                                          route, port_knobs):
    """Three graphed calls (a capture, then replays) against two eager
    runs (``MXNET_COMPILED_STEP=0``: the recorded forward run eagerly, as
    a trace, so fused alike) of the same net from the same weights."""
    port_knobs(**{k: "1" for k in ROUTES[route]})
    x, y = (torch.from_numpy(a).to(cuda_device) for a in _batch(8, hw=32))
    runs = []
    for graphed in (False, False, True):
        port_knobs(MXNET_COMPILED_STEP="1" if graphed else "0")
        net = _net(device="cuda")
        net.hybridize()
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
        out = []
        for _ in range(3):
            out += _grads_and_state(net, x, y)
            tr.step(8)
            if graphed:
                assert net.last_eager_reason is None
        torch.cuda.synchronize()
        runs.append(out)
    _hold(*runs)


@pytest.mark.cuda
def test_two_calls_and_grad_req_add_on_card(cuda_device, port_knobs):
    x, y = (torch.from_numpy(a).to(cuda_device) for a in _batch(4, hw=32))
    runs = []
    for graphed in (False, False, True):
        port_knobs(MXNET_COMPILED_STEP="1" if graphed else "0")
        net = _net(device="cuda")
        net.hybridize()
        out = _grads_and_state(net, x, y)
        out += _grads_and_state(net, x, y, calls=2)
        for p in net.collect_params().values():
            if p.grad_req != "null":
                p.grad_req = "add"
        out += _grads_and_state(net, x, y)
        out += _grads_and_state(net, x, y)
        torch.cuda.synchronize()
        runs.append(out)
    _hold(*runs)


class _GcProbe(torch.autograd.Function):
    """Identity that notes whether the cyclic garbage collector is on
    each time its forward or backward runs."""

    seen = []

    @staticmethod
    def forward(ctx, x):
        import gc
        _GcProbe.seen.append(("forward", gc.isenabled()))
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        import gc
        _GcProbe.seen.append(("backward", gc.isenabled()))
        return g.clone()


class _GcProbeNet(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = tgluon.nn.Dense(3, in_units=4)

    def forward(self, x):
        return self.dense(_GcProbe.apply(x))


@pytest.mark.cuda
def test_captures_hold_off_the_garbage_collector_on_card(cuda_device,
                                                         port_knobs):
    """A collection inside a capture could free a dead cycle holding
    another program's graph, and destroying a graph while a stream
    captures invalidates the capture: the graphed node's first call runs
    its forward and backward eagerly with the collector on, then captures
    each with it off, and turns it back on."""
    import gc
    port_knobs(MXNET_COMPILED_STEP="1")
    net = _GcProbeNet()
    net.initialize(ctx=cuda_device)
    net.hybridize()
    x = torch.randn(2, 4, device=cuda_device, requires_grad=True)
    _GcProbe.seen.clear()
    with tag.record():
        y = net(x).sum()
    tag.backward(y)
    torch.cuda.synchronize()
    assert _GcProbe.seen == [("forward", True), ("forward", False),
                             ("backward", True), ("backward", False)]
    assert gc.isenabled() and net.last_eager_reason is None
