"""The port's fused conv + batch-norm route (``MXNET_FUSED_CONV_BN``:
``gluon.nn.basic_layers.fused_conv_bn`` through ``ops.nn.fused_conv1x1_bn``
/ ``fused_convkxk_bn``) held against the JAX package's
(``BatchNorm._fused_conv_src`` and the ops ``_fused_conv1x1_bn`` /
``_fused_convkxk_bn``) with the knob at 2 in both packages: the reference's
Pallas kernels in its interpreter, the port's kernels' plain versions.

The reference's fused sites are counted by wrapping its op schemas, as its
own tests (tests/test_fused_conv_bn.py) count them.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import config as jconfig
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops.registry import get_op
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

from test_torch_gluon_resnet import (CLASSES, OUT_TOL, STEP_TOL,
                                     _narrow_pair, _numpy_params, _pair,
                                     _rand)

# fused sites of the narrow bottleneck ResNet (LAYERS [2, 1]) per forward:
# conv1 and conv3 of each of the 3 bottlenecks and the 2 downsamples are
# 1x1, the 3 bottlenecks' 3x3s are KxK; the 7x7/stride-2 stem is refused
SITES = {"1x1": 8, "kxk": 3, "refused": 1}
NO_SITES = {"1x1": 0, "kxk": 0, "refused": 0}
# gradients of one fused conv + BN pair, the two packages' fp32 sums in
# other orders (the reference's own fused-vs-unfused bound)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture
def knobs(monkeypatch):
    """set(name, value): an env knob in both packages; all undone after."""
    names = []

    def set_(name, value):
        monkeypatch.setenv(name, str(value))
        jconfig.refresh(name)
        tconfig.refresh(name)
        names.append(name)

    yield set_
    for name in names:
        monkeypatch.delenv(name, raising=False)
        jconfig.refresh(name)
        tconfig.refresh(name)


@contextlib.contextmanager
def reference_sites():
    """Counts of the reference's fused conv + BN op calls, by kind."""
    counts = {"1x1": 0, "kxk": 0}
    origs = []
    for kind in counts:
        schema = get_op(f"_fused_conv{kind}_bn")
        origs.append((schema, schema.fn))

        def counting(*a, _k=kind, _f=schema.fn, **kw):
            counts[_k] += 1
            return _f(*a, **kw)

        schema.fn = counting
    try:
        yield counts
    finally:
        for schema, fn in origs:
            schema.fn = fn


def _step_both(jnet, tnet, x, y, jtr=None, ttr=None):
    """One recorded forward and backward of each net on the same batch
    (and an SGD step where trainers are given): (jax logits, jax loss,
    port logits, port loss, port site counts)."""
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        jout = jnet(jmx.nd.array(x))
        jl = jloss_fn(jout, jmx.nd.array(y))
    jl.backward()
    tresnet.reset_fused_conv_bn_counts()
    with tag.record():
        tout = tnet(torch.from_numpy(x))
        tl = tloss_fn(tout, torch.from_numpy(y))
    tag.backward(tl)
    if jtr is not None:
        jtr.step(x.shape[0])
        ttr.step(x.shape[0])
    return (jout.asnumpy(), jl.asnumpy(), tout.detach().numpy(),
            tl.detach().numpy(), tresnet.fused_conv_bn_counts())


def _narrow_hybridized(x):
    jnet, tnet = _narrow_pair(x)
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet


def _batch():
    rng = onp.random.RandomState(0)
    return (rng.randn(2, 16, 16, 3).astype(onp.float32),
            onp.array([3, 7], onp.float32))


def test_narrow_resnet_three_fused_conv_bn_sgd_steps_match_jax(knobs):
    knobs("MXNET_FUSED_CONV_BN", 2)
    x, y = _batch()
    jnet, tnet = _narrow_hybridized(x)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    for step in range(3):
        with reference_sites() as ref:
            jo, jl, to, tl, sites = _step_both(jnet, tnet, x, y, jtr, ttr)
        if step == 0:   # the reference traces its first call only
            assert ref == {"1x1": SITES["1x1"], "kxk": SITES["kxk"]}
        assert sites == SITES, step
        onp.testing.assert_allclose(to, jo, err_msg=f"logits, step {step}",
                                    **STEP_TOL)
        onp.testing.assert_allclose(tl, jl, err_msg=f"loss, step {step}",
                                    **STEP_TOL)
    assert float(tl.mean()) < 0.5      # the batch is being fitted
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    for name, tp in tparams.items():
        onp.testing.assert_allclose(tp.data().numpy(),
                                    jparams[name].data().asnumpy(),
                                    err_msg=name, **STEP_TOL)
    jstates = jtr._updaters[0].states
    for i, tp in enumerate(ttr._params):
        name = next(k for k, v in tparams.items() if v is tp)
        jm = jstates[jtr._param2idx[id(jparams[name])]]
        onp.testing.assert_allclose(ttr._states[i].numpy(), jm.asnumpy(),
                                    err_msg=f"momentum {name}", **STEP_TOL)


def test_fused_conv_bn_hybridized_training_only(knobs):
    knobs("MXNET_FUSED_CONV_BN", 2)
    x = _rand(14, 2, 16, 16, 3)
    tnet = tresnet.ResNetV1(tresnet.BottleneckV1, [2, 1], [8, 32, 64],
                            classes=CLASSES, layout="NHWC",
                            input_layout="NHWC")
    tnet.initialize(ctx=tmx.cpu())
    tx = torch.from_numpy(x)
    tresnet.reset_fused_conv_bn_counts()
    with tag.record():
        eager = tnet(tx)                       # eager: never
    assert tresnet.fused_conv_bn_counts() == NO_SITES
    tnet.hybridize()
    with tag.record():
        fused = tnet(tx)
    assert tresnet.fused_conv_bn_counts() == SITES
    tnet(tx)                                   # inference: never
    assert tresnet.fused_conv_bn_counts() == SITES
    # the same function either way (batch statistics of the same batch)
    onp.testing.assert_allclose(fused.detach().numpy(),
                                eager.detach().numpy(), **OUT_TOL)


def _mutated_conv_bn(gluon, HybridBlock):
    """``y = conv(x); y += 1; bn(y)``: the reference must not fuse it (the
    in-place add clears its producer tag); the port never pairs it."""

    class Net(HybridBlock):
        def __init__(self):
            super().__init__()
            self.conv = gluon.nn.Conv2D(16, kernel_size=1, use_bias=False,
                                        layout="NHWC")
            self.bn = gluon.nn.BatchNorm(axis=3)

        def forward(self, x):
            y = self.conv(x)
            y += 1.0
            return self.bn(y)

    return Net()


def _seq(gluon, conv_kw, axis):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(16, **conv_kw))
    net.add(gluon.nn.BatchNorm(axis=axis))
    return net


@pytest.mark.parametrize("case", ["strided_3x3", "nchw", "inplace"])
def test_pairs_that_never_fuse(knobs, case):
    """A strided 3x3, an NCHW conv and an in-place change of the conv's
    output run the plain layers in both packages, with the same output;
    the port counts the first two as refused."""
    knobs("MXNET_FUSED_CONV_BN", 2)
    if case == "inplace":
        from mxnet_tpu.gluon.block import HybridBlock as JHB
        from mxnet_tpu_torch.gluon.block import HybridBlock as THB
        jnet = _mutated_conv_bn(jgluon, JHB)
        tnet = _mutated_conv_bn(tgluon, THB)
        x = _rand(20, 2, 8, 8, 8)
    else:
        kw = (dict(kernel_size=3, strides=2, padding=1, layout="NHWC")
              if case == "strided_3x3" else
              dict(kernel_size=1, layout="NCHW"))
        axis = 3 if case == "strided_3x3" else 1
        jnet, tnet = _seq(jgluon, kw, axis), _seq(tgluon, kw, axis)
        x = _rand(21, 2, 8, 8, 8)
    _pair(jnet, tnet, x)
    jnet.hybridize()
    tnet.hybridize()
    tresnet.reset_fused_conv_bn_counts()
    with reference_sites() as ref:
        with jag.record():
            jout = jnet(jmx.nd.array(x))
        with tag.record():
            tout = tnet(torch.from_numpy(x))
    assert ref == {"1x1": 0, "kxk": 0}
    refused = 0 if case == "inplace" else 1
    assert tresnet.fused_conv_bn_counts() == dict(NO_SITES, refused=refused)
    onp.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(),
                                **OUT_TOL)


@pytest.mark.parametrize("kernel", [1, 3])
def test_biased_conv_fuses_with_the_bias_in_the_running_mean(knobs, kernel):
    """A conv bias leaves the train-mode output unchanged and moves the
    running mean: fused in both packages, the output, the running
    statistics and the gradients agree, the bias's gradient is 0 in both,
    and the port's running mean equals its unfused run's."""
    knobs("MXNET_FUSED_CONV_BN", 2)
    x = _rand(30, 2, 6, 6, 8)
    kw = dict(kernel_size=kernel, padding=kernel // 2, use_bias=True,
              layout="NHWC")
    jnet, tnet = _pair(_seq(jgluon, kw, 3), _seq(tgluon, kw, 3), x)
    params = _numpy_params(jnet)
    params["0.bias"] = _rand(31, 16) * 3.0
    for k, v in params.items():
        jnet.collect_params()[k].set_data(jmx.nd.array(v))
    gluon_params_from_numpy(tnet, params)
    gy = _rand(32, 2, 6, 6, 16)
    jnet.hybridize()
    tnet.hybridize()
    jx = jmx.nd.array(x)
    with reference_sites() as ref:
        with jag.record():
            jout = jnet(jx)
            jl = (jout * jmx.nd.array(gy)).sum()
        jl.backward()
    assert ref == {"1x1": int(kernel == 1), "kxk": int(kernel == 3)}

    def port_run():
        tnet.zero_grad()
        gluon_params_from_numpy(tnet, params)
        with tag.record():
            out = tnet(torch.from_numpy(x))
            (out * torch.from_numpy(gy)).sum().backward()
        return (out.detach().numpy(),
                {k: p.data().numpy().copy()
                 for k, p in tnet.collect_params().items()},
                {k: p.grad().numpy().copy()
                 for k, p in tnet.collect_params().items()
                 if p.grad_req != "null"})

    tresnet.reset_fused_conv_bn_counts()
    tout, tstate, tgrad = port_run()
    assert tresnet.fused_conv_bn_counts()["1x1" if kernel == 1
                                          else "kxk"] == 1
    onp.testing.assert_allclose(tout, jout.asnumpy(), **OUT_TOL)
    jparams = jnet.collect_params()
    for k in ("1.running_mean", "1.running_var"):
        onp.testing.assert_allclose(tstate[k], jparams[k].data().asnumpy(),
                                    err_msg=k, **OUT_TOL)
    for k, g in tgrad.items():
        onp.testing.assert_allclose(g, jparams[k].grad().asnumpy(),
                                    err_msg=k, **GRAD_TOL)
    assert not tgrad["0.bias"].any()
    # the running mean sees the biased conv, as the unfused layers' does
    knobs("MXNET_FUSED_CONV_BN", 0)
    uout, ustate, _ = port_run()
    onp.testing.assert_allclose(tout, uout, **OUT_TOL)
    for k in ("1.running_mean", "1.running_var"):
        onp.testing.assert_allclose(tstate[k], ustate[k], err_msg=k,
                                    **OUT_TOL)


def test_both_knobs_epilogue_takes_the_1x1_sites(knobs):
    """MXNET_FUSED_EPILOGUE and MXNET_FUSED_CONV_BN both on: the epilogue
    takes every 1x1 site and the 3x3 sites go through the KxK statistics
    op, in both packages; the matmul-bn-stats route is never taken."""
    knobs("MXNET_FUSED_CONV_BN", 2)
    knobs("MXNET_FUSED_EPILOGUE", 2)
    x, y = _batch()
    jnet, tnet = _narrow_hybridized(x)
    tresnet.reset_fused_epilogue_counts()
    with reference_sites() as ref:
        jo, jl, to, tl, sites = _step_both(jnet, tnet, x, y)
    assert ref == {"1x1": 0, "kxk": SITES["kxk"]}
    assert sites == dict(SITES, **{"1x1": 0})
    assert tresnet.fused_epilogue_counts() == {"fused": SITES["1x1"],
                                               "refused": 0}
    onp.testing.assert_allclose(to, jo, **STEP_TOL)
    onp.testing.assert_allclose(tl, jl, **STEP_TOL)


@pytest.mark.parametrize("kinds,want", [
    ("1x1", {"1x1": 8, "kxk": 0, "refused": 1 + 3}),
    ("kxk", {"1x1": 0, "kxk": 3, "refused": 1 + 8}),
])
def test_fused_conv_bn_kinds(knobs, kinds, want):
    knobs("MXNET_FUSED_CONV_BN", 2)
    knobs("MXNET_FUSED_CONV_BN_KINDS", kinds)
    x, y = _batch()
    jnet, tnet = _narrow_hybridized(x)
    with reference_sites() as ref:
        jo, jl, to, tl, sites = _step_both(jnet, tnet, x, y)
    assert ref == {"1x1": want["1x1"], "kxk": want["kxk"]}
    assert sites == want
    onp.testing.assert_allclose(to, jo, **STEP_TOL)
    onp.testing.assert_allclose(tl, jl, **STEP_TOL)


def test_unknown_kind_raises(knobs):
    knobs("MXNET_FUSED_CONV_BN", 2)
    knobs("MXNET_FUSED_CONV_BN_KINDS", "1x1,3x3")
    x = _rand(40, 2, 6, 6, 8)
    net = _seq(tgluon, dict(kernel_size=1, layout="NHWC"), 3)
    net.initialize(ctx=tmx.cpu())
    net(torch.from_numpy(x))
    net.hybridize()
    with pytest.raises(ValueError, match="3x3"):
        with tag.record():
            net(torch.from_numpy(x))


@pytest.mark.parametrize("mode,fused", [(0, 0), (1, 0), (2, 1)])
def test_modes_on_cpu_inputs(knobs, mode, fused):
    """0 never fuses; 1 fuses only where the input lies on a CUDA device (no
    site is counted for a CPU input, fused or refused); 2 also on the
    CPU."""
    knobs("MXNET_FUSED_CONV_BN", mode)
    x = _rand(41, 2, 6, 6, 8)
    net = _seq(tgluon, dict(kernel_size=1, layout="NHWC"), 3)
    net.initialize(ctx=tmx.cpu())
    net(torch.from_numpy(x))
    net.hybridize()
    tresnet.reset_fused_conv_bn_counts()
    with tag.record():
        net(torch.from_numpy(x))
    assert tresnet.fused_conv_bn_counts() == dict(NO_SITES, **{"1x1": fused})
