"""Gluon on the imperative substrate (NDArray inputs, layers through
``invoke``) against the reference, on the CPU:

- the README's quick start (784-128-10 MLP, ``Dense(activation="relu")``,
  ``hybridize()``, softmax cross-entropy, Adam) and SKILL.md's "Quick
  drives" SGD loop, on carried-over weights and numpy data: 3 steps each,
  losses and parameters within the fp32 step bound of
  ``test_torch_gluon_resnet.py`` (``STEP_TOL``: rtol 1e-4, atol 1e-4);
- a narrow bottleneck ResNet fed NDArrays, not hybridized, under
  ``record()`` (neither package fuses there): as many ``invoke``
  dispatches a forward and a loss as the reference's;
- the same net hybridized on both fused routes and unfused, 3 SGD steps:
  fed NDArrays it equals, bitwise, the port's own run fed tensors (losses,
  gradients, parameters, running statistics), and it meets the fused
  routes' bound against the reference
  (``test_torch_recorded_hybrid.FUSED_GRAD_TOL``)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

from test_torch_gluon_resnet import (CHANNELS, CLASSES, LAYERS, STEP_TOL,
                                     _narrow_pair, _numpy_params)
from test_torch_package import LazyModule
from test_torch_recorded_hybrid import (FUSED_GRAD_TOL, ROUTES,  # noqa: F401
                                        knobs)

jmx = LazyModule("mxnet_tpu")
jag = LazyModule("mxnet_tpu.autograd")
jgluon = LazyModule("mxnet_tpu.gluon")
jndarray = LazyModule("mxnet_tpu.ndarray.ndarray")


def _readme_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(128, activation="relu"),
            pkg.gluon.nn.Dense(10))
    return net


def test_readme_quick_start_matches_reference():
    rng = onp.random.RandomState(0)
    x = rng.randn(32, 784).astype(onp.float32)
    y = rng.randint(0, 10, 32).astype(onp.float32)
    jnet = _readme_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    with tmx.cpu():
        tnet = _readme_net(tmx)
        tnet.initialize(tmx.init.Xavier())
        tnet(tmx.nd.array(x))
    gluon_params_from_numpy(tnet, _numpy_params(jnet))
    jnet.hybridize()
    tnet.hybridize()
    jloss, tloss = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                    tgluon.loss.SoftmaxCrossEntropyLoss())
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 1e-3})
    ttr = tgluon.Trainer(tnet.collect_params(), "adam",
                         {"learning_rate": 1e-3})
    losses = []
    for step in range(3):
        with jag.record():
            jl = jloss(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        jtr.step(32)
        with tmx.cpu():
            tx, ty = tmx.nd.array(x), tmx.nd.array(y)
            with tag.record():
                tl = tloss(tnet(tx), ty)
            tl.backward()
            ttr.step(32)
        assert isinstance(tl, tmx.nd.NDArray) and tl.shape == (32,)
        assert tnet.last_eager_reason is None      # one graphed tape node
        onp.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(),
                                    err_msg=f"loss {step}", **STEP_TOL)
        losses.append(float(tl.mean().asscalar()))
    assert losses[2] < losses[0]
    jp = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        onp.testing.assert_allclose(p.data().numpy(), jp[k].data().asnumpy(),
                                    err_msg=k, **STEP_TOL)


def _skill_loop(pkg, steps):
    rng = onp.random.RandomState(1)
    nd, ag = pkg.nd, pkg.autograd
    X = nd.array(rng.randn(64, 10).astype(onp.float32))
    y = nd.array(rng.randn(64, 1).astype(onp.float32))
    W = nd.array((rng.randn(1, 10) * 0.1).astype(onp.float32))
    b = nd.zeros((1,))
    W.attach_grad()
    b.attach_grad()
    losses = []
    for _ in range(steps):
        with ag.record():
            loss = ((nd.FullyConnected(X, W, b, num_hidden=1) - y) ** 2
                    ).mean()
        loss.backward()
        for p in (W, b):
            p._set_data(nd.sgd_update(p, p.grad, lr=0.1)._data)
        losses.append(float(loss.asscalar()))
    return losses, W, b


def test_skill_sgd_loop_matches_reference():
    with tmx.cpu():
        got, tw, tb = _skill_loop(tmx, 3)
    want, jw, jb = _skill_loop(jmx, 3)
    onp.testing.assert_allclose(got, want, **STEP_TOL)
    onp.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), **STEP_TOL)
    onp.testing.assert_allclose(tb.asnumpy(), jb.asnumpy(), **STEP_TOL)
    assert got[2] < got[0]


def _narrow_nets(x, input_layout="NHWC"):
    kw = dict(classes=CLASSES, layout="NHWC", input_layout=input_layout)
    jnet = LazyModule("mxnet_tpu.gluon.model_zoo.vision").resnet.ResNetV1(
        LazyModule("mxnet_tpu.gluon.model_zoo.vision").resnet.BottleneckV1,
        LAYERS, CHANNELS, **kw)
    tnet = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS, **kw)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet.initialize(ctx=tmx.cpu())
    tnet(torch.from_numpy(x))
    gluon_params_from_numpy(tnet, _numpy_params(jnet))
    return jnet, tnet


@pytest.mark.parametrize("input_layout", ["NHWC", "NCHW"])
def test_invoke_count_per_forward_equals_reference(input_layout):
    rng = onp.random.RandomState(2)
    shape = (2, 16, 16, 3) if input_layout == "NHWC" else (2, 3, 16, 16)
    x = rng.randn(*shape).astype(onp.float32)
    y = onp.array([1, 4], onp.float32)
    jnet, tnet = _narrow_nets(x, input_layout)
    jce, tce = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                tgluon.loss.SoftmaxCrossEntropyLoss())
    counts = {}
    for pkg, net, ce, count in (
            (jmx, jnet, jce, jndarray.invoke_count),
            (tmx, tnet, tce, tmx.nd.invoke_count)):
        with tmx.cpu():
            nx, ny = pkg.nd.array(x), pkg.nd.array(y)
            with pkg.autograd.record():
                n0 = count()
                out = net(nx)
                n1 = count()
                ce(out, ny)
                counts[pkg is tmx] = (n1 - n0, count() - n1)
    assert counts[True] == counts[False]
    # stem 4 (+1 transpose) + 3 blocks x 8 + 1 downsample pair x 2 ... as
    # the reference's layers dispatch them
    assert counts[True][0] > 30 and counts[True][1] == 4


def _run(net, trainer, ce, x, y, nd_flavor, steps=3):
    """Losses, gradients, then parameters and running statistics after
    ``steps`` recorded SGD steps, fed NDArrays or tensors."""
    out = []
    for _ in range(steps):
        if nd_flavor:
            with tmx.cpu():
                bx, by = tmx.nd.array(x), tmx.nd.array(y)
        else:
            bx, by = torch.from_numpy(x), torch.from_numpy(y)
        with tag.record():
            loss = ce(net(bx), by)
        tag.backward(loss)
        assert net.last_eager_reason is None
        out.append((loss._data if nd_flavor else loss).detach().clone())
        out += [p.grad().clone() for p in net.collect_params().values()
                if p.grad_req != "null"]
        trainer.step(x.shape[0])
    out += [p.data().clone() for p in net.collect_params().values()]
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_hybridized_fed_ndarrays_equals_tensors_and_the_reference(route,
                                                                 knobs):
    knobs(**ROUTES[route])
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 16, 16, 3).astype(onp.float32)
    y = onp.array([3, 7], onp.float32)
    jnet, tnet = _narrow_pair(x)
    twin = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                            classes=CLASSES, layout="NHWC",
                            input_layout="NHWC")
    twin.initialize(ctx=tmx.cpu())
    twin(torch.from_numpy(x))
    twin.load_dict({k: p.data().clone()
                    for k, p in tnet.collect_params().items()})
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    for net in (jnet, tnet, twin):
        net.hybridize()
    ce = tgluon.loss.SoftmaxCrossEntropyLoss()
    tresnet.reset_fused_epilogue_counts()
    tresnet.reset_fused_conv_bn_counts()
    fed_nd = _run(tnet, tgluon.Trainer(tnet.collect_params(), "sgd",
                                       dict(opt)), ce, x, y, True)
    sites = (tresnet.fused_epilogue_counts(),
             tresnet.fused_conv_bn_counts())
    fed_t = _run(twin, tgluon.Trainer(twin.collect_params(), "sgd",
                                      dict(opt)), ce, x, y, False)
    assert len(fed_nd) == len(fed_t)
    for i, (a, b) in enumerate(zip(fed_nd, fed_t)):
        assert torch.equal(a, b), f"item {i} differs"
    if route == "epilogue":
        assert sites[0]["fused"] == 3 * 8
    if route == "conv_bn":
        assert sites[1] == {"1x1": 24, "kxk": 9, "refused": 3}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with jag.record():
            jl = jce(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        jtr.step(2)
    tol = STEP_TOL if route == "unfused" else FUSED_GRAD_TOL
    jparams = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        onp.testing.assert_allclose(p.data().numpy(),
                                    jparams[k].data().asnumpy(), err_msg=k,
                                    **tol)
