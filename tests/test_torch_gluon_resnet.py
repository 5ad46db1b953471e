"""The port's Gluon ResNet train path (mxnet_tpu_torch.gluon, .optimizer,
.autograd) held against the JAX package's (mxnet_tpu.gluon) on the same
weights, carried over as numpy by ``convert.gluon_params_from_numpy``:
each layer (forward, gradients, running statistics), the structural
parameter names, and three SGD-momentum steps of a narrow bottleneck
ResNet v1 with the fused conv/BN/ReLU epilogue forced on the CPU
(``MXNET_FUSED_EPILOGUE=2``, the reference's Pallas interpreter on its
side, the kernels' plain versions on the port's).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import config as jconfig
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

# fp32 on both sides: convolutions and reductions sum in other orders
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# after 3 SGD-momentum steps at lr 0.1 the summation-order differences of
# every step have gone through the updates (measured: about 2e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def fused_epilogue(monkeypatch):
    """MXNET_FUSED_EPILOGUE=2 in both packages: fused sites on the CPU."""
    monkeypatch.setenv("MXNET_FUSED_EPILOGUE", "2")
    jconfig.refresh("MXNET_FUSED_EPILOGUE")
    tconfig.refresh("MXNET_FUSED_EPILOGUE")
    yield
    monkeypatch.delenv("MXNET_FUSED_EPILOGUE")
    jconfig.refresh("MXNET_FUSED_EPILOGUE")
    tconfig.refresh("MXNET_FUSED_EPILOGUE")


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _numpy_params(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _pair(jblock, tblock, x):
    """Initialize the JAX block, probe it with x, and carry its weights into
    the port's block (initialized on the CPU and probed the same way)."""
    jblock.initialize(jmx.init.Xavier())
    jblock(jmx.nd.array(x))
    tblock.initialize(ctx=tmx.cpu())
    tblock(torch.from_numpy(x))
    gluon_params_from_numpy(tblock, _numpy_params(jblock))
    return jblock, tblock


def _fwd_bwd(jblock, tblock, x, gy, train=True):
    """Outputs and the gradients of sum(out * gy) for x and every param."""
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jag.record(train_mode=train):
        jout = jblock(jx)
        jl = (jout * jmx.nd.array(gy)).sum()
    jl.backward()
    tx = torch.from_numpy(x).requires_grad_()
    with tag.record(train_mode=train):
        tout = tblock(tx)
        tl = (tout * torch.from_numpy(gy)).sum()
    tl.backward()
    jg = {k: p.grad().asnumpy() for k, p in jblock.collect_params().items()
          if p.grad_req != "null"}
    tg = {k: p.grad().numpy() for k, p in tblock.collect_params().items()
          if p.grad_req != "null"}
    return (jout.asnumpy(), jx.grad.asnumpy(), jg,
            tout.detach().numpy(), tx.grad.numpy(), tg)


def _assert_fwd_bwd(res):
    jo, jdx, jg, to, tdx, tg = res
    onp.testing.assert_allclose(to, jo, **OUT_TOL)
    onp.testing.assert_allclose(tdx, jdx, **GRAD_TOL)
    assert set(tg) == set(jg)
    for k in jg:
        onp.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride,pad,bias,layout", [
    (3, 1, 1, False, "NHWC"), (3, 2, 1, True, "NHWC"),
    (1, 2, 0, True, "NHWC"), (7, 2, 3, False, "NHWC"),
    (3, 2, 1, True, "NCHW")])
def test_conv2d_matches_jax(kernel, stride, pad, bias, layout):
    x = _rand(kernel + stride, 2, 9, 9, 5)
    kw = dict(kernel_size=kernel, strides=stride, padding=pad,
              use_bias=bias, layout=layout)
    j, t = _pair(jgluon.nn.Conv2D(8, **kw), tgluon.nn.Conv2D(8, **kw), x)
    assert t.weight.shape == ((8, kernel, kernel, 5) if layout == "NHWC"
                              else (8, 9, kernel, kernel))   # OHWI / OIHW
    gy = _rand(1, *j(jmx.nd.array(x)).shape)
    _assert_fwd_bwd(_fwd_bwd(j, t, x, gy))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    x = _rand(2, 4, 5, 5, 6) * 3.0 + 1.0
    j, t = _pair(jgluon.nn.BatchNorm(axis=3), tgluon.nn.BatchNorm(axis=3), x)
    # non-trivial running statistics and affine for the inference case
    stats = {"running_mean": _rand(3, 6), "running_var": onp.abs(
        _rand(4, 6)) + 0.5, "gamma": _rand(5, 6), "beta": _rand(6, 6)}
    for k, v in stats.items():
        j.collect_params()[k].set_data(jmx.nd.array(v))
    gluon_params_from_numpy(t, _numpy_params(j))
    if train:
        _assert_fwd_bwd(_fwd_bwd(j, t, x, _rand(7, *x.shape)))
    else:
        # predict mode, not recorded: the JAX package's eager BatchNorm
        # cannot be recorded in predict mode (its vjp gets a leaf where the
        # op returned a 1-tuple), so only the outputs are compared
        onp.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                                    j(jmx.nd.array(x)).asnumpy(), **OUT_TOL)
    for k in ("running_mean", "running_var"):
        want = j.collect_params()[k].data().asnumpy()
        got = t.collect_params()[k].data().numpy()
        onp.testing.assert_allclose(got, want, err_msg=k, **OUT_TOL)
        if not train:
            onp.testing.assert_array_equal(got, stats[k])


def test_dense_matches_jax():
    x = _rand(8, 3, 2, 2, 4)
    j, t = _pair(jgluon.nn.Dense(7), tgluon.nn.Dense(7), x)
    assert t.weight.shape == (7, 16)
    _assert_fwd_bwd(_fwd_bwd(j, t, x, _rand(9, 3, 7)))


@pytest.mark.parametrize("which", ["max", "global_avg"])
def test_pools_match_jax(which):
    x = _rand(10, 2, 9, 7, 3)
    if which == "max":
        j = jgluon.nn.MaxPool2D(3, 2, 1, layout="NHWC")
        t = tgluon.nn.MaxPool2D(3, 2, 1, layout="NHWC")
    else:
        j = jgluon.nn.GlobalAvgPool2D(layout="NHWC")
        t = tgluon.nn.GlobalAvgPool2D(layout="NHWC")
    gy = _rand(11, *j(jmx.nd.array(x)).shape)
    _assert_fwd_bwd(_fwd_bwd(j, t, x, gy))


def test_softmax_cross_entropy_matches_jax():
    pred = _rand(12, 4, 10) * 3.0
    label = onp.array([0, 3, 9, 3], onp.float32)
    jp = jmx.nd.array(pred)
    jp.attach_grad()
    with jag.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jp, jmx.nd.array(label))
    jl.backward()
    tp = torch.from_numpy(pred).requires_grad_()
    with tag.record():
        tl = tgluon.loss.SoftmaxCrossEntropyLoss()(tp, torch.from_numpy(label))
    tag.backward(tl)
    assert tl.shape == (4,)
    onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), **OUT_TOL)
    onp.testing.assert_allclose(tp.grad.numpy(), jp.grad.asnumpy(),
                                **GRAD_TOL)


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_collect_params_names_equal_jax(name):
    kw = dict(classes=1000, layout="NHWC", input_layout="NHWC")
    jnames = list(jvision.get_model(name, **kw).collect_params())
    tnet = tvision.get_model(name, ctx=tmx.cpu(), **kw)
    assert list(tnet.collect_params()) == jnames
    assert "features.4.0.body.0.weight" in jnames


def test_gluon_params_from_numpy_refuses_mismatches():
    x = _rand(13, 1, 4, 4, 3)
    j, t = _pair(jgluon.nn.Conv2D(4, 1, layout="NHWC"),
                 tgluon.nn.Conv2D(4, 1, layout="NHWC"), x)
    good = _numpy_params(j)
    with pytest.raises(KeyError, match="missing"):
        gluon_params_from_numpy(t, {"weight": good["weight"]})
    with pytest.raises(KeyError, match="unexpected"):
        gluon_params_from_numpy(t, dict(good, extra=good["bias"]))
    with pytest.raises(ValueError, match="shape"):
        gluon_params_from_numpy(t, dict(good, bias=onp.zeros(5, "f4")))


# ---------------------------------------------------------------------------
# the slice: a narrow bottleneck ResNet v1, 3 SGD-momentum steps, fused
# ---------------------------------------------------------------------------

LAYERS, CHANNELS, CLASSES = [2, 1], [8, 32, 64], 10
# fused sites per forward: 3 in each downsampling bottleneck (conv1,
# downsample, conv3), 2 in the others
SITES = 3 + 2 + 3


def _narrow_pair(x):
    kw = dict(classes=CLASSES, layout="NHWC", input_layout="NHWC")
    jnet = jvision.resnet.ResNetV1(jvision.resnet.BottleneckV1, LAYERS,
                                   CHANNELS, **kw)
    tnet = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS, **kw)
    return _pair(jnet, tnet, x)


def test_narrow_resnet_three_fused_sgd_steps_match_jax(fused_epilogue):
    rng = onp.random.RandomState(0)
    x = rng.randn(2, 16, 16, 3).astype(onp.float32)
    y = onp.array([3, 7], onp.float32)
    jnet, tnet = _narrow_pair(x)
    jnet.hybridize()
    tnet.hybridize()
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(3):
        with jag.record():
            jout = jnet(jmx.nd.array(x))
            jl = jloss_fn(jout, jmx.nd.array(y))
        jl.backward()
        jtr.step(2)
        tresnet.reset_fused_epilogue_counts()
        with tag.record():
            tout = tnet(tx)
            tl = tloss_fn(tout, ty)
        tag.backward(tl)
        ttr.step(2)
        assert tresnet.fused_epilogue_counts() == {"fused": SITES,
                                                   "refused": 0}
        onp.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(),
                                    err_msg=f"logits, step {step}",
                                    **STEP_TOL)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    err_msg=f"loss, step {step}", **STEP_TOL)
    assert float(tl.detach().mean()) < 0.5      # the batch is being fitted
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    for name, tp in tparams.items():
        onp.testing.assert_allclose(tp.data().numpy(),
                                    jparams[name].data().asnumpy(),
                                    err_msg=name, **STEP_TOL)
    # momenta, by parameter
    jstates = jtr._updaters[0].states
    for i, tp in enumerate(ttr._params):
        name = next(k for k, v in tparams.items() if v is tp)
        jm = jstates[jtr._param2idx[id(jparams[name])]]
        onp.testing.assert_allclose(ttr._states[i].numpy(), jm.asnumpy(),
                                    err_msg=f"momentum {name}", **STEP_TOL)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_basic_block_resnet_matches_jax(layout):
    """ResNet v1 of BasicBlockV1s (the resnet18/34 block), NCHW input, in
    both compute layouts: logits and every gradient of one training-mode
    forward and backward (no fused sites: those are bottleneck-only)."""
    x = _rand(16, 2, 3, 16, 16)
    kw = dict(classes=CLASSES, layout=layout)
    jnet, tnet = _pair(
        jvision.resnet.ResNetV1(jvision.resnet.BasicBlockV1, [1, 1],
                                [8, 8, 16], **kw),
        tresnet.ResNetV1(tresnet.BasicBlockV1, [1, 1], [8, 8, 16], **kw), x)
    _assert_fwd_bwd(_fwd_bwd(jnet, tnet, x, _rand(17, 2, CLASSES)))


def test_fused_sites_hybridized_training_only(fused_epilogue):
    x = _rand(14, 2, 16, 16, 3)
    tnet = tresnet.ResNetV1(tresnet.BottleneckV1, LAYERS, CHANNELS,
                            classes=CLASSES, layout="NHWC",
                            input_layout="NHWC")
    tnet.initialize(ctx=tmx.cpu())
    tx = torch.from_numpy(x)
    tresnet.reset_fused_epilogue_counts()
    with tag.record():
        eager = tnet(tx)                       # eager: never
    assert tresnet.fused_epilogue_counts()["fused"] == 0
    tnet.hybridize()
    with tag.record():
        fused = tnet(tx)
    assert tresnet.fused_epilogue_counts() == {"fused": SITES, "refused": 0}
    tnet(tx)                                   # inference: never
    assert tresnet.fused_epilogue_counts()["fused"] == SITES
    # the same function either way (batch statistics of the same batch)
    onp.testing.assert_allclose(fused.detach().numpy(),
                                eager.detach().numpy(), **OUT_TOL)


def test_refused_sites_run_the_plain_layers(fused_epilogue):
    # 12 channels: the bottleneck's 1x1 convs have K or N = 3, 12, not
    # multiples of 8, so every site is refused and counted
    x = _rand(15, 2, 8, 8, 12)
    block = tresnet.BottleneckV1(12, 1, False, in_channels=12, layout="NHWC")
    block.initialize(ctx=tmx.cpu())
    block(torch.from_numpy(x))
    block.hybridize()
    tresnet.reset_fused_epilogue_counts()
    with tag.record():
        block(torch.from_numpy(x))
    assert tresnet.fused_epilogue_counts() == {"fused": 0, "refused": 1}


@pytest.mark.parametrize("shape", [(256, 1, 1, 64), (64, 3, 3, 64),
                                   (64, 7, 7, 3), (1000, 2048)])
def test_xavier_keeps_the_reference_fans(shape):
    """Xavier's fans are the reference's, shape[1] * prod(shape[2:]) and
    shape[0] * prod(shape[2:]), also for OHWI conv weights (where they are
    not the conv's true fans). Both packages draw U(-b, b) with the same b,
    from different generators: compare the largest |w| with b."""
    hw = onp.prod(shape[2:]) if len(shape) > 2 else 1
    bound = onp.sqrt(3.0 / ((shape[1] * hw + shape[0] * hw) / 2.0))
    jw = jmx.nd.zeros(shape)
    jmx.init.Xavier()(jmx.init.InitDesc("weight"), jw)
    tw = torch.zeros(shape)
    tmx.initializer.Xavier(generator=torch.Generator().manual_seed(0))(
        "weight", tw)
    for w in (onp.abs(jw.asnumpy()), tw.abs().numpy()):
        assert 0.99 * bound < w.max() <= bound
