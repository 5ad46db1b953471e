"""The port's ``compile_step(accum_steps=N)`` and ``compile_step(bucket=True)``
(mxnet_tpu_torch.cached_step), its ``hybridize(bucket=True)`` and the shape
bucket policy (``serving.BucketPolicy``) held against the JAX package's
(``mxnet_tpu.cached_step``, ``mxnet_tpu.gluon.block``, ``mxnet_tpu.serving``)
on the CPU, on the same numpy weights and batches:

- accumulation windows against the reference's windows and against one
  big-batch step (the divisor is ``batch_size x accum_steps``,
  ``tests/test_fsdp_step.py:394-396``), N + 1 dispatches a window, the
  eager-tape refusal and the ``accum_steps`` check
  (``test_fsdp_step.py:451-470``), and a window of the narrow ResNet on the
  fused conv + BN route;
- bucketing with a masked loss (one program a bucket, the padded steps
  against the unpadded ones) and with an unmasked mean (refused before any
  padded gradient is applied). ``tests/test_serving.py::
  test_train_step_bucket_parity_and_bounded_traces`` is red on the
  reference (its sum-reduced masked loss is not bitwise pad-safe under
  XLA), so the reference's results are computed here, with a masked loss
  that sums its rows one by one, which is pad-safe in both packages;
- ``hybridize(bucket=True)``: parity and one program a bucket, and the
  refusal of a block whose outputs couple across the batch axis.

Tolerances: fp32 within 2e-4 against the reference (sums in other
orders), bitwise within the port where the arithmetic is the same.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.convert import gluon_params_from_numpy

from test_torch_gluon_resnet import _narrow_pair, _numpy_params
from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jmx = LazyModule("mxnet_tpu")
jconfig = LazyModule("mxnet_tpu.config")
jgluon = LazyModule("mxnet_tpu.gluon")
jserving = LazyModule("mxnet_tpu.serving")

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
OPT = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture
def knobs(monkeypatch):
    """set(name=value, ...): env knobs in both packages, undone after."""
    names = []

    def set_(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
            jconfig.refresh(k)
            tconfig.refresh(k)
            names.append(k)

    yield set_
    for k in names:
        monkeypatch.delenv(k, raising=False)
        jconfig.refresh(k)
        tconfig.refresh(k)


def _mlp_jax(seed=0):
    class Net(jgluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d1 = jgluon.nn.Dense(16, in_units=8, activation="relu")
            self.d2 = jgluon.nn.Dense(4, in_units=16)

        def forward(self, x):
            return self.d2(self.d1(x))

    net = Net()
    net.initialize(jmx.init.Xavier())
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(jmx.nd.array(rng.randn(*p.shape) * 0.1))
    net.hybridize()
    return net


class _Mlp(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.d1 = tgluon.nn.Dense(16, in_units=8)
        self.act = tgluon.nn.Activation("relu")
        self.d2 = tgluon.nn.Dense(4, in_units=16)

    def forward(self, x):
        return self.d2(self.act(self.d1(x)))


def _mlp_port(values):
    net = _Mlp()
    net.initialize(ctx=tmx.cpu())
    gluon_params_from_numpy(net, values)
    net.hybridize()
    return net


def _pair(seed=0):
    jnet = _mlp_jax(seed)
    return jnet, _mlp_port(_numpy_params(jnet))


def _loss_sum(net, x, y):
    return ((net(x) - y) ** 2).sum()


def _masked_loss(net, x, y, m):
    """Sum over rows of the masked squared error, the rows added one by
    one: zero rows added at the end leave the sum's bits alone in both
    packages, so the loss is pad-safe."""
    rows = ((net(x) - y) ** 2).sum(axis=1) * m.reshape(-1)
    total = rows[0]
    for i in range(1, rows.shape[0]):
        total = total + rows[i]
    return total


def _windows(rng, windows, rows):
    return [(rng.randn(rows, 8).astype(onp.float32),
             rng.randn(rows, 4).astype(onp.float32)) for _ in range(windows)]


def _params(net, numpy_of):
    return {k: numpy_of(p.data()) for k, p in net.collect_params().items()}


# ---------------------------------------------------------------------------
# accumulation windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_window_matches_jax_and_one_big_batch(accum):
    """``accum`` micro-batches of 16 / accum rows a window, 3 windows:
    against the reference's windows, and against the port's one 16-row
    step a window (the divisor is batch_size x accum_steps)."""
    jnet, tnet = _pair()
    big = _mlp_port(_numpy_params(jnet))
    jstep = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT)) \
        .compile_step(jnet, _loss_sum, accum_steps=accum)
    tstep = tgluon.Trainer(tnet.collect_params(), "sgd", dict(OPT)) \
        .compile_step(tnet, _loss_sum, accum_steps=accum)
    bstep = tgluon.Trainer(big.collect_params(), "sgd", dict(OPT)) \
        .compile_step(big, _loss_sum)
    micro = 16 // accum
    for x, y in _windows(onp.random.RandomState(7), 3, 16):
        for m in range(accum):
            sl = slice(m * micro, (m + 1) * micro)
            jstep(jmx.nd.array(x[sl]), jmx.nd.array(y[sl]),
                  batch_size=micro)
            tl = tstep(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
                       batch_size=micro)
            assert tstep.last_step_compiled
        bstep(torch.from_numpy(x), torch.from_numpy(y), batch_size=16)
    want = _params(jnet, lambda d: d.asnumpy())
    got = _params(tnet, lambda d: d.numpy())
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], err_msg=k, **FP32_TOL)
        onp.testing.assert_allclose(got[k], big.collect_params()[k]
                                    .data().numpy(), err_msg=k, **FP32_TOL)
    assert tl.shape == ()


def test_accum_exactly_n_plus_one_dispatches():
    _, net = _pair(2)
    step = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT)) \
        .compile_step(net, _loss_sum, accum_steps=3)
    x, y = (torch.from_numpy(a) for a in _windows(
        onp.random.RandomState(4), 1, 8)[0])
    t0 = tcs.trace_count()
    for _ in range(3):                          # the warm window
        step(x, y, batch_size=8)
    # one grad program and one update program
    assert tcs.trace_count() - t0 == 2
    d0, t0 = tcs.dispatch_count(), tcs.trace_count()
    windows = 2
    for _ in range(3 * windows):
        step(x, y, batch_size=8)
    assert tcs.dispatch_count() - d0 == (3 + 1) * windows
    assert tcs.trace_count() - t0 == 0


def test_accum_new_learning_rate_and_micro_batch_shapes_share_the_update():
    """Alternating micro-batch shapes take a grad program each and share
    the one update program and accumulators; a new learning rate is read
    without a new capture. Against the reference's windows."""
    jnet, tnet = _pair(3)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    jstep = jtr.compile_step(jnet, _loss_sum, accum_steps=2)
    tstep = ttr.compile_step(tnet, _loss_sum, accum_steps=2)
    rng = onp.random.RandomState(8)
    t0 = tcs.trace_count()
    for w in range(4):
        if w == 2:
            jtr.set_learning_rate(0.01)
            ttr.set_learning_rate(0.01)
        for rows in (6, 4):
            x = rng.randn(rows, 8).astype(onp.float32)
            y = rng.randn(rows, 4).astype(onp.float32)
            jstep(jmx.nd.array(x), jmx.nd.array(y), batch_size=rows)
            tstep(torch.from_numpy(x), torch.from_numpy(y), batch_size=rows)
    assert tcs.trace_count() - t0 == 3          # 2 grad programs, 1 update
    want = _params(jnet, lambda d: d.asnumpy())
    for k, v in _params(tnet, lambda d: d.numpy()).items():
        onp.testing.assert_allclose(v, want[k], err_msg=k, **FP32_TOL)


def test_accum_refuses_eager_tape(knobs):
    knobs(MXNET_COMPILED_STEP=0)
    _, net = _pair()
    step = tgluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}) \
        .compile_step(net, _loss_sum, accum_steps=2)
    x, y = (torch.from_numpy(a) for a in _windows(
        onp.random.RandomState(1), 1, 8)[0])
    with pytest.raises(tmx.MXNetError, match="accum_steps"):
        step(x, y, batch_size=8)


def test_accum_steps_validated():
    _, net = _pair()
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    with pytest.raises(ValueError, match="accum_steps"):
        trainer.compile_step(net, _loss_sum, accum_steps=0)


def test_accum_window_of_the_narrow_resnet_on_the_conv_bn_route(knobs):
    """The chip phase's window at toy size: the narrow bottleneck ResNet on
    the fused conv + BN route, 2 windows of 2 x 2 images, against the
    reference's windows (its Pallas kernels in the interpreter); the
    running statistics chain through the micro-batches in both."""
    knobs(MXNET_FUSED_CONV_BN=2)
    rng = onp.random.RandomState(0)
    x = rng.randn(4, 16, 16, 3).astype(onp.float32)
    y = rng.randint(0, 10, 4).astype(onp.float32)
    jnet, tnet = _narrow_pair(x)
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tce = tgluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    jstep = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt)) \
        .compile_step(jnet, lambda n, a, b: jce(n(a), b), accum_steps=2)
    tstep = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt)) \
        .compile_step(tnet, lambda n, a, b: tce(n(a), b), accum_steps=2)
    for _ in range(2):
        for m in range(2):
            sl = slice(2 * m, 2 * m + 2)
            jl = jstep(jmx.nd.array(x[sl]), jmx.nd.array(y[sl]),
                       batch_size=2)
            tl = tstep(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
                       batch_size=2)
            onp.testing.assert_allclose(tl.numpy(), jl.asnumpy(),
                                        rtol=1e-4, atol=1e-4)
    want = _params(jnet, lambda d: d.asnumpy())
    for k, v in _params(tnet, lambda d: d.numpy()).items():
        onp.testing.assert_allclose(v, want[k], err_msg=k, rtol=1e-4,
                                    atol=1e-4)


# ---------------------------------------------------------------------------
# the bucket policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,lengths", [
    ("pow2", (1, 2, 3, 5, 8, 9, 33)),
    ("4,8,16", (1, 4, 5, 16, 17)),
    (" 16, 4,8 ,", (3, 8, 9, 20)),
    ("none", (1, 3, 1000)),
])
def test_bucket_policy_matches_jax(spec, lengths):
    jp, tp = jserving.BucketPolicy(spec), tserving.BucketPolicy(spec)
    assert [tp.bucket(n) for n in lengths] == \
        [jp.bucket(n) for n in lengths]
    assert tp.buckets() == jp.buckets()
    assert tp.enabled == jp.enabled


@pytest.mark.parametrize("spec", ["8,x", "0,4", ",", "pow3"])
def test_bucket_policy_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jserving.BucketPolicy(spec)
    with pytest.raises(ValueError, match="MXNET_SHAPE_BUCKETS"):
        tserving.BucketPolicy(spec)


def test_bucket_policy_reads_the_knob_and_pads_like_jax(knobs):
    knobs(MXNET_SHAPE_BUCKETS="2,6")
    assert tserving.BucketPolicy().buckets() == (2, 6)
    a = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    onp.testing.assert_array_equal(
        tserving.pad_axis0(torch.from_numpy(a), 6).numpy(),
        onp.asarray(jserving.pad_axis0(a, 6)))
    onp.testing.assert_array_equal(
        tserving.pad_to_shape(torch.from_numpy(a), (5, 7)).numpy(),
        onp.asarray(jserving.pad_to_shape(a, (5, 7))))


# ---------------------------------------------------------------------------
# compile_step(bucket=True)
# ---------------------------------------------------------------------------


def test_bucket_masked_loss_parity_and_one_program_a_bucket():
    """Batches of 5, 6, 7, 8, 3 and 5 rows with a pad-safe masked loss:
    one program a bucket (4 and 8), each bucketed signature checked once,
    the padded steps' losses and parameters bitwise those of unpadded
    compiled steps, and within fp32 bounds of the reference's bucketed
    run."""
    jnet, tnet = _pair(13)
    plain = _mlp_port(_numpy_params(jnet))
    sgd = {"learning_rate": 0.05}
    jstep = jgluon.Trainer(jnet.collect_params(), "sgd", dict(sgd)) \
        .compile_step(jnet, _masked_loss, bucket=True)
    tstep = tgluon.Trainer(tnet.collect_params(), "sgd", dict(sgd)) \
        .compile_step(tnet, _masked_loss, bucket=True)
    pstep = tgluon.Trainer(plain.collect_params(), "sgd", dict(sgd)) \
        .compile_step(plain, _masked_loss)
    rng = onp.random.RandomState(14)
    batches = []
    for n in (5, 6, 7, 8, 3, 5):
        batches.append((rng.randn(n, 8).astype(onp.float32),
                        rng.randn(n, 4).astype(onp.float32),
                        onp.ones((n, 1), onp.float32)))
    t0 = tcs.trace_count()
    tserving.reset_counters()
    losses = []
    for b in batches:
        n = b[0].shape[0]
        jstep(*(jmx.nd.array(a) for a in b), batch_size=n)
        losses.append(tstep(*(torch.from_numpy(a) for a in b),
                            batch_size=n))
        assert tstep.last_step_compiled
    assert tcs.trace_count() - t0 == 2             # buckets 4 and 8
    assert tstep.bucket_refused is None
    assert tstep.padded_steps == 5                 # 8 fits exactly
    # each true shape is checked once: the second batch of 5 is a hit
    assert tserving.bucket_stats() == {"hits": 1, "misses": 4}
    assert jstep.padded_steps == 5 and jstep.bucket_refused is None
    for b, tl in zip(batches, losses):
        pl = pstep(*(torch.from_numpy(a) for a in b), batch_size=len(b[0]))
        assert torch.equal(tl, pl)
    want = _params(jnet, lambda d: d.asnumpy())
    got = _params(tnet, lambda d: d.numpy())
    for k, p in plain.collect_params().items():
        assert torch.equal(tnet.collect_params()[k].data(), p.data()), k
        onp.testing.assert_allclose(got[k], want[k], err_msg=k, **FP32_TOL)


def test_bucket_refuses_unmasked_mean_loss():
    """A mean loss is not pad-safe: the one-time check refuses it before
    any padded gradient is applied, and training goes on unpadded, as in
    the reference."""
    def mean_loss(n_, x, y):
        return ((n_(x) - y) ** 2).mean()

    jnet, tnet = _pair(15)
    jstep = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT)) \
        .compile_step(jnet, mean_loss, bucket=True)
    tstep = tgluon.Trainer(tnet.collect_params(), "sgd", dict(OPT)) \
        .compile_step(tnet, mean_loss, bucket=True)
    rng = onp.random.RandomState(16)
    x = rng.randn(5, 8).astype(onp.float32)
    y = rng.randn(5, 4).astype(onp.float32)
    before = _params(tnet, lambda d: d.numpy().copy())
    jstep(jmx.nd.array(x), jmx.nd.array(y), batch_size=5)
    tstep(torch.from_numpy(x), torch.from_numpy(y), batch_size=5)
    assert jstep.bucket_refused is not None
    assert tstep.last_step_compiled
    assert "pad-safe" in tstep.bucket_refused
    assert tstep.padded_steps == 0
    want = _params(jnet, lambda d: d.asnumpy())
    for k, v in _params(tnet, lambda d: d.numpy()).items():
        assert not onp.array_equal(v, before[k]), k
        onp.testing.assert_allclose(v, want[k], err_msg=k, **FP32_TOL)


def test_bucket_check_restores_the_running_statistics():
    """The pad-safety check runs the loss twice in training mode, and a
    batch norm couples the rows, so the check refuses; the running
    statistics those two runs moved are restored, so the step equals one
    unbucketed step bitwise."""
    class Net(tgluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d = tgluon.nn.Dense(4, in_units=8)
            self.bn = tgluon.nn.BatchNorm(in_channels=4)

        def forward(self, x):
            return self.bn(self.d(x))

    def loss(n_, x):
        return (n_(x) ** 2).sum()

    nets = []
    for _ in range(2):
        net = Net()
        net.initialize(tmx.initializer.Xavier(
            generator=torch.Generator().manual_seed(0)), ctx=tmx.cpu())
        nets.append(net)
    x = torch.from_numpy(onp.random.RandomState(2).randn(5, 8)
                         .astype(onp.float32))
    bstep = tgluon.Trainer(nets[0].collect_params(), "sgd", dict(OPT)) \
        .compile_step(nets[0], loss, bucket=True)
    pstep = tgluon.Trainer(nets[1].collect_params(), "sgd", dict(OPT)) \
        .compile_step(nets[1], loss)
    assert torch.equal(bstep(x), pstep(x))
    assert bstep.bucket_refused is not None and bstep.padded_steps == 0
    for k, p in nets[1].collect_params().items():
        assert torch.equal(nets[0].collect_params()[k].data(), p.data()), k


# ---------------------------------------------------------------------------
# hybridize(bucket=True)
# ---------------------------------------------------------------------------


def test_hybridize_bucket_parity_and_one_program_a_bucket():
    jnet, tnet = _pair(8)
    jnet.hybridize(bucket=True)
    tnet.hybridize(bucket=True)
    rng = onp.random.RandomState(9)
    ns = tps.namespace("hybrid_forward")
    t0 = ns.traces
    for n in (3, 5, 6, 7, 8):
        x = rng.randn(n, 8).astype(onp.float32)
        out = tnet(torch.from_numpy(x))
        with torch.no_grad():
            ref = tgluon.Block.__call__(tnet, torch.from_numpy(x))
        assert out.shape == (n, 4)
        assert torch.equal(out, ref), n
        onp.testing.assert_allclose(out.numpy(),
                                    jnet(jmx.nd.array(x)).asnumpy(),
                                    **FP32_TOL)
    assert tnet._bucket_refused is None and jnet._bucket_refused is None
    assert ns.traces - t0 == 2                  # buckets 4 and 8


def test_hybridize_bucket_refuses_batch_coupled_model():
    class BatchMean(tgluon.HybridBlock):
        def forward(self, x):
            return x - x.mean(dim=0, keepdim=True)   # couples rows

    class JBatchMean(jgluon.HybridBlock):
        def forward(self, x):
            return x - x.mean(axis=0, keepdims=True)

    tnet, jnet = BatchMean(), JBatchMean()
    tnet.hybridize(bucket=True)
    jnet.hybridize(bucket=True)
    x = onp.random.RandomState(10).randn(5, 8).astype(onp.float32)
    out = tnet(torch.from_numpy(x))
    jout = jnet(jmx.nd.array(x))
    ref = x - x.mean(axis=0, keepdims=True)
    onp.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    onp.testing.assert_allclose(out.numpy(), jout.asnumpy(), rtol=1e-6)
    assert tnet._bucket_refused is not None
    assert jnet._bucket_refused is not None
    # refused for good: the next call runs the exact shape's program
    tnet(torch.from_numpy(x[:3]))
    assert tnet._bucket_refused is not None


def test_hybridize_bucket_off_and_exact_fit_run_unpadded(knobs):
    _, tnet = _pair(1)
    tnet.hybridize(bucket=True)
    x = torch.from_numpy(onp.random.RandomState(3).randn(8, 8)
                         .astype(onp.float32))
    tserving.reset_counters()
    tnet(x)                                      # 8 fits exactly
    knobs(MXNET_SHAPE_BUCKETS="none")
    tnet(x[:5])
    assert tserving.bucket_stats() == {"hits": 0, "misses": 0}
