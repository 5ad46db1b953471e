"""The port's ``ServingEngine`` (``mxnet_tpu_torch/serving.py``) on the
CPU: the counterparts of the JAX package's ``tests/test_serving.py``
:81-270, and the engine held against the reference's ``ServingEngine`` on
the same numpy weights.

Pins: (1) padded-vs-unpadded parity over a variable-length stream with 0
captures after warm-up and programs <= buckets, each output equal to its
request's exact-shape eager forward by the verify rule (bit-exact, or a
last-ulp difference within rtol 1e-5 / atol 1e-6); (2) numpy requests
staged, not baked; (3) a mean over a padded length refused, with the
reason kept, and still correct; (4) above the largest bucket served exact;
(5) coalescing and the max-delay flush; (6) the ``serving.infer`` fault
falls back to single requests, and a request's own error reaches exactly
that request; (7) the 64-wide ``lane_infer`` MLP and a narrow NHWC
ResNet v1 against the reference's engine; (8) drains, sheds and devices.

The ``cuda``-marked test serves on the card and skips without one.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import preemption as tpreemption
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon import nn as tnn

from test_torch_package import LazyModule

jmx = LazyModule("mxnet_tpu")
jgluon = LazyModule("mxnet_tpu.gluon")
jserving = LazyModule("mxnet_tpu.serving")

VERIFY_RTOL, VERIFY_ATOL = 1e-5, 1e-6   # the verify rule's last-ulp bound
REF_TOL = 1e-5                          # fp32 against the reference
JOIN_S = 60.0


def _mlp(seed=0, width=8, hidden=16, out=4, layers=1, ctx=None):
    """A Dense MLP on ``ctx`` (the CPU) with seeded numpy weights."""
    class Net(tgluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.body = [tnn.Dense(hidden, in_units=width if i == 0
                                   else hidden, activation="relu")
                         for i in range(layers)]
            for i, b in enumerate(self.body):
                setattr(self, f"d{i}", b)
            self.out = tnn.Dense(out, in_units=hidden)

        def forward(self, x):
            for b in self.body:
                x = b(x)
            return self.out(x)

    net = Net()
    net.initialize(tmx.init.Xavier(), ctx=ctx or tmx.cpu())
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.tensor(rng.randn(*p.shape) * 0.1,
                                dtype=torch.float32))
    return net


def _eager(net, x):
    with torch.no_grad(), tmx.autograd.pause():
        return net.forward(x)


def _verify_rule(got, want):
    return torch.equal(got, want) or torch.allclose(
        got, want, rtol=VERIFY_RTOL, atol=VERIFY_ATOL)


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request thread hung"


# ---------------------------------------------------------------------------
# padded-vs-unpadded parity over a variable-length stream
# ---------------------------------------------------------------------------
def test_serving_padded_parity_bounded_programs():
    net = _mlp(0)
    rng = onp.random.RandomState(42)
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        assert eng.warmup(torch.zeros(1, 8), max_rows=8) == 4
        t0, d0 = serving.trace_count(), serving.dispatch_count()
        lengths = rng.randint(1, 9, size=20)
        for n in lengths:
            x = torch.tensor(rng.randn(int(n), 8), dtype=torch.float32)
            out = eng.infer(x)
            assert out.shape == (int(n), 4)
            assert _verify_rule(out, _eager(net, x)), n
        assert serving.trace_count() - t0 == 0
        assert serving.dispatch_count() - d0 == len(lengths)
        assert len(eng._programs) <= 4
        assert eng.bucket_refused is None
        assert eng.stats()["verify_runs"] >= 1


def test_serving_numpy_request_staged_not_baked():
    net = _mlp(1)
    rng = onp.random.RandomState(0)
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        a = rng.randn(4, 8).astype(onp.float32)
        b = rng.randn(4, 8).astype(onp.float32)
        out_a = eng.infer(a)
        t0 = serving.trace_count()
        out_b = eng.infer(b)
        assert serving.trace_count() == t0          # the same program
        assert isinstance(out_b, tmx.nd.NDArray)
        assert not onp.array_equal(out_a.asnumpy(), out_b.asnumpy())
        assert _verify_rule(out_b._data, _eager(net, torch.from_numpy(b)))


def test_serving_mean_over_length_refused_but_correct():
    class MeanLen(tgluon.HybridBlock):
        def forward(self, x):
            return x.mean(dim=1)        # padded zeros shift the mean

    net = MeanLen()
    rng = onp.random.RandomState(3)
    tfaults.reset()
    with serving.ServingEngine(net, max_delay_us=200, device="cpu") as eng:
        for L in (5, 6, 9, 3):
            x = torch.tensor(rng.randn(2, L), dtype=torch.float32)
            assert torch.equal(eng.infer(x), x.mean(dim=1)), L
        assert eng.bucket_refused is not None
        assert "bit-exact" in eng.bucket_refused
        assert eng.stats()["bucket_refused"] == eng.bucket_refused
    assert any(e["action"] == "bucket_refused"
               for e in tfaults.events("serving.infer"))


def test_serving_above_largest_bucket_falls_back_exact(monkeypatch):
    monkeypatch.setenv("MXNET_SHAPE_BUCKETS", "4,8")
    net = _mlp(2)
    rng = onp.random.RandomState(1)
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        out = eng.infer(torch.tensor(rng.randn(12, 8), dtype=torch.float32))
        assert out.shape == (12, 4)
        assert eng.stats()["bucket_fallbacks"] == 1
        eng.infer(torch.tensor(rng.randn(4, 8), dtype=torch.float32))
        s = eng.stats()
        assert s["padded_rows"] - s["true_rows"] == 0
        eng.infer(torch.tensor(rng.randn(5, 8), dtype=torch.float32))
        s = eng.stats()
        assert s["padded_rows"] - s["true_rows"] == 3


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------
def test_serving_coalesces_concurrent_requests():
    net = _mlp(4)
    rng = onp.random.RandomState(5)
    with serving.ServingEngine(net, max_batch=32,
                               max_delay_us=300_000) as eng:
        eng.infer(torch.tensor(rng.randn(8, 8), dtype=torch.float32))
        xs = [torch.tensor(rng.randn(2, 8), dtype=torch.float32)
              for _ in range(4)]
        outs = {}
        b0 = eng.stats()["batches"]
        _run_threads([lambda i=i: outs.__setitem__(i, eng.infer(xs[i]))
                      for i in range(4)])
        s = eng.stats()
        assert s["batches"] - b0 <= 2
        assert s["coalesced"] >= 2
        for i, x in enumerate(xs):
            assert _verify_rule(outs[i], _eager(net, x)), i


def test_serving_max_delay_flushes_partial_batch():
    net = _mlp(5)
    with serving.ServingEngine(net, max_batch=32,
                               max_delay_us=10_000) as eng:
        eng.infer(torch.randn(2, 8))
        t0 = time.monotonic()
        out = eng.infer(torch.randn(2, 8))
        assert out.shape == (2, 4)
        assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# fault site: serving.infer
# ---------------------------------------------------------------------------
def test_serving_infer_fault_falls_back_single_request():
    net = _mlp(6)
    rng = onp.random.RandomState(7)
    tfaults.reset()
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        x = torch.tensor(rng.randn(3, 8), dtype=torch.float32)
        with tfaults.active(tfaults.FaultPlan().fail(
                "serving.infer", times=1, exc=TimeoutError)):
            out = eng.infer(x)
        ref = _eager(net, x)
        assert torch.equal(out, ref)
        assert eng.stats()["single_fallbacks"] == 1
        assert any(e["action"] == "fallback"
                   for e in tfaults.events("serving.infer"))
        assert _verify_rule(eng.infer(x), ref)


def test_serving_request_error_delivered_not_dropped():
    class Picky(tgluon.HybridBlock):
        def forward(self, x):
            if x.shape[1] != 8:
                raise ValueError("bad width")
            return x * 2.0

    with serving.ServingEngine(Picky(), max_delay_us=200,
                               device="cpu") as eng:
        with pytest.raises(ValueError, match="bad width"):
            eng.infer(torch.zeros(2, 3))
        out = eng.infer(torch.ones(2, 8))
        assert torch.equal(out, torch.full((2, 8), 2.0))


def test_serving_errors_reach_only_their_request():
    """Two coalesced requests, one of which the model rejects: the batch
    fails, the fallback runs each alone, and only the bad one raises."""
    class Picky(tgluon.HybridBlock):
        def forward(self, x):
            if bool((x < 0).any()):
                raise ValueError("negative input")
            return x + 1.0

    with serving.ServingEngine(Picky(), max_delay_us=300_000,
                               device="cpu") as eng:
        res = {}

        def call(name, x):
            def go():
                try:
                    res[name] = eng.infer(x)
                except ValueError as e:
                    res[name] = e
            return go

        _run_threads([call("good", torch.ones(2, 4)),
                      call("bad", -torch.ones(2, 4))])
        assert torch.equal(res["good"], torch.full((2, 4), 2.0))
        assert isinstance(res["bad"], ValueError)


# ---------------------------------------------------------------------------
# against the reference's engine
# ---------------------------------------------------------------------------
def _jax_mlp(tnet, width, hidden, out, layers):
    jnn = LazyModule("mxnet_tpu.gluon.nn")

    class Net(jgluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.body = [jnn.Dense(hidden, in_units=width if i == 0
                                   else hidden, activation="relu")
                         for i in range(layers)]
            for i, b in enumerate(self.body):
                setattr(self, f"d{i}", b)
            self.out = jnn.Dense(out, in_units=hidden)

        def forward(self, x):
            for b in self.body:
                x = b(x)
            return self.out(x)

    net = Net()
    net.initialize(jmx.init.Xavier())
    params = net.collect_params()
    for name, p in tnet.collect_params().items():
        params[name].set_data(jmx.nd.array(p.data().numpy()))
    return net


def test_lane_infer_mlp_matches_the_reference_engine():
    """The ``lane_infer`` MLP (three Dense of width 64, 8 outputs) served
    by both engines on the same numpy weights and requests of 1-32 rows:
    outputs within 1e-5."""
    tnet = _mlp(9, width=64, hidden=64, out=8, layers=2)
    jnet = _jax_mlp(tnet, 64, 64, 8, 2)
    rng = onp.random.RandomState(0)
    reqs = [rng.randn(int(n), 64).astype(onp.float32)
            for n in rng.randint(1, 33, size=8)]
    with serving.ServingEngine(tnet, max_delay_us=200) as eng, \
            jserving.ServingEngine(jnet, max_delay_us=200) as jeng:
        for x in reqs:
            got = eng.infer(x).asnumpy()
            want = jeng.infer(jmx.nd.array(x)).asnumpy()
            assert got.shape == want.shape
            assert onp.abs(got - want).max() <= REF_TOL


def test_narrow_resnet_served_against_eager_and_reference():
    from test_torch_gluon_resnet import OUT_TOL, _narrow_pair

    rng = onp.random.RandomState(3)
    x0 = rng.randn(2, 16, 16, 3).astype(onp.float32)
    jnet, tnet = _narrow_pair(x0)
    tnet.hybridize()
    with serving.ServingEngine(tnet, max_delay_us=200) as eng:
        assert eng.warmup(x0, max_rows=4) == 3
        t0 = serving.trace_count()
        for n in (1, 3, 2, 4):
            x = rng.randn(n, 16, 16, 3).astype(onp.float32)
            got = eng.infer(x)._data
            assert _verify_rule(got, _eager(tnet, torch.from_numpy(x))), n
            want = jnet(jmx.nd.array(x)).asnumpy()
            assert onp.allclose(got.numpy(), want, **OUT_TOL)
        assert serving.trace_count() == t0
        assert eng.stats()["programs"] <= 3


# ---------------------------------------------------------------------------
# drain, sheds, devices
# ---------------------------------------------------------------------------
def test_serving_sheds_typed_while_draining():
    net = _mlp(1)
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        eng.begin_drain()
        with pytest.raises(tfaults.ShedError) as ei:
            eng.infer(torch.ones(1, 8))
        assert ei.value.kind == "draining"
        assert eng.stats()["shed_draining"] == 1
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        tpreemption._DRAINING.set()
        try:
            with pytest.raises(tfaults.ShedError) as ei:
                eng.infer(torch.ones(1, 8))
        finally:
            tpreemption.reset()
        assert ei.value.kind == "draining"


def test_serving_deadline_spent_sheds():
    net = _mlp(1)
    with serving.ServingEngine(net, max_delay_us=200) as eng:
        with tfaults.deadline_scope(-1, site="test.serve"):
            with pytest.raises(tfaults.ShedError) as ei:
                eng.infer(torch.ones(1, 8))
        assert ei.value.kind == "deadline"


def test_serving_waitall_drains_and_stats():
    net = _mlp(2)
    eng = serving.ServingEngine(net, max_delay_us=50_000)
    try:
        outs = []
        threads = [threading.Thread(target=lambda: outs.append(
            eng.infer(torch.ones(2, 8)))) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.01)
        tengine.waitall()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert len(outs) == 3
        st = eng.stats()
        assert st["requests"] == 3 and st["p99_us"] > 0
        assert {"serving.request", "serving.dispatch"} <= \
            {s["name"] for s in eng.spans()}
        assert eng.load()["queue_depth"] == 0.0
    finally:
        eng.close()


def test_serving_runs_where_the_parameters_are():
    net = _mlp(3)
    eng = serving.ServingEngine(net)
    try:
        assert eng.device == torch.device("cpu")
        with pytest.raises(ValueError):
            serving.ServingEngine(net, device="meta")
        with pytest.raises(TypeError):
            eng.infer([[1.0] * 8])
    finally:
        eng.close()


def test_serving_mesh_of_more_than_one_device_raises():
    from mxnet_tpu_torch.parallel.mesh import Mesh

    net = _mlp(3)
    mesh = Mesh(("dp",), torch.device("cpu"))
    with serving.ServingEngine(net, mesh=mesh) as eng:
        assert eng.stats()["mesh_devices"] == 1
    mesh.shape = {"dp": 2}
    with pytest.raises(NotImplementedError, match="A6"):
        serving.ServingEngine(net, mesh=mesh)


def test_serving_parameterless_net_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Double(tgluon.HybridBlock):
        def forward(self, x):
            return x * 2

    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ServingEngine(Double())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serving_on_card_stages_and_replays(cuda_device):
    """Host requests staged through pinned buffers on the staging stream,
    served by captured programs from 4 threads; each output equal to its
    eager forward on the card by the verify rule, 0 captures after
    warm-up, programs <= buckets (or, refused, each request still
    correct)."""
    net = _mlp(11, width=64, hidden=64, out=8, layers=2, ctx=tmx.gpu(0))
    rng = onp.random.RandomState(1)
    reqs = [rng.randn(int(n), 64).astype(onp.float32)
            for n in rng.randint(1, 9, size=32)]
    outs = [None] * len(reqs)
    with serving.ServingEngine(net, max_delay_us=2000) as eng:
        assert eng.device.type == "cuda"
        eng.warmup(reqs[0], max_rows=32)
        t0 = serving.trace_count()

        def worker(k):
            def go():
                for i in range(k, len(reqs), 4):
                    outs[i] = eng.infer(reqs[i])._data
            return go

        _run_threads([worker(k) for k in range(4)])
        for x, got in zip(reqs, outs):
            assert got.device.type == "cuda"
            want = _eager(net, torch.from_numpy(x).to(cuda_device))
            assert _verify_rule(got, want)
        if eng.bucket_refused is None:
            assert serving.trace_count() == t0
            assert eng.stats()["programs"] <= 6
