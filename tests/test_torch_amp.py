"""The port's mixed precision (``mxnet_tpu_torch.amp``, the AMP ops, the
optimizers' all-finite gate and fp32 master weights, ``Trainer.step`` with
a loss scaler) held against the JAX package's on the CPU.

- The lists: every op of the port's registry in exactly one list, the
  reference's list for the same name.
- The policy: every deterministic op of the registry, on the inputs of
  ``tests/test_torch_nd_ops.py`` (``op_smoke_specs``), under
  ``amp.init("float16")`` and ``amp.init("bfloat16")`` in both packages:
  the same output dtypes, values within the harness's fp32 bounds
  (``rtol 1e-5, atol 1e-6``) where an output is fp32 and within one ulp of
  the AMP dtype (``rtol = atol = 2^-10`` for fp16, ``2^-7`` for bf16)
  where it is in that dtype, each side having rounded once.
- ``LossScaler``: its scale, clean-step count and ``branch_scales`` after
  every verdict of a fixed sequence, equal to the reference's.
- The AMP ops ``amp_cast``, ``amp_multicast``, ``all_finite`` and
  ``multi_all_finite``, bitwise the reference's.
- ``Trainer.step`` with a scaler on both of its paths
  (``MXNET_FUSED_OPTIMIZER`` 1 and 0), with and without an overflow: the
  parameters within fp32 ``2e-4`` of the reference's, the scale and the
  skipped steps equal; ``multi_precision`` SGD momentum and Adam on fp16
  weights within fp16's rounding of the reference's.
- ``convert_hybrid_block``: the casts and the output against the
  reference's, and the captures of a hybridized block across ``amp.init``
  and ``amp.uninit``.
"""
import zlib

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import program_store as tps
from mxnet_tpu_torch.convert import gluon_params_from_numpy
from mxnet_tpu_torch.ndarray._unported import UNPORTED
from mxnet_tpu_torch.ops import registry as tregistry

from test_torch_nd_ops import DETERMINISTIC, _inputs, _outs
from test_torch_package import LazyModule

mx = LazyModule("mxnet_tpu")
jamp = LazyModule("mxnet_tpu.amp")
jag = LazyModule("mxnet_tpu.autograd")
jgluon = LazyModule("mxnet_tpu.gluon")
rget_op = LazyModule("mxnet_tpu.ops.registry", "get_op")

RTOL, ATOL = 1e-5, 1e-6
ULP = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}
LISTS = ("LOW_PRECISION_FUNCS", "FP32_FUNCS", "WIDEST_TYPE_CASTS",
         "FP16_FP32_FUNCS")


@pytest.fixture
def amp_off():
    """AMP off in both packages before and after the test."""
    tamp.uninit()
    jamp.uninit()
    yield
    tamp.uninit()
    jamp.uninit()


# ---------------------------------------------------------------------------
# the lists
# ---------------------------------------------------------------------------
def test_lists_exhaustive_and_disjoint_over_the_registry():
    ops = set(tregistry.list_ops())
    seen, dups = set(), set()
    for name in LISTS:
        for op in getattr(tamp.lists, name):
            (dups if op in seen else seen).add(op)
    assert not dups, f"ops in several AMP lists: {sorted(dups)}"
    assert ops == seen, (sorted(ops - seen), sorted(seen - ops))


def test_lists_classify_as_the_reference():
    from mxnet_tpu.amp import lists as rlists
    for name in LISTS:
        ref = set(getattr(rlists, name))
        got = set(getattr(tamp.lists, name))
        assert got <= ref, (name, sorted(got - ref))


def test_amp_ops_are_ported():
    names = ("amp_cast", "amp_multicast", "all_finite", "multi_all_finite")
    assert not set(names) & UNPORTED
    for n in names:
        assert callable(getattr(tmx.nd, n))


# ---------------------------------------------------------------------------
# the policy, op by op
# ---------------------------------------------------------------------------
def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_policy_matches_reference(amp_off, name):
    arrays, attrs = _inputs(name)
    for target in ("float16", "bfloat16"):
        tamp.init(target)
        jamp.init(target)
        try:
            with tmx.cpu():
                got = _outs(tmx.nd.invoke(
                    name, [tmx.nd.array(a) for a in arrays], dict(attrs)))
            want = _outs(mx.nd.invoke(
                rget_op(name), [mx.nd.array(a) for a in arrays],
                dict(attrs)))
        finally:
            tamp.uninit()
            jamp.uninit()
        assert len(got) == len(want), (name, target)
        for i, (g, w) in enumerate(zip(got, want)):
            what = f"{name} under {target}, output {i}"
            assert _dtype_name(g.dtype) == str(w.dtype), \
                f"{what}: dtype {g.dtype} != {w.dtype}"
            gv = g._data.double().numpy() if g._data.is_floating_point() \
                else g.asnumpy()
            wv = onp.asarray(w.asnumpy()).astype(gv.dtype)
            assert gv.shape == wv.shape, what
            if wv.dtype.kind in "biu":
                onp.testing.assert_array_equal(gv, wv, err_msg=what)
                continue
            tol = ULP.get(str(w.dtype), None)
            rtol, atol = (tol, tol) if tol else (RTOL, ATOL)
            onp.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol,
                                        equal_nan=True, err_msg=what)


def test_policy_casts_inside_the_op_for_the_backward(amp_off):
    """A LOW op's cotangents come back in each input's own dtype."""
    tamp.init("float16")
    with tmx.cpu():
        x = tmx.nd.array(onp.random.RandomState(0).randn(4, 8).astype("f4"))
        w = tmx.nd.array(onp.random.RandomState(1).randn(6, 8).astype("f4"))
        x.attach_grad()
        w.attach_grad()
        with tag.record():
            y = tmx.nd.FullyConnected(x, w, num_hidden=6, no_bias=True)
        assert str(y.dtype) == "float16"
        y.backward()
    assert str(x.grad.dtype) == "float32"
    assert str(w.grad.dtype) == "float32"


def test_init_uninit_bump_the_generation(amp_off):
    from mxnet_tpu_torch.ndarray import ndarray as tnd
    g0, k0 = tnd._amp_generation, tps.knob_key()
    tamp.init()
    assert tnd._amp_generation == g0 + 1 and tps.knob_key() != k0
    assert tamp._STATE.target_dtype == torch.bfloat16
    assert tamp._STATE.loss_scaler is None
    tamp.init("float16")
    assert isinstance(tamp._STATE.loss_scaler, tamp.LossScaler)
    tamp.uninit()
    assert tnd._amp_generation == g0 + 3 and tamp._STATE.target_dtype is None
    with pytest.raises(ValueError):
        tamp.init("float64")


# ---------------------------------------------------------------------------
# LossScaler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("init_scale,window,verdicts", [
    (2.0 ** 16, 2000, [True, True, False, False, True]),
    (8.0, 3, [False, False, False, False, False, False, False]),
    (8.0, 2, [False, True, False, False, True, True, True, True, True,
              False, False, False]),
    (2.0, 1, [False, True, True, True, False]),
])
def test_loss_scaler_policy_matches_reference(init_scale, window, verdicts):
    from mxnet_tpu.amp import LossScaler as RScaler
    t = tamp.LossScaler(init_scale=init_scale, scale_window=window)
    r = RScaler(init_scale=init_scale, scale_window=window)
    for v in verdicts:
        assert t.branch_scales() == r.branch_scales()
        clean, over = t.branch_scales()
        t.update_scale(v)
        r.update_scale(v)
        assert (t.loss_scale, t._unskipped) == (r.loss_scale, r._unskipped)
        # the branch the verdict takes is the scale update_scale gives
        assert t.loss_scale == (over if v else clean)


def test_loss_scaler_has_overflow():
    s = tamp.LossScaler()
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    a.grad, b.grad = torch.ones(3), torch.ones(2)
    assert s.has_overflow([a, b]) is False
    b.grad[1] = float("inf")
    assert s.has_overflow([a, b]) is True
    b.grad[1] = float("nan")
    assert s.has_overflow([a, b]) is True
    assert s.has_overflow([]) is False


# ---------------------------------------------------------------------------
# the AMP ops
# ---------------------------------------------------------------------------
def _op_cases():
    rng = onp.random.RandomState(5)
    f = rng.randn(3, 4).astype(onp.float32)
    bad = f.copy()
    bad[1, 2] = onp.inf
    nan = f.copy()
    nan[0, 0] = onp.nan
    return f, bad, nan


def _both(name, arrays, attrs, dtypes=None):
    dtypes = dtypes or [None] * len(arrays)
    with tmx.cpu():
        t = _outs(tmx.nd.invoke(name, [tmx.nd.array(a, dtype=d)
                                       for a, d in zip(arrays, dtypes)],
                                attrs))
    r = _outs(mx.nd.invoke(rget_op(name), [mx.nd.array(a, dtype=d)
                                            for a, d in zip(arrays, dtypes)],
                           attrs))
    return t, r


@pytest.mark.parametrize("case", range(6))
def test_amp_ops_bitwise_reference(amp_off, case):
    f, bad, nan = _op_cases()
    name, arrays, attrs, dtypes = [
        ("amp_cast", [f], {"dtype": "float16"}, None),
        ("amp_cast", [f], {"dtype": "bfloat16"}, None),
        ("amp_multicast", [f, f, f], {"num_outputs": 3},
         ["float16", "float32", "bfloat16"]),
        ("amp_multicast", [f, f], {"num_outputs": 2, "cast_narrow": True},
         ["float16", "float32"]),
        ("all_finite", [bad], {}, None),
        ("multi_all_finite", [f, nan, f], {"num_arrays": 3}, None),
    ][case]
    t, r = _both(name, arrays, attrs, dtypes)
    assert len(t) == len(r)
    for a, b in zip(t, r):
        assert _dtype_name(a.dtype) == str(b.dtype)
        onp.testing.assert_array_equal(
            a._data.float().numpy(),
            onp.asarray(b.asnumpy()).astype(onp.float32))
    if name in ("all_finite", "multi_all_finite"):
        assert float(t[0].asnumpy()[0]) == 0.0
        t2, r2 = _both(name, [f] * len(arrays), attrs)
        assert float(t2[0].asnumpy()[0]) == float(r2[0].asnumpy()[0]) == 1.0


def test_fused_all_finite_is_one_device_flag():
    from mxnet_tpu_torch.optimizer import fused
    ok = fused.all_finite([torch.ones(3), torch.zeros(2, 2)])
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    assert not bool(fused.all_finite([torch.ones(3),
                                      torch.tensor([float("nan")])]))
    assert bool(fused.all_finite([]))


# ---------------------------------------------------------------------------
# Trainer.step with a scaler
# ---------------------------------------------------------------------------
def _mlp_pair(seed=0):
    """A small MLP in both packages with the same weights (the
    reference's drawn from numpy seed ``seed``)."""
    rng = onp.random.RandomState(seed)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, in_units=8, activation="relu"),
             jgluon.nn.Dense(4, in_units=16))
    jnet.initialize(mx.init.Xavier())
    for _k, p in sorted(jnet.collect_params().items()):
        p.set_data(mx.nd.array(rng.randn(*p.shape) * 0.1))
    tnet = tgluon.nn.HybridSequential()
    tnet.add(tgluon.nn.Dense(16, in_units=8, activation="relu"),
             tgluon.nn.Dense(4, in_units=16))
    tnet.initialize(ctx=tmx.cpu())
    gluon_params_from_numpy(tnet, {k: p.data().asnumpy() for k, p in
                                   jnet.collect_params().items()})
    return jnet, tnet


def _batches(n, overflow_at=()):
    rng = onp.random.RandomState(3)
    out = []
    for i in range(n):
        x = rng.randn(6, 8).astype(onp.float32)
        y = rng.randn(6, 4).astype(onp.float32)
        if i in overflow_at:
            y = onp.full_like(y, 3e38)     # the scaled gradient overflows
        out.append((x, y))
    return out


@pytest.mark.parametrize("fused", [1, 0])
@pytest.mark.parametrize("overflow_at", [(), (1, 2)])
def test_trainer_step_with_scaler_matches_reference(monkeypatch, amp_off,
                                                    fused, overflow_at):
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", str(fused))
    jnet, tnet = _mlp_pair()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    jtr._amp_loss_scaler = jamp.LossScaler(init_scale=8.0, scale_window=2)
    ttr._amp_loss_scaler = tamp.LossScaler(init_scale=8.0, scale_window=2)
    scales = []
    for x, y in _batches(5, overflow_at):
        with jag.record():
            jl = ((jnet(mx.nd.array(x)) - mx.nd.array(y)) ** 2).mean()
            with jamp.scale_loss(jl, jtr) as js:
                pass
        js.backward()
        jtr.step(6)
        with tag.record():
            tl = ((tnet(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2
                  ).mean()
            with tamp.scale_loss(tl, ttr) as ts:
                pass
        tag.backward(ts)
        ttr.step(6)
        scales.append((ttr._amp_loss_scaler.loss_scale,
                       jtr._amp_loss_scaler.loss_scale))
    assert all(a == b for a, b in scales), scales
    assert ttr._amp_loss_scaler._unskipped == jtr._amp_loss_scaler._unskipped
    jp = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        onp.testing.assert_allclose(p.data().numpy(), jp[k].data().asnumpy(),
                                    rtol=2e-4, atol=2e-4, err_msg=k)


def test_unscale_matches_reference(amp_off):
    """amp.unscale divides the gradients by the scale and resets the
    trainer's rescale, so that the step does not divide again."""
    jnet, tnet = _mlp_pair()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.1})
    jtr._amp_loss_scaler = jamp.LossScaler(init_scale=16.0)
    ttr._amp_loss_scaler = tamp.LossScaler(init_scale=16.0)
    (x, y), = _batches(1)
    with jag.record():
        jl = ((jnet(mx.nd.array(x)) - mx.nd.array(y)) ** 2).mean()
        with jamp.scale_loss(jl, jtr) as js:
            pass
    js.backward()
    with tag.record():
        tl = ((tnet(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        with tamp.scale_loss(tl, ttr) as ts:
            pass
    tag.backward(ts)
    assert ttr._scale == jtr._scale == 1.0 / 16.0
    jamp.unscale(jtr)
    tamp.unscale(ttr)
    assert ttr._scale == jtr._scale == 1.0
    jp = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        onp.testing.assert_allclose(p.grad().numpy(),
                                    jp[k].grad().asnumpy(), rtol=1e-5,
                                    atol=1e-6, err_msg=k)


def test_trainer_refuses_update_on_kvstore_with_scaler(amp_off):
    tamp.init("float16")
    _j, tnet = _mlp_pair()
    tr = tgluon.Trainer(tnet.collect_params(), "sgd", update_on_kvstore=True)
    with pytest.raises(tmx.MXNetError, match="update_on_kvstore"):
        tamp.init_trainer(tr)
    tr._amp_loss_scaler = tamp.LossScaler()
    with pytest.raises(tmx.MXNetError, match="update_on_kvstore"):
        tr.step(1)


@pytest.mark.parametrize("optimizer,opt", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_multi_precision_matches_reference(optimizer, opt):
    """fp16 weights with fp32 master copies: the masters within fp32
    rounding of the reference's, the fp16 weights their rounding."""
    rng = onp.random.RandomState(9)
    w0 = rng.randn(16, 8).astype(onp.float16)
    grads = [rng.randn(16, 8).astype(onp.float16) for _ in range(3)]
    jopt = mx.optimizer.create(optimizer, multi_precision=True,
                               rescale_grad=0.5, **opt)
    jw = mx.nd.array(w0, dtype="float16")
    jst = jopt.create_state_multi_precision(0, jw)
    topt = tmx.optimizer.create(optimizer, multi_precision=True,
                                rescale_grad=0.5, **opt)
    tw = torch.from_numpy(w0)
    tst = topt.create_state_multi_precision(tw)
    for g in grads:
        jopt.update_multi_precision(0, jw, mx.nd.array(g, dtype="float16"),
                                    jst)
        topt.step([tw], [torch.from_numpy(g)], [tst])
    assert tw.dtype == torch.float16 and tst[0].dtype == torch.float32
    onp.testing.assert_allclose(tst[0].numpy(), jst[0].asnumpy(),
                                rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(tw.float().numpy(),
                                jw.asnumpy().astype(onp.float32),
                                rtol=2.0 ** -10, atol=2.0 ** -14)


def test_optimizer_ok_flag_skips_bitwise():
    opt = tmx.optimizer.create("adam", learning_rate=0.1)
    w = torch.randn(5)
    st = opt.create_state(w)
    w0, m0 = w.clone(), st[0].clone()
    opt.step([w], [torch.randn(5)], [st], ok=torch.tensor(False))
    assert torch.equal(w, w0) and torch.equal(st[0], m0)
    opt.step([w], [torch.randn(5)], [st], ok=torch.tensor(True))
    assert not torch.equal(w, w0)


# ---------------------------------------------------------------------------
# convert_hybrid_block
# ---------------------------------------------------------------------------
def _conv_bn_pair():
    x = onp.random.RandomState(2).randn(2, 6, 6, 8).astype(onp.float32)
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
             jgluon.nn.BatchNorm(axis=3), jgluon.nn.Activation("relu"),
             jgluon.nn.Dense(4))
    tnet = tgluon.nn.HybridSequential()
    tnet.add(tgluon.nn.Conv2D(8, 3, padding=1, layout="NHWC"),
             tgluon.nn.BatchNorm(axis=3), tgluon.nn.Activation("relu"),
             tgluon.nn.Dense(4))
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))
    tnet.initialize(ctx=tmx.cpu())
    tnet(torch.from_numpy(x))
    gluon_params_from_numpy(tnet, {k: p.data().asnumpy() for k, p in
                                   jnet.collect_params().items()})
    return jnet, tnet, x


@pytest.mark.parametrize("target", ["float16", "bfloat16"])
def test_convert_hybrid_block_matches_reference(amp_off, target):
    jnet, tnet, x = _conv_bn_pair()
    jamp.convert_hybrid_block(jnet, target)
    tamp.convert_hybrid_block(tnet, target)
    jp = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        assert _dtype_name(p.data().dtype) == str(jp[k].data().dtype), k
    jnet.hybridize()
    tnet.hybridize()
    want = jnet(mx.nd.array(x))
    got = tnet(torch.from_numpy(x))
    assert _dtype_name(got.dtype) == str(want.dtype)
    tol = 4 * ULP[target]
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.asnumpy()).astype("f4"),
                                rtol=tol, atol=tol)


def test_init_uninit_capture_anew(amp_off):
    _j, tnet, x = _conv_bn_pair()
    tamp.convert_hybrid_block(tnet, "float16")
    tnet.hybridize()
    ns = tps.namespace("hybrid_forward")
    caps = []
    for action in (None, None, lambda: tamp.init("float16"), None,
                   tamp.uninit):
        if action:
            action()
        t0 = ns.traces
        tnet(torch.from_numpy(x))
        caps.append(ns.traces - t0)
    assert caps == [1, 0, 1, 0, 1]


def test_convert_hybrid_block_ctx_rehomes(amp_off):
    _j, tnet, _x = _conv_bn_pair()
    tamp.convert_hybrid_block(tnet, "bfloat16", ctx=tmx.cpu())
    assert all(p.data().device.type == "cpu"
               for p in tnet.collect_params().values())


def test_zlib_inputs_are_the_harness():
    """The policy cases drive the harness's own inputs."""
    arrays, _ = _inputs("exp")
    gen = onp.random.RandomState(zlib.crc32(b"exp"))
    onp.testing.assert_array_equal(arrays[0],
                                   gen.rand(4, 6).astype(onp.float32) + 0.1)


# ---------------------------------------------------------------------------
# on the card: the fp16 kernels
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fp16_kernels_match_plain_on_card(cuda_device):
    """B4, B5, B6 and B8 given fp16 CUDA tensors launch their fp16 kernels
    (one count each, by dtype too) and agree with their plain versions
    within one fp16 ulp of the output and fp32 rounding of the sums."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f16 = torch.float16
    x = torch.randn(1000, 64, generator=g, device=cuda_device).to(f16)
    w = (torch.randn(128, 64, generator=g, device=cuda_device) / 8).to(
        f16).t()
    sc = torch.rand(128, generator=g, device=cuda_device) + 0.5
    sh = torch.randn(128, generator=g, device=cuda_device)
    r = torch.randn(1000, 128, generator=g, device=cuda_device).to(f16)
    img = torch.randn(3, 13, 11, 16, generator=g, device=cuda_device).to(f16)
    wk = (torch.randn(24, 3, 3, 16, generator=g, device=cuda_device)
          / 12).to(f16)
    ck.reset_launch_counts()
    got = {"matmul_bn_stats": ck.matmul_bn_stats(x, w, relu=True),
           "matmul_stats": ck.matmul_stats(x, w),
           "matmul_epilogue": ck.matmul_epilogue(x, w, sc, sh, r, True),
           "convkxk_bn_stats": ck.convkxk_bn_stats(img, wk, (1, 1))}
    torch.cuda.synchronize()
    for name in got:
        assert ck.launch_counts()[name] == 1, name
        assert ck.launch_counts_by_dtype()[(name, "fp16")] == 1, name
    want = {"matmul_bn_stats": ck.matmul_bn_stats_reference(x, w, True),
            "matmul_stats": ck.matmul_stats_reference(x, w),
            "matmul_epilogue": ck.matmul_epilogue_reference(x, w, sc, sh, r,
                                                            True),
            "convkxk_bn_stats": ck.convkxk_bn_stats_reference(img, wk,
                                                              (1, 1))}
    for name, out in got.items():
        outs = out if isinstance(out, tuple) else (out,)
        refs = want[name] if isinstance(want[name], tuple) \
            else (want[name],)
        for a, b in zip(outs, refs):
            assert a.dtype == b.dtype, name
            tol = 2.0 ** -10 if a.dtype == f16 else 1e-4
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol, msg=name)


@pytest.mark.cuda
def test_fp16_fused_op_runs_the_kernels_on_card(cuda_device):
    """An fp16 AMP call of a fused conv + BN op launches the fp16 kernels:
    no fallback to the plain version on a CUDA tensor."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(4, 8, 8, 16, generator=g, device=cuda_device)
    w = torch.randn(32, 3, 3, 16, generator=g, device=cuda_device) / 12
    gamma = torch.ones(32, device=cuda_device)
    beta = torch.zeros(32, device=cuda_device)
    tamp.init("float16")
    try:
        ck.reset_launch_counts()
        out = tmx.nd.invoke("_fused_convkxk_bn", [x, w, gamma, beta], {})
        torch.cuda.synchronize()
    finally:
        tamp.uninit()
    assert out[0].dtype == torch.float16
    assert ck.launch_counts_by_dtype() == {("convkxk_bn_stats", "fp16"): 1}
