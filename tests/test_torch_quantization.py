"""The int8 op surface of the port (mxnet_tpu_torch.contrib.quantization) and
the int8 matmul kernel's plain version, against the JAX package on the CPU.

Every op gets the same inputs as its reference (numpy arrays from a seed):
s8 and s32 outputs must be bitwise equal, and so must the fp32 outputs
(the port repeats the reference's fp32 arithmetic op by op; no tolerance).
The inputs include ranges that fp32 cannot represent (0.1, 3.7, -2.3),
values placed on exact half-points of the quantization grid, and a K = 4608
convolution of operands of magnitude 127, whose s32 sums pass 2^24. The
kernel's plain version is held against the Pallas ``int8_matmul`` in
interpret mode and against numpy int64; the kernel itself against its plain
version on the card by the ``cuda``-marked test (and by chip_smoke.py).

JAX and the JAX package are imported inside the tests that compare (the
``ref`` fixture), so that the ``cuda``-marked test runs on a machine
without JAX.
"""
import logging
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.base import MXNetError as TMXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import cuda_kernels as ck

RANGES = [(-0.1, 0.1), (-2.3, 3.7), (-3.7, 0.1), (-1.0, 1.0), (-127.0, 127.0),
          (-63.5, 63.5)]


@pytest.fixture
def ref():
    """(jnp, the reference's contrib.quantization)."""
    import jax.numpy as jnp
    from mxnet_tpu.contrib import quantization as jq
    return jnp, jq


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else onp.asarray(x)


def _eq(port, jref):
    """Bitwise (values and dtype) equality of a port output and the
    reference's, element by element through tuples."""
    if isinstance(jref, (tuple, list)):
        assert len(port) == len(jref)
        for p, j in zip(port, jref):
            _eq(p, j)
        return
    p, j = _np(port), onp.asarray(jref)
    assert p.dtype == j.dtype, (p.dtype, j.dtype)
    assert p.shape == j.shape, (p.shape, j.shape)
    onp.testing.assert_array_equal(p, j)


def _s8(rng, *shape, lo=-127, hi=128):
    return rng.randint(lo, hi, shape).astype(onp.int8)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(onp.float32)


def _half_points(lo, hi, n=64):
    """fp32 data whose product with the quantize scale of range (lo, hi)
    lands on k + 0.5 wherever fp32 allows, plus the range's ends."""
    m = onp.float32(max(abs(lo), abs(hi), 1e-12))
    scale = onp.float32(127.0) / m
    k = onp.arange(-n // 2, n // 2, dtype=onp.float32) + onp.float32(0.5)
    return onp.concatenate([k / scale, [lo, hi, -2 * m, 2 * m]]).astype(
        onp.float32)


# -- quantize / dequantize / requantize / quantize_v2 -------------------------


@pytest.mark.parametrize("lo,hi", RANGES)
def test_quantize_dequantize_match(ref, lo, hi):
    jnp, jq = ref
    rng = onp.random.RandomState(0)
    x = onp.concatenate([_f32(rng, 256, scale=max(abs(lo), abs(hi))),
                         _half_points(lo, hi)])
    _eq(tq.quantize(torch.from_numpy(x), lo, hi), jq.quantize(
        jnp.asarray(x), lo, hi))
    q = _s8(rng, 300)
    _eq(tq.dequantize(torch.from_numpy(q), lo, hi),
        jq.dequantize(jnp.asarray(q), lo, hi))
    assert tq._sym_scale(lo, hi) == jq._sym_scale(lo, hi)
    # ranges given as fp32 tensors, as the ops return them
    t_lo, t_hi = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi)
    _eq(tq.dequantize(torch.from_numpy(q), t_lo, t_hi),
        jq.dequantize(jnp.asarray(q), jnp.float32(lo), jnp.float32(hi)))


@pytest.mark.parametrize("lo,hi", RANGES[:4])
@pytest.mark.parametrize("calib", [None, (-0.1, 0.1), (-2.3, 3.7)])
def test_requantize_matches(ref, lo, hi, calib):
    jnp, jq = ref
    rng = onp.random.RandomState(1)
    acc = rng.randint(-2 ** 24, 2 ** 24, 500).astype(onp.int32)
    acc[:3] = (2 ** 31 - 1, -2 ** 31 + 1, 16777217)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _eq(tq.requantize(torch.from_numpy(acc), lo, hi, **kw),
        jq.requantize(jnp.asarray(acc), lo, hi, **kw))


@pytest.mark.parametrize("calib", [None, (-0.1, 0.1), (-2.3, 3.7),
                                   (-127.0, 127.0)])
def test_quantize_v2_matches(ref, calib):
    jnp, jq = ref
    rng = onp.random.RandomState(2)
    x = onp.concatenate([_f32(rng, 200, scale=2.0),
                         _half_points(-127.0, 127.0)])
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _eq(tq.quantize_v2(torch.from_numpy(x), **kw),
        jq.quantize_v2(jnp.asarray(x), **kw))


# -- quantized fully connected and convolution -------------------------------


@pytest.mark.parametrize("m,k,n", [(5, 24, 8), (33, 64, 40), (2, 4608, 3)])
@pytest.mark.parametrize("relu,out", [(False, None), (True, None),
                                      (True, (-2.3, 3.7))])
def test_quantized_fully_connected_matches(ref, m, k, n, relu, out):
    jnp, jq = ref
    rng = onp.random.RandomState(3)
    qd, qw = _s8(rng, m, k), _s8(rng, n, k)
    if k == 4608:       # |acc| = 4608 * 127^2 > 2^24
        qd, qw = onp.full((m, k), 127, onp.int8), onp.full((n, k), -127,
                                                             onp.int8)
        qd[1] = -127
    bias = _f32(rng, n)
    kw = dict(num_hidden=n, data_scale=0.1, w_scale=3.7, fused_relu=relu,
              out_min=None if out is None else out[0],
              out_max=None if out is None else out[1])
    _eq(tq.quantized_fully_connected(
        [torch.from_numpy(qd), torch.from_numpy(qw), torch.from_numpy(bias)],
        **kw), jq.quantized_fully_connected(
        [jnp.asarray(qd), jnp.asarray(qw), jnp.asarray(bias)], **kw))


def test_quantized_fully_connected_flattens(ref):
    jnp, jq = ref
    rng = onp.random.RandomState(4)
    qd, qw = _s8(rng, 3, 4, 2, 2), _s8(rng, 6, 16)
    for flatten, w in ((True, qw), (False, qw[:, :2])):
        kw = dict(num_hidden=6, no_bias=True, flatten=flatten,
                  data_scale=0.02, w_scale=0.3)
        _eq(tq.quantized_fully_connected(
            [torch.from_numpy(qd), torch.from_numpy(w)], **kw),
            jq.quantized_fully_connected([jnp.asarray(qd), jnp.asarray(w)],
                                         **kw))


CONV_CASES = [
    # (data shape, weight shape, kwargs)
    ((2, 8, 9, 9), (16, 8, 3, 3), dict(kernel=(3, 3), pad=(1, 1))),
    ((2, 9, 9, 8), (16, 3, 3, 8), dict(kernel=(3, 3), pad=(1, 1),
                                       layout="NHWC")),
    ((2, 8, 9, 9), (16, 8, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                       pad=(1, 1))),
    ((2, 10, 11, 8), (8, 3, 3, 8), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1), layout="NHWC")),
    ((1, 9, 9, 8), (16, 3, 3, 8), dict(kernel=(3, 3), dilate=(2, 2),
                                       pad=(2, 2), layout="NHWC")),
    ((2, 8, 7, 7), (16, 2, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                       num_group=4)),
    ((2, 7, 7, 8), (16, 3, 3, 2), dict(kernel=(3, 3), pad=(1, 1),
                                       num_group=4, layout="NHWC")),
    ((2, 6, 6, 16), (32, 1, 1, 16), dict(kernel=(1, 1), layout="NHWC")),
    ((2, 7, 7, 16), (32, 1, 1, 16), dict(kernel=(1, 1), stride=(2, 2),
                                         layout="NHWC")),
    ((1, 16, 3, 3), (24, 1, 1, 3), dict(kernel=(7, 7), stride=(2, 2),
                                        pad=(3, 3), layout="NHWC")),
    # 1-D and 3-D: the defaults of stride, dilate and pad are 2-D, so they
    # are given
    ((2, 4, 13), (8, 4, 3), dict(kernel=(3,), stride=(2,), dilate=(1,),
                                 pad=(1,))),
    ((2, 13, 4), (8, 3, 4), dict(kernel=(3,), stride=(1,), dilate=(2,),
                                 pad=(1,), layout="NWC")),
    ((1, 4, 5, 6, 6), (8, 4, 3, 3, 3), dict(kernel=(3, 3, 3),
                                             stride=(1, 1, 1),
                                             dilate=(1, 1, 1),
                                             pad=(1, 1, 1))),
    ((1, 5, 6, 6, 4), (8, 3, 3, 3, 4), dict(kernel=(3, 3, 3),
                                             stride=(1, 2, 2),
                                             dilate=(1, 1, 1),
                                             pad=(0, 1, 0),
                                             layout="NDHWC")),
]


def _conv_case(xshape, wshape, kw):
    if kw.get("kernel") == (7, 7):       # the stem: 3 channels, 7x7/2
        xshape, wshape = (1, 16, 16, 3), (24, 7, 7, 3)
    return xshape, wshape


@pytest.mark.parametrize("xshape,wshape,kw", CONV_CASES,
                         ids=[f"{c[2].get('layout', 'NC')}-{i}"
                              for i, c in enumerate(CONV_CASES)])
@pytest.mark.parametrize("epi", ["fp32", "relu_requant"])
def test_quantized_conv_matches(ref, xshape, wshape, kw, epi):
    jnp, jq = ref
    xshape, wshape = _conv_case(xshape, wshape, kw)
    rng = onp.random.RandomState(5)
    qd, qw = _s8(rng, *xshape), _s8(rng, *wshape)
    bias = _f32(rng, wshape[0])
    kw = dict(kw, num_filter=wshape[0], data_scale=0.1, w_scale=0.023)
    if epi == "relu_requant":
        kw.update(fused_relu=True, out_min=-3.7, out_max=2.3)
    _eq(tq.quantized_conv([torch.from_numpy(qd), torch.from_numpy(qw),
                           torch.from_numpy(bias)], **kw),
        jq.quantized_conv([jnp.asarray(qd), jnp.asarray(qw),
                           jnp.asarray(bias)], **kw))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_quantized_conv_k4608_past_fp32_exact(ref, layout):
    """K = 3·3·512 with operands of magnitude 127: |acc| up to 7.4e7, past
    2^24, so an fp32 conv would round; the s32 sums must be exact."""
    jnp, jq = ref
    qd = onp.full((1, 512, 5, 5), 127, onp.int8)
    qd[:, ::3] = -127
    qw = onp.full((2, 512, 3, 3), 127, onp.int8)
    qw[1, 1::2] = -127
    if layout == "NHWC":
        qd, qw = qd.transpose(0, 2, 3, 1).copy(), qw.transpose(0, 2, 3, 1) \
            .copy()
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=2, no_bias=True,
              layout=layout)
    port = tq.quantized_conv([torch.from_numpy(qd), torch.from_numpy(qw)],
                             **kw)
    _eq(port, jq.quantized_conv([jnp.asarray(qd), jnp.asarray(qw)], **kw))
    assert onp.abs(_np(port)).max() > 2 ** 24


# -- the rest of the op surface ----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg"),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True)])
def test_quantized_pooling_matches(ref, kw):
    jnp, jq = ref
    rng = onp.random.RandomState(6)
    q = _s8(rng, 2, 3, 9, 9, lo=-128)
    q[0, 0] = -128          # padding must not win a max over a -128 window
    _eq(tq.quantized_pooling(torch.from_numpy(q), -2.3, 3.7, **kw),
        jq.quantized_pooling(jnp.asarray(q), jnp.float32(-2.3),
                             jnp.float32(3.7), **kw))


def test_quantized_act_flatten_match(ref):
    jnp, jq = ref
    q = _s8(onp.random.RandomState(7), 2, 3, 4, 4)
    _eq(tq.quantized_act(torch.from_numpy(q), -2.3, 3.7),
        jq.quantized_act(jnp.asarray(q), jnp.float32(-2.3),
                         jnp.float32(3.7)))
    _eq(tq.quantized_flatten(torch.from_numpy(q), -2.3, 3.7),
        jq.quantized_flatten(jnp.asarray(q), jnp.float32(-2.3),
                             jnp.float32(3.7)))
    with pytest.raises(NotImplementedError):
        tq.quantized_act(torch.from_numpy(q), -1.0, 1.0, act_type="tanh")


@pytest.mark.parametrize("dim", [0, 1])
def test_quantized_concat_matches(ref, dim):
    jnp, jq = ref
    rng = onp.random.RandomState(8)
    qs = [_s8(rng, 2, 3, 4), _s8(rng, 2, 3, 4), _s8(rng, 2, 3, 4)]
    ranges = [-0.1, 0.1, -2.3, 3.7, -3.7, 1.0]
    _eq(tq.quantized_concat([torch.from_numpy(q) for q in qs] + ranges,
                            dim=dim),
        jq.quantized_concat([jnp.asarray(q) for q in qs] + ranges, dim=dim))


@pytest.mark.parametrize("ra,rb", [((-0.1, 0.1), (-2.3, 3.7)),
                                   ((-127.0, 127.0), (-63.5, 63.5))])
def test_quantized_elemwise_match(ref, ra, rb):
    jnp, jq = ref
    rng = onp.random.RandomState(9)
    qa, qb = _s8(rng, 4, 64), _s8(rng, 4, 64)
    qa[0, :16] = onp.arange(-8, 8)           # small sums near half-points
    qb[0, :16] = onp.arange(8, -8, -1)
    args = (*ra, *rb)
    _eq(tq.quantized_elemwise_add(torch.from_numpy(qa), torch.from_numpy(qb),
                                  *args),
        jq.quantized_elemwise_add(jnp.asarray(qa), jnp.asarray(qb), *args))
    _eq(tq.quantized_elemwise_mul(torch.from_numpy(qa), torch.from_numpy(qb),
                                  *args),
        jq.quantized_elemwise_mul(jnp.asarray(qa), jnp.asarray(qb), *args))


@pytest.mark.parametrize("calib", [None, (-2.3, 3.7)])
def test_quantized_batch_norm_matches(ref, calib):
    jnp, jq = ref
    rng = onp.random.RandomState(10)
    q = _s8(rng, 2, 8, 5, 5)
    gamma, beta = _f32(rng, 8) + 1, _f32(rng, 8)
    mean, var = _f32(rng, 8, scale=0.3), onp.abs(_f32(rng, 8)) + 0.1
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    arrays = (q, gamma, beta, mean, var)
    _eq(tq.quantized_batch_norm(*(torch.from_numpy(a) for a in arrays),
                                -0.1, 3.7, **kw),
        jq.quantized_batch_norm(*(jnp.asarray(a) for a in arrays), -0.1, 3.7,
                                **kw))


def test_quantized_embedding_and_intgemm_match(ref):
    jnp, jq = ref
    rng = onp.random.RandomState(11)
    table = _s8(rng, 50, 16)
    idx = rng.randint(0, 50, (3, 7)).astype(onp.int64)
    _eq(tq.quantized_embedding(torch.from_numpy(idx), torch.from_numpy(table),
                               -2.3, 3.7),
        jq.quantized_embedding(jnp.asarray(idx), jnp.asarray(table),
                               jnp.float32(-2.3), jnp.float32(3.7)))
    x = onp.concatenate([_f32(rng, 40, 24).ravel(),
                         _half_points(-127.0, 127.0, n=92)]).reshape(-1, 24)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _eq(tq.intgemm_maxabsolute(tx), jq.intgemm_maxabsolute(jx))
    for maxabs in (3.7, 127.0):
        _eq(tq.intgemm_prepare_data(tx, maxabs),
            jq.intgemm_prepare_data(jx, maxabs))
        _eq(tq.intgemm_prepare_weight([tx, maxabs]),
            jq.intgemm_prepare_weight([jx, maxabs]))
    qw = _s8(rng, 30, 24)
    _eq(tq.intgemm_prepare_weight([torch.from_numpy(qw)],
                                  already_quantized=True),
        jq.intgemm_prepare_weight([jnp.asarray(qw)], already_quantized=True))
    _eq(tq.intgemm_take_weight(torch.from_numpy(qw), torch.tensor([3, 0, 29])),
        jq.intgemm_take_weight(jnp.asarray(qw), jnp.asarray([3, 0, 29])))
    qd = _s8(rng, 20, 24)
    bias = _f32(rng, 30)
    scale = onp.float32(0.0123)
    for args, kw in (((qd, qw), dict(out_type="int32")),
                     ((qd, qw, scale), {}),
                     ((qd, qw, scale, bias), dict(no_bias=False)),
                     ((qd.reshape(20, 4, 6), qw), dict(out_type="int32"))):
        _eq(tq.intgemm_fully_connected(
            [torch.from_numpy(onp.asarray(a)) for a in args], **kw),
            jq.intgemm_fully_connected([jnp.asarray(a) for a in args], **kw))


def test_calibrate_entropy_matches(ref):
    jnp, jq = ref
    rng = onp.random.RandomState(12)
    hist = onp.histogram(onp.abs(rng.standard_t(3, 20000)), bins=300)[0]
    _eq(tq.calibrate_entropy(hist, num_quantized_bins=31),
        jq.calibrate_entropy(hist, num_quantized_bins=31))
    _eq(tq.calibrate_entropy(torch.from_numpy(hist), num_quantized_bins=31),
        jq.calibrate_entropy(hist, num_quantized_bins=31))


# -- the retired kernel route ------------------------------------------------


@pytest.fixture
def knob(monkeypatch):
    """Set MXNET_INT8_PALLAS for both packages (None: unset)."""
    from mxnet_tpu import config as jconfig

    def set_mode(mode):
        if mode is None:
            monkeypatch.delenv("MXNET_INT8_PALLAS", raising=False)
        else:
            monkeypatch.setenv("MXNET_INT8_PALLAS", str(mode))
        jconfig.refresh("MXNET_INT8_PALLAS")
        tconfig.refresh("MXNET_INT8_PALLAS")

    yield set_mode
    os.environ.pop("MXNET_INT8_PALLAS", None)
    jconfig.refresh("MXNET_INT8_PALLAS")
    tconfig.refresh("MXNET_INT8_PALLAS")


@pytest.mark.parametrize("mode", [1, 2])
def test_knob_refuses_with_the_port_error(ref, knob, mode):
    jnp, jq = ref
    from mxnet_tpu.base import MXNetError as JMXNetError
    knob(mode)
    rng = onp.random.RandomState(13)
    qd, qw = _s8(rng, 2, 8, 8, 32), _s8(rng, 64, 1, 1, 32)
    kw = dict(kernel=(1, 1), num_filter=64, layout="NHWC", no_bias=True)
    with pytest.raises(JMXNetError):
        jq.quantized_conv([jnp.asarray(qd), jnp.asarray(qw)], **kw)
    with pytest.raises(TMXNetError) as ei:
        tq.quantized_conv([torch.from_numpy(qd), torch.from_numpy(qw)], **kw)
    msg = str(ei.value)
    assert f"MXNET_INT8_PALLAS={mode} refused" in msg
    assert "chip_smoke.py" in msg and "B7" in msg
    assert "0.345" not in msg


CONV_SEQUENCE = [   # (kernel, stride, pad, dilate, groups, layout)
    ((1, 1), (1, 1), (0, 0), (1, 1), 1, "NHWC"),     # claimed
    ((1, 1), (2, 2), (0, 0), (1, 1), 1, "NHWC"),     # claimed
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, "NHWC"),     # claimed
    ((3, 3), (2, 2), (1, 1), (1, 1), 1, "NHWC"),
    ((3, 3), (1, 1), (1, 1), (2, 2), 1, "NHWC"),
    ((3, 3), (1, 1), (1, 1), (1, 1), 2, "NHWC"),
    ((1, 1), (1, 1), (0, 0), (1, 1), 1, "NCHW"),
    ((1, 1), (1, 1), (1, 1), (1, 1), 1, "NHWC"),
]


def test_skip_count_moves_as_the_reference(ref, knob, monkeypatch, caplog):
    jnp, jq = ref
    knob(None)
    monkeypatch.setattr(tq, "_PALLAS_SKIP_LOGGED", False)
    rng = onp.random.RandomState(14)
    moves = []
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.quantization"):
        for kernel, stride, pad, dilate, groups, layout in CONV_SEQUENCE:
            c = 8
            if layout == "NHWC":
                qd = _s8(rng, 1, 9, 9, c)
                qw = _s8(rng, 8, *kernel, c // groups)
            else:
                qd = _s8(rng, 1, c, 9, 9)
                qw = _s8(rng, 8, c // groups, *kernel)
            kw = dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
                      num_group=groups, num_filter=8, layout=layout,
                      no_bias=True)
            j0, t0 = jq.pallas_skipped_count(), tq.pallas_skipped_count()
            _eq(tq.quantized_conv([torch.from_numpy(qd),
                                   torch.from_numpy(qw)], **kw),
                jq.quantized_conv([jnp.asarray(qd), jnp.asarray(qw)], **kw))
            moves.append((jq.pallas_skipped_count() - j0,
                          tq.pallas_skipped_count() - t0))
    assert [j for j, _ in moves] == [t for _, t in moves]
    assert [t for _, t in moves] == [1, 1, 1, 0, 0, 0, 0, 0]
    logged = [r for r in caplog.records
              if r.name == "mxnet_tpu_torch.quantization"]
    assert len(logged) == 1 and "chip_smoke.py" in logged[0].getMessage()


# -- the int8 matmul kernel's plain version and wrapper ----------------------


@pytest.mark.parametrize("m,k,n,scale,relu,out_scale,blocks", [
    # tests/test_int8_pallas.py's shapes and blocks
    (32, 64, 128, 0.0123, False, None, (32, 128, 64)),
    (64, 256, 128, 1.0, False, None, (32, 128, 64)),
    (16, 32, 128, 0.01, True, 3.7, (16, 128, 32)),
    (64, 256, 128, 3e-4, True, 31.0, (32, 128, 64)),
])
def test_int8_matmul_reference_matches_pallas(m, k, n, scale, relu,
                                              out_scale, blocks):
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas_kernels import int8_matmul as pallas_int8

    rng = onp.random.RandomState(15)
    lo, hi = (-50, 50) if relu else (-127, 128)
    x, w = _s8(rng, m, k, lo=lo, hi=hi), _s8(rng, k, n, lo=lo, hi=hi)
    bm, bn, bk = blocks
    j = pallas_int8(jnp.asarray(x), jnp.asarray(w), scale, relu=relu,
                    out_scale=out_scale, block_m=bm, block_n=bn, block_k=bk)
    t = ck.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w),
                                 scale, relu=relu, out_scale=out_scale)
    _eq(t, j)


def test_int8_matmul_ragged_m_matches_int64():
    """M = 392 (batch 8 at 7x7), which the TPU's int8_blocks refuses and the
    port's kernel takes; the plain version against numpy int64."""
    from mxnet_tpu.ops.pallas_kernels import int8_blocks

    m, k, n = 392, 512, 128
    assert int8_blocks(8 * 7 * 7, 512, 2048) is None
    assert ck.int8_fits(m, k, n) and ck.int8_fits(392, 512, 2048)
    rng = onp.random.RandomState(16)
    x, w = _s8(rng, m, k), _s8(rng, k, n)
    acc = x.astype(onp.int64) @ w.astype(onp.int64)
    scale = onp.float32(3e-4)
    out = ck.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), 3e-4)
    onp.testing.assert_array_equal(out.numpy(),
                                   acc.astype(onp.float32) * scale)
    q = ck.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), 3e-4,
                       relu=True, out_scale=31.0)
    want = onp.clip(onp.round(onp.maximum(acc.astype(onp.float32) * scale,
                                          0) * onp.float32(31.0)), -127, 127)
    onp.testing.assert_array_equal(q.numpy(), want.astype(onp.int8))


@pytest.mark.parametrize("m,k,n", [(5, 24, 8), (16, 64, 16), (17, 64, 16),
                                   (40, 36, 12), (33, 64, 40)])
def test_s8_matmul_s32_is_exact_on_both_routes(m, k, n):
    rng = onp.random.RandomState(17)
    x, w = _s8(rng, m, k, lo=-128), _s8(rng, k, n, lo=-128)
    x[0] = -128
    w[:, 0] = -128
    got = ck.s8_matmul_s32(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    onp.testing.assert_array_equal(got.numpy(),
                                   x.astype(onp.int64) @ w.astype(onp.int64))
    assert ck.int_mm_fits(m, k, n) == (m > 16 and k % 8 == 0 and n % 8 == 0)


@pytest.mark.parametrize("m,k,n,ok", [
    (25088, 512, 128, True), (392, 512, 2048, True), (1, 16, 16, True),
    (7, 48, 80, True), (32, 24, 128, False), (32, 64, 8, False),
    (32, 64, 24, False), (0, 64, 64, False), (32, 131072, 16, False),
    (32, 131056, 16, True)])
def test_int8_fits(m, k, n, ok):
    assert ck.int8_fits(m, k, n) is ok


def test_int8_matmul_refuses_and_cpu_launches_nothing():
    x = torch.zeros(32, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 16"):
        ck.int8_matmul(torch.zeros(32, 24, dtype=torch.int8),
                       torch.zeros(24, 128, dtype=torch.int8), 1.0)
    with pytest.raises(ValueError, match="multiples of 16"):
        ck.int8_matmul(x, torch.zeros(64, 8, dtype=torch.int8), 1.0)
    with pytest.raises(ValueError, match="expected"):
        ck.int8_matmul(x, torch.zeros(32, 16, dtype=torch.int8), 1.0)
    with pytest.raises(TypeError, match="int8"):
        ck.int8_matmul(x.int(), torch.zeros(64, 16, dtype=torch.int8), 1.0)
    before = ck.launch_counts()["int8_matmul"]
    out = ck.int8_matmul(x, torch.ones(64, 16, dtype=torch.int8), 0.5,
                         out_scale=2.0)
    assert out.dtype == torch.int8 and out.shape == (32, 16)
    assert ck.launch_counts()["int8_matmul"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(25088, 512, 128), (392, 512, 2048),
                                   (1000, 2048, 80), (5, 16, 16)])
def test_int8_kernel_matches_plain_on_card(cuda_device, m, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int8)
    for relu, out_scale in ((False, None), (True, 31.0)):
        n0 = ck.launch_counts()["int8_matmul"]
        out = ck.int8_matmul(x, w, 3e-4, relu=relu, out_scale=out_scale)
        torch.cuda.synchronize()
        assert ck.launch_counts()["int8_matmul"] == n0 + 1
        want = ck.int8_matmul_reference(x, w, 3e-4, relu=relu,
                                        out_scale=out_scale)
        assert out.dtype == want.dtype
        assert torch.equal(out, want)
    with pytest.raises(ValueError):
        ck.int8_matmul(x[:, :8], w[:8], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(100, 24, 40), (17, 8, 8), (33, 64, 40),
                                   (5, 24, 8), (32, 2048, 1000)])
def test_s8_matmul_s32_is_exact_on_card(cuda_device, m, k, n):
    """Both routes of the plain s32 product on the card, against int64 on
    the CPU; (100, 24, 40) is a shape cuBLASLt refuses with a row-major b."""
    rng = onp.random.RandomState(18)
    x, w = _s8(rng, m, k, lo=-128), _s8(rng, k, n, lo=-128)
    got = ck.s8_matmul_s32(torch.from_numpy(x).to(cuda_device),
                           torch.from_numpy(w).to(cuda_device))
    onp.testing.assert_array_equal(got.cpu().numpy(),
                                   x.astype(onp.int64) @ w.astype(onp.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (392, 512, 2048), (1568, 2048, 512), (1000, 48, 80), (77, 208, 16),
    (333, 16, 48), (5, 16, 16), (129, 48, 16), (1000, 640, 80),
    (25088, 512, 128), (100352, 64, 256)])
def test_int8_kernel_bitwise_at_the_edges(cuda_device, m, k, n):
    """chip_smoke.py's INT8_CASES and timed shapes, K = 16 and 48 (inside
    one 128-byte k-box), N = 16 and 80 (inside one 128-column tile, the
    rest clipped), ragged M, and K past the 512 up to which each CTA
    transposes w's panel itself (640, 2048: the kernel reads a K-major copy
    of w), each bitwise equal to the plain version with the fp32 and the
    s8 output."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int8)
    for relu, out_scale in ((False, None), (True, 31.0), (False, 0.07)):
        n0 = ck.launch_counts()["int8_matmul"]
        out = ck.int8_matmul(x, w, 3e-4, relu=relu, out_scale=out_scale)
        torch.cuda.synchronize()
        assert ck.launch_counts()["int8_matmul"] == n0 + 1
        want = ck.int8_matmul_reference(x, w, 3e-4, relu=relu,
                                        out_scale=out_scale)
        assert out.dtype == want.dtype and out.shape == (m, n)
        assert torch.equal(out, want)
