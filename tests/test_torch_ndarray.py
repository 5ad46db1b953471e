"""``mxnet_tpu_torch.nd.NDArray`` against the reference's NDArray, on the
CPU: the dtype creation policy, indexing (get and set), the in-place
operators, ``out=``, scalar arithmetic and comparisons. Each case computes
the reference's output in the test from the same numpy data; values must
match exactly (``rtol 0``) but for true division, powers and a sum, held
to ``rtol 1e-6``, and dtypes must be equal as strings. Also: the default context is
``gpu(0)`` (it raises without CUDA), ``with mx.cpu():`` and ``ctx=`` run
on the CPU, and the dispatch and host-read counters."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from test_torch_package import LazyModule

mx = LazyModule("mxnet_tpu")

_R = onp.random.RandomState(11)
F32 = (_R.rand(4, 5).astype(onp.float32) - 0.5) * 4
I32 = _R.randint(-9, 9, (4, 5)).astype(onp.int32)


def _t(x, **kw):
    return tmx.nd.array(x, ctx=tmx.cpu(), **kw)


def _same(got, want, rtol=0.0):
    want = onp.asarray(want.asnumpy() if hasattr(want, "asnumpy") else want)
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("src", [
    onp.zeros(3, onp.float64), onp.zeros(3, onp.float16),
    onp.zeros(3, onp.int64), onp.zeros(3, onp.int32), onp.zeros(3, onp.uint8),
    onp.zeros(3, bool), [1, 2, 3], [1.5, 2.5], 3.0],
    ids=lambda v: str(getattr(v, "dtype", type(v).__name__)))
def test_creation_dtype_policy(src):
    got = _t(src)
    want = mx.nd.array(src)
    assert str(got.dtype) == str(want.dtype)
    assert got.shape == want.shape


_A = onp.arange(6, dtype=onp.float32).reshape(2, 3)
# the reference's ops compute in JAX's 32-bit mode: a 64-bit dtype an op
# is asked for is its 32-bit one; only array creation keeps int64
DTYPE_CASES = {
    "array float64": lambda P: P.nd.array(_A, dtype="float64"),
    "array int64": lambda P: P.nd.array(_A, dtype="int64"),
    "array uint64": lambda P: P.nd.array(_A.astype(onp.uint64)),
    "array complex128": lambda P: P.nd.array(_A.astype(onp.complex128)),
    "zeros int64": lambda P: P.nd.zeros((2,), dtype="int64"),
    "zeros float64": lambda P: P.nd.zeros((2,), dtype="float64"),
    "arange int64": lambda P: P.nd.arange(3, dtype="int64"),
    "astype int64": lambda P: P.nd.array(_A).astype("int64"),
    "astype float64": lambda P: P.nd.array(_A).astype("float64"),
    "cast uint64": lambda P: P.nd.cast(P.nd.array(_A), dtype="uint64"),
    "randint int64": lambda P: P.nd.random.randint(0, 3, shape=(2,),
                                                   dtype="int64"),
    "one_hot int64": lambda P: P.nd.one_hot(P.nd.array([1, 2]), depth=3,
                                            dtype="int64"),
    "cumsum int64": lambda P: P.nd.cumsum(P.nd.array(_A), dtype="int64"),
    "argsort int64": lambda P: P.nd.argsort(P.nd.array(_A), dtype="int64"),
    "topk int64": lambda P: P.nd.topk(P.nd.array(_A), k=2, dtype="int64"),
}


@pytest.mark.parametrize("case", sorted(DTYPE_CASES))
def test_requested_dtypes_as_the_reference_makes_them(case):
    with tmx.cpu():
        got = DTYPE_CASES[case](tmx)
    assert str(got.dtype) == str(DTYPE_CASES[case](mx).dtype)


def test_explicit_dtypes():
    assert str(_t(F32, dtype="float16").dtype) == "float16"
    assert _t(F32, dtype="bfloat16").dtype == torch.bfloat16
    assert str(_t(I32, dtype="int64").dtype) == "int64"
    assert str(tmx.nd.NDArray(F32.astype(onp.float64),
                              ctx=tmx.cpu()).dtype) == "float32"


def test_default_context_is_the_gpu_and_cpu_is_asked_for():
    assert tmx.current_context() == tmx.gpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmx.nd.array(F32)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmx.nd.zeros((2,))
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        a = tmx.nd.array(F32)
        z = tmx.nd.zeros((2, 3))
        r = tmx.nd.random.uniform(shape=(2,))
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
        assert tmx.current_context() == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)
    for x in (a, z, r, tmx.nd.ones((2,), ctx=tmx.cpu()),
              tmx.nd.arange(3, ctx=tmx.cpu()),
              tmx.nd.random.normal(shape=(2,), ctx=tmx.cpu())):
        assert x._data.device.type == "cpu" and x.ctx == tmx.cpu()


GET_KEYS = [1, -1, (1, 2), slice(1, 3), (slice(None), 2), (Ellipsis, 1),
            (None, 1), slice(None, None, 2), slice(None, None, -1),
            (slice(3, 0, -2), slice(None)), onp.array([0, 2]),
            onp.array([3, 1, 1]), (onp.array([0, 1]), onp.array([2, 4])),
            F32[:, 0] > 0]


@pytest.mark.parametrize("key", GET_KEYS, ids=repr)
def test_getitem(key):
    _same(_t(F32)[key], mx.nd.array(F32)[key])


def test_getitem_with_an_ndarray_key_and_bounds():
    idx = onp.array([2, 0], onp.int32)
    _same(_t(F32)[_t(idx)], mx.nd.array(F32)[mx.nd.array(idx)])
    with pytest.raises(IndexError):
        _t(F32)[4]
    with pytest.raises(IndexError):
        _t(F32)[0, -6]


SET_CASES = [(1, 7.0), ((0, 2), -1.0), (slice(1, 3), 2.5),
             ((slice(None), 1), F32[:, 3]), (Ellipsis, 0.5),
             (slice(None), F32[0]), (onp.array([0, 3]), 9.0),
             ((slice(None), slice(None, None, -2)), F32[:, :3]),
             (F32 > 0, 0.0)]


@pytest.mark.parametrize("key,value", SET_CASES,
                         ids=lambda v: repr(v)[:20])
def test_setitem(key, value):
    got, want = _t(F32), mx.nd.array(F32)
    got[key] = value
    want[key] = value
    _same(got, want)
    assert got.version == 1


def test_setitem_casts_to_the_arrays_dtype():
    got, want = _t(I32), mx.nd.array(I32)
    got[0] = 2.7
    want[0] = 2.7
    _same(got, want)


def test_writes_never_touch_another_arrays_tensor():
    a = _t(F32)
    view = a.reshape((5, 4))
    a[0] = 100.0
    a += 1
    onp.testing.assert_array_equal(view.asnumpy(), F32.reshape(5, 4))


BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__mod__",
          "__pow__", "__radd__", "__rsub__", "__rmul__", "__rtruediv__",
          "__rmod__", "__rpow__", "__eq__", "__ne__", "__gt__", "__ge__",
          "__lt__", "__le__"]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("src", [F32, I32], ids=["f32", "i32"])
@pytest.mark.parametrize("other", ["scalar", "array"])
def test_arithmetic_and_comparisons(op, src, other):
    if op in ("__pow__", "__rpow__"):
        # a negative integer exponent is undefined in both packages
        base = onp.abs(src) + (0.5 if src is F32 else 0)
    else:
        base = src
    o = 3 if other == "scalar" else (onp.abs(base[::-1]) + 1).astype(
        base.dtype)
    if src is I32 and op in ("__rpow__", "__pow__") and other == "array":
        o = onp.abs(o) % 3
    got = getattr(_t(base), op)(o if other == "scalar" else _t(o))
    want = getattr(mx.nd.array(base), op)(
        o if other == "scalar" else mx.nd.array(o))
    rtol = 1e-6 if "truediv" in op or "pow" in op else 0.0
    _same(got, want, rtol)


@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__",
                                "__itruediv__"])
@pytest.mark.parametrize("other", [2.5, F32[::-1].copy()],
                         ids=["scalar", "array"])
def test_inplace_operators(op, other):
    got, want = _t(F32), mx.nd.array(F32)
    g = getattr(got, op)(_t(other) if isinstance(other, onp.ndarray)
                         else other)
    w = getattr(want, op)(mx.nd.array(other) if isinstance(
        other, onp.ndarray) else other)
    assert g is got
    _same(g, w, 1e-6 if "div" in op else 0.0)
    assert got.version == 1


def test_inplace_on_a_recorded_variable_raises():
    a = _t(F32)
    a.attach_grad()
    with tmx.autograd.record():
        with pytest.raises(MXNetError, match="in-place"):
            a += 1
    a += 1                                     # allowed outside record
    assert a._data.requires_grad and a._data.is_leaf


def test_out_writes_into_given_arrays():
    x = _t(F32)
    dest = tmx.nd.zeros((4, 5), ctx=tmx.cpu())
    res = tmx.nd.relu(x, out=dest)
    assert res is dest and dest.version == 1
    w, g, m = _t(F32), _t(F32 * 0.1), tmx.nd.zeros((4, 5), ctx=tmx.cpu())
    tmx.nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, out=[w, m])
    rw, rg, rm = (mx.nd.array(F32), mx.nd.array(F32 * 0.1),
                  mx.nd.zeros((4, 5)))
    mx.nd.sgd_mom_update(rw, rg, rm, lr=0.1, momentum=0.9, out=[rw, rm])
    _same(w, rw)
    _same(m, rm)
    half = tmx.nd.zeros((4, 5), ctx=tmx.cpu(), dtype="float16")
    tmx.nd.relu(x, out=half)
    assert str(half.dtype) == "float16"


def test_methods_and_host_reads():
    a, r = _t(F32), mx.nd.array(F32)
    _same(a.T, r.T)
    _same(a.reshape(2, 10), r.reshape(2, 10))
    _same(a.sum(axis=1), r.sum(axis=1), 1e-6)     # another summation order
    _same(a.argmax(axis=0), r.argmax(axis=0))
    _same(a.astype("int32"), r.astype("int32"))
    _same(a.clip(-1, 1), r.clip(-1, 1))
    assert a[0, 0].asscalar() == r[0, 0].asscalar()
    assert float(a[1, 2]) == float(r[1, 2])
    assert a.tolist() == r.tolist()
    assert len(a) == 4 and a.size == 20 and a.ndim == 2
    with pytest.raises(ValueError):
        a.asscalar()
    reads = tmx.nd.host_sync_count()
    a.asnumpy()
    assert tmx.nd.host_sync_count() == reads + 1


def test_invoke_counts_one_dispatch_per_op():
    a = _t(F32)
    n = tmx.nd.invoke_count()
    (a + 1).relu().sum()
    assert tmx.nd.invoke_count() == n + 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_arrays_default_to_the_card(cuda_device):
    a = tmx.nd.array(F32)
    assert a.ctx == tmx.gpu(0) and a._data.device.type == "cuda"
    assert tmx.nd.zeros((2,))._data.device.type == "cuda"
    assert tmx.nd.random.normal(shape=(2,))._data.device.type == "cuda"
    onp.testing.assert_allclose((a * 2).asnumpy(), F32 * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_fused_conv1x1_bn", "_fused_convkxk_bn",
                                  "_fused_conv1x1_bn_act"])
def test_fused_ops_launch_their_kernels_on_the_card(cuda_device, name):
    """A fused op on CUDA NDArrays launches its kernels (the wrappers'
    launch counts move) and agrees with its plain version on the CPU."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    rng = onp.random.RandomState(0)
    kw = 3 if "kxk" in name else 1
    arrays = [rng.randn(2, 6, 6, 8).astype(onp.float32),
              (rng.randn(8, kw, kw, 8) * 0.3).astype(onp.float32),
              onp.ones(8, onp.float32), onp.zeros(8, onp.float32)]
    c0 = ck.launch_counts()
    got = tmx.nd.invoke(name, [tmx.nd.array(a) for a in arrays], {})
    c1 = ck.launch_counts()
    assert sum(c1.values()) > sum(c0.values())
    with tmx.cpu():
        want = tmx.nd.invoke(name, [tmx.nd.array(a) for a in arrays], {})
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-4,
                                    atol=1e-5)


@pytest.mark.cuda
def test_recorded_grads_on_the_card(cuda_device):
    a = tmx.nd.array(F32)
    a.attach_grad()
    with tmx.autograd.record():
        y = (a * a).sum()
    y.backward()
    assert a.grad._data.device.type == "cuda"
    onp.testing.assert_allclose(a.grad.asnumpy(), 2 * F32, rtol=1e-6)
