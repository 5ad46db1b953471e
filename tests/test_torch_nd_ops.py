"""The port's op surface (``mxnet_tpu_torch.ops``: elemwise, tensor,
reduce, init, random, nn, optimizer) against the reference's, op by op.

Each case feeds the same numpy inputs (``op_smoke_specs.SPECS``, else a
seeded (4, 6) input per array as ``test_op_coverage.py`` builds it)
through ``mx.nd.invoke`` in both packages, on the CPU, and compares every
output: the same dtype (as a string), the same shape, values within
``rtol 1e-5, atol 1e-6`` (fp32). Differentiable ops also compare the
gradient of the sum of their float outputs with respect to each float
input, within the same bound but for the four in ``GRAD_TOL`` (each with
its reason): the port's through ``autograd.record`` / ``autograd.grad`` on
NDArrays, the reference's through ``jax.grad`` of its ``schema.fn``, as
``test_op_coverage.py:77-98`` takes it.

The fused conv + batch-norm ops run the reference's Pallas kernels in
interpret mode and the port's plain versions at the specs' toy sizes, with
8 input channels instead of the specs' 4 (and centred normal draws, which
keep the single-pass batch variance well conditioned): the port's kernels
take channel counts that are multiples of 8 (``cuda_kernels.epilogue_fits``,
``convkxk_fits``), and their plain versions keep the same rule on the CPU,
so the specs' Cin 4 raises there (``test_fused_ops_keep_the_kernel_rule``).
The samplers are held by shape, dtype and moments, and the same seed must
give the same draws within the port.
"""
import zlib

import numpy as onp
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ops.registry import get_op as tget_op
from mxnet_tpu_torch.ops.registry import list_ops as tlist_ops
from op_smoke_specs import SPECS
from test_torch_package import LazyModule

mx = LazyModule("mxnet_tpu")
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
rget_op = LazyModule("mxnet_tpu.ops.registry", "get_op")

RTOL, ATOL = 1e-5, 1e-6

# looser bounds of the gradients, each with its reason (rtol, atol): the
# gradient of the sum of a normalized output with respect to its input and
# its scale is zero in exact arithmetic (a normalized group sums to a
# constant), so both sides hold fp32 rounding noise of that zero, summed
# over the group. Every forward holds at RTOL, ATOL.
GRAD_TOL = {"InstanceNorm": (1e-5, 3e-5), "_fused_conv1x1_bn": (1e-5, 1e-5),
            "_fused_convkxk_bn": (1e-5, 1e-5),
            "_fused_conv1x1_bn_act": (1e-5, 1e-5)}

RANDOM_OPS = ("uniform", "normal", "random_gamma", "exponential", "poisson",
              "negative_binomial", "randint", "randn", "multinomial",
              "shuffle", "bernoulli")

ALL_OPS = tlist_ops()
DETERMINISTIC = [n for n in ALL_OPS if n not in RANDOM_OPS]
DIFF_OPS = [n for n in DETERMINISTIC if tget_op(n).differentiable]


_FUSED = ("_fused_conv1x1_bn", "_fused_convkxk_bn", "_fused_conv1x1_bn_act")


def _inputs(name):
    if name in _FUSED:
        arrays, attrs = SPECS[name]
        gen = onp.random.RandomState(zlib.crc32(name.encode()))
        x, w = arrays[0], arrays[1]
        x8 = gen.standard_normal((*x.shape[:3], 8)).astype(onp.float32)
        w8 = (gen.standard_normal((*w.shape[:3], 8)) * 0.3).astype(
            onp.float32)
        return [x8, w8] + [onp.asarray(a) for a in arrays[2:]], dict(attrs)
    if name in SPECS:
        arrays, attrs = SPECS[name]
        return [onp.asarray(a) for a in arrays], dict(attrs)
    schema = tget_op(name)
    n = 2 if schema.num_inputs == -1 else schema.num_inputs
    gen = onp.random.RandomState(zlib.crc32(name.encode()))
    return [gen.rand(4, 6).astype(onp.float32) + 0.1 for _ in range(n)], {}


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _port_forward(name, arrays, attrs):
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in arrays]
        return _outs(tmx.nd.invoke(name, nds, dict(attrs)))


def _ref_forward(name, arrays, attrs):
    nds = [mx.nd.array(a) for a in arrays]
    return _outs(mx.nd.invoke(rget_op(name), nds, dict(attrs)))


def _close(got, want, tol, what):
    rtol, atol = tol
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
        f"{want.shape}"
    if want.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, want, err_msg=what)
    else:
        onp.testing.assert_allclose(got.astype(onp.float64),
                                    want.astype(onp.float64), rtol=rtol,
                                    atol=atol, equal_nan=True, err_msg=what)


def test_spec_ops_are_ported_ops():
    """Every op of the seven modules is driven here; none is skipped."""
    assert len(ALL_OPS) == 228
    assert len(DETERMINISTIC) + len(RANDOM_OPS) == len(ALL_OPS)


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_forward_matches_reference(name):
    arrays, attrs = _inputs(name)
    got = _port_forward(name, arrays, attrs)
    want = _ref_forward(name, arrays, attrs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype) == str(w.dtype), \
            f"{name} output {i}: dtype {g.dtype} != {w.dtype}"
        _close(g.asnumpy(), onp.asarray(w.asnumpy()),
               (RTOL, ATOL), f"{name} output {i}")


@pytest.mark.parametrize("name", _FUSED)
def test_fused_ops_keep_the_kernel_rule(name):
    """At the specs' Cin 4 the port's fused ops refuse on the CPU as the
    kernels do on the card (the reference's Pallas kernels take it)."""
    arrays, attrs = SPECS[name]
    with pytest.raises(ValueError, match="multiples of 8"):
        _port_forward(name, arrays, attrs)


def _float_idx(arrays):
    return [i for i, a in enumerate(arrays)
            if onp.issubdtype(onp.asarray(a).dtype, onp.floating)]


def _port_grads(name, arrays, attrs, float_idx):
    with tmx.cpu():
        nds = [tmx.nd.array(a) for a in arrays]
        with tag.record():
            outs = _outs(tmx.nd.invoke(name, nds, dict(attrs)))
            heads = [o.astype("float32").sum() for o in outs
                     if onp.issubdtype(onp.dtype(str(o.dtype)
                                                 .replace("torch.", "")),
                                       onp.floating)]
        return [g.asnumpy() for g in tag.grad(heads,
                                              [nds[i] for i in float_idx])]


def _ref_grads(name, arrays, attrs, float_idx):
    schema = rget_op(name)
    jarrs = [jnp.asarray(a) for a in arrays]

    def loss(fl):
        full = list(jarrs)
        for i, v in zip(float_idx, fl):
            full[i] = v
        out = schema.fn(full, **attrs) if schema.num_inputs == -1 \
            else schema.fn(*full, **attrs)
        return sum(jnp.sum(o.astype(jnp.float32)) for o in _outs(out)
                   if jnp.issubdtype(o.dtype, jnp.floating))

    return [onp.asarray(g) for g in
            jax.grad(loss)([jarrs[i] for i in float_idx])]


@pytest.mark.parametrize("name", DIFF_OPS)
def test_gradient_matches_reference(name):
    arrays, attrs = _inputs(name)
    float_idx = _float_idx(arrays)
    assert float_idx, f"{name}: a differentiable op with no float input"
    got = _port_grads(name, arrays, attrs, float_idx)
    want = _ref_grads(name, arrays, attrs, float_idx)
    for i, g, w in zip(float_idx, got, want):
        _close(g, w, GRAD_TOL.get(name, (RTOL, ATOL)),
               f"{name} d/d input {i}")


# -- the samplers ---------------------------------------------------------------

N = 200_000
# (attrs, mean, variance) of each sampler at its attrs
MOMENTS = {
    "uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "normal": (dict(loc=0.5, scale=2.0), 0.5, 4.0),
    "random_gamma": (dict(alpha=2.5, beta=0.5), 1.25, 0.625),
    "exponential": (dict(lam=2.0), 0.5, 0.25),
    "poisson": (dict(lam=3.0), 3.0, 3.0),
    "negative_binomial": (dict(k=3, p=0.4), 4.5, 11.25),
    "randint": (dict(low=2, high=10), 5.5, (8 ** 2 - 1) / 12),
    "randn": (dict(loc=-1.0, scale=0.5), -1.0, 0.25),
    "bernoulli": (dict(prob=0.3), 0.3, 0.21),
}


@pytest.mark.parametrize("name", RANDOM_OPS)
def test_sampler_shape_and_dtype_match_reference(name):
    arrays, attrs = _inputs(name)
    got = _port_forward(name, arrays, attrs)
    want = _ref_forward(name, arrays, attrs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), name


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_sampler_moments(name):
    """Mean and variance of N draws within 5 standard errors (variance:
    within 5% for the continuous samplers' fourth moments)."""
    attrs, mean, var = MOMENTS[name]
    with tmx.cpu():
        tmx.random.seed(0)
        x = tmx.nd.invoke(name, [], dict(attrs, shape=(N,))).asnumpy()
    x = x.astype(onp.float64)
    assert abs(x.mean() - mean) < 5 * (var / N) ** 0.5, (x.mean(), mean)
    assert abs(x.var() - var) < 0.05 * var, (x.var(), var)


def test_multinomial_and_shuffle_draws():
    probs = onp.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], onp.float32)
    with tmx.cpu():
        tmx.random.seed(0)
        d = tmx.nd.array(probs)
        draws = tmx.nd.invoke("multinomial", [d], {"shape": N}).asnumpy()
        data = tmx.nd.array(onp.arange(20, dtype=onp.float32).reshape(10, 2))
        rows = tmx.nd.invoke("shuffle", [data], {}).asnumpy()
    for r in range(2):
        freq = onp.bincount(draws[r], minlength=3) / N
        onp.testing.assert_allclose(freq, probs[r], atol=0.01)
    assert sorted(map(tuple, rows)) == sorted(map(tuple, data.asnumpy()))


@pytest.mark.parametrize("name", RANDOM_OPS)
def test_same_seed_same_draws(name):
    arrays, attrs = _inputs(name)
    if not arrays:
        attrs = dict(MOMENTS.get(name, ({},))[0], shape=(64,))
    draws = []
    for seed in (3, 3, 4):
        with tmx.cpu():
            tmx.random.seed(seed)
            nds = [tmx.nd.array(a) for a in arrays]
            draws.append(tmx.nd.invoke(name, nds, dict(attrs)).asnumpy())
    onp.testing.assert_array_equal(draws[0], draws[1])
    if name != "shuffle":
        assert not onp.array_equal(draws[0], draws[2]), name


def test_dropout_trains_and_scales():
    x = onp.ones((400, 500), onp.float32)
    with tmx.cpu():
        out = tmx.nd.Dropout(tmx.nd.array(x), p=0.25, training=True)
    v = out.asnumpy()
    assert set(onp.unique(v)) <= {0.0, onp.float32(1 / 0.75)}
    assert abs((v == 0).mean() - 0.25) < 0.01
