"""The port's conv + batch-norm statistics kernels (mxnet_tpu_torch.ops:
``matmul_bn_stats``, ``convkxk_bn_stats`` and their differentiable
``conv1x1_bn_stats_train`` / ``convkxk_bn_stats_train``), held against the
JAX package's Pallas kernels (mxnet_tpu.ops.pallas_kernels) run in interpret
mode on the CPU, as tests/test_fused_conv_bn.py and tests/test_pallas.py run
them. Inputs are numpy from a seed.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions by the
``cuda``-marked test below (and by chip_smoke.py), which skips without a
card.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
pk = LazyModule("mxnet_tpu.ops.pallas_kernels")

# fp32: both sides sum the same fp32 products in other orders (the Pallas
# kernel over its k-blocks and taps, torch's matmul and conv in theirs)
OUT_TOL = dict(rtol=2e-4, atol=2e-4)      # z, y, statistics
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)     # gradients (as the reference's
                                          # own fused-vs-unfused tests)
# bf16 inputs: the products are exact in fp32 on both sides and the sums
# fp32, so the statistics keep OUT_TOL; z is rounded once to bf16 (2^-9
# relative), so a value near a rounding boundary may land one ulp (2^-8
# relative) apart
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# the image border is scaled up, so that a tap read from the wrong side of
# the padding (or a missing zero-fill) shows
BORDER = 10.0


def _rand(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale) \
        .astype(onp.float32)


def _t(a):
    return torch.from_numpy(onp.array(a))


def _bf16(a):
    """A jnp bf16 array and the torch bf16 tensor of the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(onp.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _image(seed, n, h, w, c):
    x = _rand(seed, n, h, w, c)
    x[:, [0, -1]] *= BORDER
    x[:, :, [0, -1]] *= BORDER
    return x


# ---------------------------------------------------------------------------
# matmul_bn_stats (B4)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m,k,n,blocks", [
    (96, 64, 48, (32, 16, 32)),       # several m- and n-steps: the TPU
    (64, 32, 16, (32, 16, 16)),       # kernel's sequential accumulation
    (16, 8, 8, (16, 8, 8)),
])
def test_matmul_bn_stats_matches_pallas(m, k, n, blocks, relu):
    x, w = _rand(m + k, m, k), _rand(n, k, n)
    bm, bn, bk = blocks
    jy, js, jss = pk.matmul_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                     relu=relu, block_m=bm, block_n=bn,
                                     block_k=bk)
    ty, ts, tss = ck.matmul_bn_stats(_t(x), _t(w), relu=relu)
    assert ty.dtype == torch.float32 and ty.shape == (m, n)
    assert ts.dtype == tss.dtype == torch.float32 and ts.shape == (n,)
    for t, j in ((ty, jy), (ts, js), (tss, jss)):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), **OUT_TOL)
    if relu:
        assert (ty >= 0).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("n", [8, 72, 264])
def test_bf16_matmul_bn_stats_matches_pallas_at_the_edges(k, n, relu):
    # the shapes the card's kernel takes at its edges: ragged M, K inside
    # one k-box, N inside one tile or over several n-tiles
    m = 77
    jx, tx = _bf16(_rand(m + k + n, m, k))
    jw, tw = _bf16(_rand(n, k, n, scale=k ** -0.5))
    jy, js, jss = pk.matmul_bn_stats(jx, jw, relu=relu, block_m=m,
                                     block_n=n, block_k=k)
    ty, ts, tss = ck.matmul_bn_stats(tx, tw, relu=relu)
    assert ty.dtype == torch.bfloat16 and ty.shape == (m, n)
    onp.testing.assert_allclose(ty.float().numpy(),
                                onp.asarray(jy.astype(jnp.float32)),
                                **BF16_TOL)
    # the statistics come from the fp32 values, before y's rounding
    onp.testing.assert_allclose(ts.numpy(), onp.asarray(js), **OUT_TOL)
    onp.testing.assert_allclose(tss.numpy(), onp.asarray(jss), **OUT_TOL)


def test_matmul_bn_stats_bf16_matches_pallas():
    jx, tx = _bf16(_rand(1, 64, 32))
    jw, tw = _bf16(_rand(2, 32, 16, scale=0.25))
    jy, js, jss = pk.matmul_bn_stats(jx, jw, relu=True, block_m=32,
                                     block_n=16, block_k=32)
    ty, ts, tss = ck.matmul_bn_stats(tx, tw, relu=True)
    assert ty.dtype == torch.bfloat16
    onp.testing.assert_allclose(ty.float().numpy(),
                                onp.asarray(jy.astype(jnp.float32)),
                                **BF16_TOL)
    # the statistics come from the fp32 values, before y's rounding
    onp.testing.assert_allclose(ts.numpy(), onp.asarray(js), **OUT_TOL)
    onp.testing.assert_allclose(tss.numpy(), onp.asarray(jss), **OUT_TOL)


# ---------------------------------------------------------------------------
# conv1x1_bn_stats_train: forward and vjp
# ---------------------------------------------------------------------------


def _vjp_pair(jfn, tfn, args, cts):
    """Outputs and input gradients of the JAX and the port's function on
    the same numpy args and cotangents (z, mean, var)."""
    jouts, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [_t(a).requires_grad_() for a in args]
    touts = tfn(*leaves)
    tgrads = torch.autograd.grad(touts, leaves, tuple(_t(c) for c in cts))
    return jouts, jgrads, touts, tgrads


def _assert_vjp(res):
    jouts, jgrads, touts, tgrads = res
    for name, t, j in zip(("z", "mean", "var"), touts, jouts):
        assert t.dtype == torch.float32
        onp.testing.assert_allclose(t.detach().numpy(), onp.asarray(j),
                                    err_msg=name, **OUT_TOL)
    for name, t, j in zip(("x", "w"), tgrads, jgrads):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j),
                                    err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 4, 4, 8, 16),
                                            (3, 5, 3, 16, 8)])
def test_conv1x1_bn_stats_train_matches_pallas(n, h, w, cin, cout):
    """z, mean, var and the vjp of x and w with cotangents on all three,
    against jax.vjp of pallas_kernels.conv1x1_bn_stats_train."""
    x, wt = _rand(10, n, h, w, cin), _rand(11, cout, 1, 1, cin)
    cts = (_rand(12, n, h, w, cout), _rand(13, cout), _rand(14, cout))
    _assert_vjp(_vjp_pair(pk.conv1x1_bn_stats_train,
                          ck.conv1x1_bn_stats_train, (x, wt), cts))


def test_conv1x1_bn_stats_train_bf16_matches_pallas():
    x, w = _rand(20, 2, 4, 4, 16), _rand(21, 32, 1, 1, 16, scale=0.25)
    (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
    gz = _rand(22, 2, 4, 4, 32)
    jgz, tgz = _bf16(gz)
    gmean, gvar = _rand(23, 32), _rand(24, 32)
    jouts, vjp = jax.vjp(pk.conv1x1_bn_stats_train, jx, jw)
    jgrads = vjp((jgz, jnp.asarray(gmean), jnp.asarray(gvar)))
    leaves = [tx.requires_grad_(), tw.requires_grad_()]
    touts = ck.conv1x1_bn_stats_train(*leaves)
    assert touts[0].dtype == torch.bfloat16
    assert touts[1].dtype == touts[2].dtype == torch.float32
    tgrads = torch.autograd.grad(touts, leaves,
                                 (tgz, _t(gmean), _t(gvar)))
    onp.testing.assert_allclose(touts[0].float().detach().numpy(),
                                onp.asarray(jouts[0].astype(jnp.float32)),
                                **BF16_TOL)
    for t, j in zip(touts[1:], jouts[1:]):
        onp.testing.assert_allclose(t.detach().numpy(), onp.asarray(j),
                                    **OUT_TOL)
    # bf16 gradients: g and the products' outputs are rounded to bf16, so
    # compare relative to each gradient's largest entry
    for name, t, j in zip(("x", "w"), tgrads, jgrads):
        j = onp.asarray(j.astype(jnp.float32))
        err = onp.abs(t.float().numpy() - j).max()
        assert err <= 2e-2 * onp.abs(j).max(), (name, err)


# ---------------------------------------------------------------------------
# convkxk_bn_stats (B8) and its vjp
# ---------------------------------------------------------------------------

# (x shape, cout, kernel, pad): the bottleneck's 3x3/pad 1, the s2d stem's
# 4x4/pad 0, and non-square kernels with unequal padding; rectangular
# images throughout
KXK_CASES = [
    ((2, 6, 5, 8), 16, (3, 3), (1, 1)),
    ((2, 7, 6, 16), 8, (4, 4), (0, 0)),
    ((1, 5, 7, 8), 8, (3, 5), (1, 2)),
    ((2, 4, 6, 8), 16, (2, 3), (1, 0)),
]


@pytest.mark.parametrize("xshape,cout,kernel,pad", KXK_CASES)
def test_convkxk_bn_stats_matches_pallas(xshape, cout, kernel, pad):
    x = _image(30, *xshape)
    w = _rand(31, cout, *kernel, xshape[3], scale=0.3)
    jz, jmean, jvar = pk.convkxk_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                          pad)
    tz, tmean, tvar = ck.convkxk_bn_stats(_t(x), _t(w), pad)
    assert tz.shape == jz.shape and tz.dtype == torch.float32
    assert tz.is_contiguous()
    for t, j in ((tz, jz), (tmean, jmean), (tvar, jvar)):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), **OUT_TOL)


@pytest.mark.parametrize("xshape,cout,kernel,pad", KXK_CASES[:3])
def test_convkxk_bn_stats_train_matches_pallas(xshape, cout, kernel, pad):
    x = _image(40, *xshape)
    w = _rand(41, cout, *kernel, xshape[3], scale=0.3)
    n, h, wd, _ = xshape
    zshape = (n, h + 2 * pad[0] - kernel[0] + 1,
              wd + 2 * pad[1] - kernel[1] + 1, cout)
    cts = (_rand(42, *zshape), _rand(43, cout), _rand(44, cout))
    _assert_vjp(_vjp_pair(
        lambda a, b: pk.convkxk_bn_stats_train(a, b, pad),
        lambda a, b: ck.convkxk_bn_stats_train(a, b, pad), (x, w), cts))


def test_convkxk_bn_stats_bf16_matches_pallas():
    (jx, tx) = _bf16(_image(50, 2, 6, 6, 16))
    (jw, tw) = _bf16(_rand(51, 8, 3, 3, 16, scale=0.1))
    jz, jmean, jvar = pk.convkxk_bn_stats(jx, jw, (1, 1))
    tz, tmean, tvar = ck.convkxk_bn_stats(tx, tw, (1, 1))
    assert tz.dtype == torch.bfloat16
    onp.testing.assert_allclose(tz.float().numpy(),
                                onp.asarray(jz.astype(jnp.float32)),
                                **BF16_TOL)
    onp.testing.assert_allclose(tmean.numpy(), onp.asarray(jmean),
                                **OUT_TOL)
    onp.testing.assert_allclose(tvar.numpy(), onp.asarray(jvar), **OUT_TOL)


def test_bias_gradient_is_written():
    """A conv bias reaches no output of the statistics functions: a backward
    still writes its gradient, 0, as the reference's op writes it."""
    x, w = _t(_rand(60, 2, 4, 4, 8)), _t(_rand(61, 8, 3, 3, 8))
    for fn in (lambda b: ck.conv1x1_bn_stats_train(x, w[:, 1:2, 1:2],
                                                   bias=b),
               lambda b: ck.convkxk_bn_stats_train(x, w, (1, 1), bias=b)):
        b = torch.ones(8, requires_grad=True)
        z, mean, var = fn(b)
        (db,) = torch.autograd.grad(z.sum() + mean.sum() + var.sum(), [b])
        assert db is not None and not db.any()


# ---------------------------------------------------------------------------
# rules, refusals, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xshape,cout,kernel,pad,dtype,ok", [
    ((128, 56, 56, 64), 64, (3, 3), (1, 1), torch.bfloat16, True),
    ((128, 7, 7, 512), 512, (3, 3), (1, 1), torch.bfloat16, True),
    ((8, 57, 57, 12), 64, (4, 4), (0, 0), torch.float32, False),  # Cin 12
    ((2, 9, 9, 8), 20, (3, 3), (1, 1), torch.float32, False),     # Cout 20
    ((2, 9, 9, 8), 8, (3, 3), (3, 3), torch.float32, False),      # pad 3
    ((2, 9, 9, 8), 8, (3, 3), (1, 1), torch.float16, False),      # fp16
    ((2, 2, 2, 8), 8, (5, 5), (1, 1), torch.float32, False),      # empty
    ((2, 9, 9, 8), 8, (3, 5), (1, 2), torch.float32, True)])
def test_convkxk_fits(xshape, cout, kernel, pad, dtype, ok):
    assert ck.convkxk_fits(xshape, cout, kernel, pad, dtype) is ok


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.matmul_bn_stats(torch.zeros(16, 12), torch.zeros(12, 16))
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.convkxk_bn_stats(torch.zeros(1, 4, 4, 12), torch.zeros(8, 3, 3, 12))
    with pytest.raises(ValueError, match="pad < kernel"):
        ck.convkxk_bn_stats(torch.zeros(1, 4, 4, 8), torch.zeros(8, 3, 3, 8),
                            (3, 1))
    with pytest.raises(ValueError, match="expected"):
        ck.convkxk_bn_stats(torch.zeros(1, 4, 4, 8), torch.zeros(8, 3, 3, 16))


def test_cpu_wrappers_launch_nothing():
    before = ck.launch_counts()
    ck.matmul_bn_stats(torch.ones(16, 8), torch.ones(8, 8), relu=True)
    ck.convkxk_bn_stats(torch.ones(1, 4, 4, 8), torch.ones(8, 3, 3, 8))
    assert ck.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card: kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    # statistics: fp32 sums in another order; z, y: one rounding to dtype
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1000, 64, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(128, 64, generator=g, device=cuda_device) / 8).to(
        dtype).t()
    img = torch.randn(3, 13, 11, 16, generator=g, device=cuda_device)
    img[:, [0, -1]] *= BORDER
    img[:, :, [0, -1]] *= BORDER
    img = img.to(dtype)
    wk = (torch.randn(24, 3, 3, 16, generator=g, device=cuda_device)
          / 12).to(dtype)
    n0 = ck.launch_counts()
    y, s, ss = ck.matmul_bn_stats(x, w, relu=True)
    z, mean, var = ck.convkxk_bn_stats(img, wk, (1, 1))
    torch.cuda.synchronize()
    n1 = ck.launch_counts()
    assert n1["matmul_bn_stats"] == n0["matmul_bn_stats"] + 1
    assert n1["convkxk_bn_stats"] == n0["convkxk_bn_stats"] + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for got, want in zip((y, s, ss),
                         ck.matmul_bn_stats_reference(x, w, relu=True)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    for got, want in zip((z, mean, var),
                         ck.convkxk_bn_stats_reference(img, wk, (1, 1))):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.fixture
def bf16_stats_inputs(cuda_device):
    def make(m, k, n, seed):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        x = torch.randn(m, k, generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=cuda_device)
             / k ** 0.5).to(torch.bfloat16).t()
        return x, w
    return make


def _check_bn_stats(x, w, relu, out):
    # chip_smoke.py's check_bn_stats bounds: the sums within 1e-5 of the
    # sum of magnitudes (fp32 sums in another order); y within 1e-5 of
    # |x| @ |w| plus one bf16 ulp (2^-7 relative) of the fp32 act(z)
    y, s, ss = out
    z = x.float() @ w.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    assert y.shape == z.shape and y.dtype == torch.bfloat16
    assert torch.isfinite(s).all() and torch.isfinite(ss).all()
    assert ((s - z.sum(0)).abs() <= 1e-5 * z.abs().sum(0)).all()
    assert ((ss - (z * z).sum(0)).abs() <= 1e-5 * (z * z).sum(0)).all()
    mag = x.float().abs() @ w.float().abs()
    ref = z.to(torch.bfloat16).float()
    assert ((y.float() - ref).abs()
            <= 1e-5 * mag + 2.0 ** -7 * ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m", [77, 1000])
@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("n", [8, 72, 264, 2048])
def test_bn_stats_kernel_matches_plain_at_the_edges(bf16_stats_inputs, m, k,
                                                    n, relu):
    # N inside one tile, and several n-tiles with a narrow last one (the
    # TMA store clips it, the sums skip it); K inside one k-box; ragged M
    x, w = bf16_stats_inputs(m, k, n, m + k + n)
    n0 = ck.launch_counts()["matmul_bn_stats"]
    out = ck.matmul_bn_stats(x, w, relu)
    torch.cuda.synchronize()
    assert ck.launch_counts()["matmul_bn_stats"] == n0 + 1
    _check_bn_stats(x, w, relu, out)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m,k,n", [(40000, 64, 2048), (20000, 24, 264),
                                   (10000, 136, 1032), (401408, 64, 256),
                                   (6272, 512, 2048)])
def test_bn_stats_kernel_walks_several_tiles_bitwise_repeatably(
        bf16_stats_inputs, m, k, n, relu):
    # every CTA sums several m-tiles of its n-tile (the scratch's every
    # column written), and y and the sums repeat bit for bit
    x, w = bf16_stats_inputs(m, k, n, 12)
    first = ck.matmul_bn_stats(x, w, relu)
    second = ck.matmul_bn_stats(x, w, relu)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _check_bn_stats(x, w, relu, first)


# (x shape, Cout, kernel, pad) beyond the ResNet-50 sites, as chip_smoke.py's
# KXK_CASES: Cin 8 to 128 (a k-box reaching past Cin), M not a multiple of
# the 128-pixel tiles, rectangular images, 4x4/pad 0, non-square kernels
# with unequal padding, 5x5/pad 2, Cout not a multiple of a tile
KXK_CARD_CASES = [((3, 13, 11, 16), 24, (3, 3), (1, 1)),
                  ((2, 17, 9, 32), 64, (4, 4), (0, 0)),
                  ((1, 9, 23, 8), 16, (3, 5), (1, 2)),
                  ((5, 7, 7, 64), 8, (1, 3), (0, 1)),
                  ((2, 30, 30, 128), 136, (3, 3), (1, 1)),
                  ((1, 11, 10, 24), 40, (5, 5), (2, 2)),
                  ((7, 5, 6, 16), 72, (2, 2), (1, 0))]
# the four 3x3 site shapes of the ResNet-50 step at batch 128
KXK_SITES = [((128, 56 >> st, 56 >> st, 64 << st), 64 << st)
             for st in range(4)]


@pytest.fixture
def kxk_inputs(cuda_device):
    def make(xshape, cout, kernel, seed):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        x = torch.randn(*xshape, generator=g, device=cuda_device)
        x[:, [0, -1]] *= BORDER
        x[:, :, [0, -1]] *= BORDER
        w = torch.randn(cout, *kernel, xshape[3], generator=g,
                        device=cuda_device) \
            / (kernel[0] * kernel[1] * xshape[3]) ** 0.5
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    return make


def _check_convkxk(x, w, pad, out):
    # chip_smoke.py's check_convkxk bounds: z within 1e-5 of the conv of
    # |x| and |w| plus one bf16 ulp (2^-7 relative) of the fp32 z; mean and
    # var within the error of fp32 sums in another order
    z, mean, var = out
    rz, rmean, rvar = ck.convkxk_bn_stats_reference(x, w, pad)
    assert z.shape == rz.shape and z.dtype == torch.bfloat16
    z32 = ck.convkxk_bn_stats_reference(x.float(), w.float(), pad)[0]
    z32 = z32.reshape(-1, w.shape[0])
    m = z32.shape[0]
    dmean = 1e-5 * z32.abs().sum(0) / m
    dvar = 1e-5 * (z32 * z32).sum(0) / m + 2 * rmean.abs() * dmean \
        + dmean * dmean
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    assert ((mean - rmean).abs() <= dmean).all()
    assert ((var - rvar).abs() <= dvar).all()
    mag = ck.convkxk_bn_stats_reference(x.float().abs(), w.float().abs(),
                                        pad)[0]
    assert ((z.float() - rz.float()).abs()
            <= 1e-5 * mag + 2.0 ** -7 * rz.float().abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,cout,kernel,pad", KXK_CARD_CASES)
def test_convkxk_kernel_matches_plain_beyond_the_sites(kxk_inputs, xshape,
                                                       cout, kernel, pad):
    torch.backends.cudnn.allow_tf32 = False
    x, w = kxk_inputs(xshape, cout, kernel, sum(xshape) + cout)
    n0 = ck.launch_counts()["convkxk_bn_stats"]
    first = ck.convkxk_bn_stats(x, w, pad)
    second = ck.convkxk_bn_stats(x, w, pad)
    torch.cuda.synchronize()
    assert ck.launch_counts()["convkxk_bn_stats"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _check_convkxk(x, w, pad, first)


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,cout", KXK_SITES)
def test_convkxk_kernel_walks_several_tiles_bitwise_repeatably(
        kxk_inputs, xshape, cout):
    # each CTA sums its n-tile's m-tiles (several of them at stages 1 to 3,
    # one at stage 4's 256-column tiles: the rows and tile width the C
    # library chooses on this card), and z and the statistics repeat bit
    # for bit
    from mxnet_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.load("convkxk_bn_stats")
    m = xshape[0] * xshape[1] * xshape[2]
    rows = lib.mxt_convkxk_stats_rows(m, cout)
    assert lib.mxt_convkxk_tile_n(m, cout) in (64, 128, 256)
    assert 1 <= rows <= -(-m // 128)
    if cout < 512:
        assert rows < -(-m // 128)
    x, w = kxk_inputs(xshape, cout, (3, 3), 7)
    first = ck.convkxk_bn_stats(x, w, (1, 1))
    second = ck.convkxk_bn_stats(x, w, (1, 1))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _check_convkxk(x, w, (1, 1), first)


@pytest.mark.cuda
def test_convkxk_kernel_replayed_in_two_graphs_at_once(kxk_inputs):
    # each launch zeroes the counters of its own scratch, so two CUDA
    # graphs replayed at the same time on two streams each keep their own
    # statistics, bit for bit
    x1, w1 = kxk_inputs((32, 56, 56, 64), 64, (3, 3), 31)
    x2, w2 = kxk_inputs((64, 14, 14, 256), 256, (3, 3), 32)
    want1 = ck.convkxk_bn_stats(x1, w1, (1, 1))
    want2 = ck.convkxk_bn_stats(x2, w2, (1, 1))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the default stream
        ck.convkxk_bn_stats(x1, w1, (1, 1))
        ck.convkxk_bn_stats(x2, w2, (1, 1))
    torch.cuda.current_stream().wait_stream(side)
    g1, g2 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g1):
        out1 = [ck.convkxk_bn_stats(x1, w1, (1, 1)) for _ in range(4)]
    with torch.cuda.graph(g2):
        out2 = [ck.convkxk_bn_stats(x2, w2, (1, 1)) for _ in range(4)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for _ in range(10):
        s1.wait_stream(torch.cuda.current_stream())
        s2.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s1):
            g1.replay()
        with torch.cuda.stream(s2):
            g2.replay()
        torch.cuda.synchronize()
        for outs, want in ((out1, want1), (out2, want2)):
            for got in outs:
                assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_convkxk_wider_than_the_im2col_map_runs_the_fp32_kernel(
        kxk_inputs):
    # a kernel 131 taps wide with pad 1 puts the im2col map's bounding box
    # corner at -129, outside what the encoder takes: the bf16 call runs
    # the fp32 kernel on the same values (one launch) and rounds z once
    from mxnet_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.load("convkxk_bn_stats")
    assert not lib.mxt_convkxk_tma_fits(1, 131, 0, 1)
    assert lib.mxt_convkxk_tma_fits(3, 3, 1, 1)
    x, w = kxk_inputs((2, 3, 140, 8), 16, (1, 131), 41)
    n0 = ck.launch_counts()["convkxk_bn_stats"]
    out = ck.convkxk_bn_stats(x, w, (0, 1))
    torch.cuda.synchronize()
    assert ck.launch_counts()["convkxk_bn_stats"] == n0 + 1
    _check_convkxk(x, w, (0, 1), out)
