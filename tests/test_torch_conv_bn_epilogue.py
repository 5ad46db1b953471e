"""The port's fused 1x1-conv / batch-norm epilogue (mxnet_tpu_torch.ops:
``matmul_stats``, ``matmul_epilogue``, ``conv1x1_bn_act_train`` and the op
``nn.fused_conv1x1_bn_act``), held against the JAX package's Pallas kernels
and op (mxnet_tpu.ops.pallas_kernels, ``_fused_conv1x1_bn_act``) run in
interpret mode on the CPU, as tests/test_fused_epilogue.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions by the
``cuda``-marked tests (and by chip_smoke.py), which skip without a card.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import nn as tnn

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
mx = LazyModule("mxnet_tpu")
invoke = LazyModule("mxnet_tpu.ndarray.ndarray", "invoke")
pk = LazyModule("mxnet_tpu.ops.pallas_kernels")

# fp32: both sides sum the same fp32 products in other orders
OUT_TOL = dict(rtol=2e-4, atol=2e-4)      # outputs and batch statistics
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)     # gradients (as the reference's
                                          # own fused-vs-unfused tests)
# bf16 inputs: products exact in fp32 on both sides; the output is rounded
# once to bf16 (2^-9 relative), so a value near a rounding boundary may land
# one ulp (2^-8 relative) apart
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _rand(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale) \
        .astype(onp.float32)


def _t(a):
    return torch.from_numpy(onp.array(a))


@pytest.mark.parametrize("m,k,n,blocks", [
    (64, 32, 256, (32, 128, 32)),     # two m-steps: the TPU kernel's
    (96, 64, 128, (32, 128, 32)),     # sequential accumulation runs
    (16, 8, 8, (16, 8, 8)),
])
def test_matmul_stats_matches_pallas(m, k, n, blocks):
    x, w = _rand(m + k, m, k), _rand(n, k, n)
    bm, bn, bk = blocks
    js, jss = pk.matmul_stats(jnp.asarray(x), jnp.asarray(w), block_m=bm,
                              block_n=bn, block_k=bk)
    ts, tss = ck.matmul_stats(_t(x), _t(w))
    assert ts.dtype == tss.dtype == torch.float32 and ts.shape == (n,)
    onp.testing.assert_allclose(ts.numpy(), onp.asarray(js), **OUT_TOL)
    onp.testing.assert_allclose(tss.numpy(), onp.asarray(jss), **OUT_TOL)


@pytest.mark.parametrize("relu,res", [(False, False), (True, False),
                                      (True, True), (False, True)])
def test_matmul_epilogue_matches_pallas(relu, res):
    x, w = _rand(1, 64, 32), _rand(2, 32, 256)
    sc = onp.abs(_rand(3, 256)) + 0.5
    bi = _rand(4, 256)
    r = _rand(5, 64, 256) if res else None
    j = pk.matmul_epilogue(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                           jnp.asarray(bi),
                           residual=None if r is None else jnp.asarray(r),
                           relu=relu, block_m=32, block_n=128, block_k=32)
    t = ck.matmul_epilogue(_t(x), _t(w), _t(sc), _t(bi),
                           None if r is None else _t(r), relu)
    assert t.dtype == torch.float32 and t.shape == (64, 256)
    onp.testing.assert_allclose(t.numpy(), onp.asarray(j), **OUT_TOL)


def test_bf16_kernels_match_pallas():
    x = jnp.asarray(_rand(6, 32, 64)).astype(jnp.bfloat16)
    w = jnp.asarray(_rand(7, 64, 128, scale=0.125)).astype(jnp.bfloat16)
    r = jnp.asarray(_rand(8, 32, 128)).astype(jnp.bfloat16)
    sc, bi = jnp.asarray(onp.abs(_rand(9, 128)) + 0.5), jnp.asarray(
        _rand(10, 128))
    js, jss = pk.matmul_stats(x, w, block_m=32, block_n=128, block_k=64)
    jo = pk.matmul_epilogue(x, w, sc, bi, residual=r, relu=True,
                            block_m=32, block_n=128, block_k=64)

    def tb(a):
        return _t(onp.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    ts, tss = ck.matmul_stats(tb(x), tb(w))
    to = ck.matmul_epilogue(tb(x), tb(w), _t(onp.asarray(sc)),
                            _t(onp.asarray(bi)), tb(r), relu=True)
    assert to.dtype == torch.bfloat16
    # the statistics are fp32 sums of exact products: fp32 tolerance
    onp.testing.assert_allclose(ts.numpy(), onp.asarray(js), **OUT_TOL)
    onp.testing.assert_allclose(tss.numpy(), onp.asarray(jss), **OUT_TOL)
    onp.testing.assert_allclose(to.float().numpy(),
                                onp.asarray(jo.astype(jnp.float32)),
                                **BF16_TOL)


def _c1x1_inputs(seed, n=2, h=4, w=4, cin=8, cout=16):
    return (_rand(seed, n, h, w, cin), _rand(seed + 1, cout, 1, 1, cin),
            onp.abs(_rand(seed + 2, cout)) + 0.5, _rand(seed + 3, cout),
            _rand(seed + 4, n, h, w, cout))


@pytest.mark.parametrize("relu,res,fix_gamma", [
    (True, True, False), (True, False, False), (False, False, False),
    (False, True, True)])
def test_conv1x1_bn_act_train_forward_and_grads_match_pallas(relu, res,
                                                             fix_gamma):
    """Outputs and the vjp of every input, with cotangents on out, mean and
    var, against jax.vjp of pallas_kernels.conv1x1_bn_act_train."""
    x, w, gamma, beta, r = _c1x1_inputs(20)
    gout = _rand(30, *x.shape[:3], w.shape[0])
    gmean, gvar = _rand(31, w.shape[0]), _rand(32, w.shape[0])
    args = [x, w, gamma, beta] + ([r] if res else [])

    def jfn(*a):
        return pk.conv1x1_bn_act_train(
            a[0], a[1], a[2], a[3], residual=a[4] if res else None,
            relu=relu, fix_gamma=fix_gamma)

    jouts, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp((jnp.asarray(gout), jnp.asarray(gmean), jnp.asarray(gvar)))

    leaves = [_t(a).requires_grad_() for a in args]
    touts = ck.conv1x1_bn_act_train(
        leaves[0], leaves[1], leaves[2], leaves[3],
        residual=leaves[4] if res else None, relu=relu, fix_gamma=fix_gamma)
    tgrads = torch.autograd.grad(touts, leaves,
                                 (_t(gout), _t(gmean), _t(gvar)))
    for name, t, j in zip(("out", "mean", "var"), touts, jouts):
        onp.testing.assert_allclose(t.detach().numpy(), onp.asarray(j),
                                    err_msg=name, **OUT_TOL)
    for name, t, j in zip(("x", "w", "gamma", "beta", "residual"), tgrads,
                          jgrads):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j),
                                    err_msg=name, **GRAD_TOL)
    if fix_gamma:
        assert not tgrads[2].any()


def test_conv1x1_bn_act_train_bf16_matches_pallas():
    x, w, gamma, beta, r = _c1x1_inputs(40, cin=16, cout=32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, r)]
    jouts, vjp = jax.vjp(
        lambda a, b, c: pk.conv1x1_bn_act_train(
            a, b, jnp.asarray(gamma), jnp.asarray(beta), residual=c),
        *jb)
    gout = jnp.asarray(_rand(41, *x.shape[:3], 32)).astype(jnp.bfloat16)
    jgrads = vjp((gout, jnp.zeros(32), jnp.zeros(32)))

    def tb(a):
        return _t(onp.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    leaves = [tb(a).requires_grad_() for a in jb]
    touts = ck.conv1x1_bn_act_train(leaves[0], leaves[1], _t(gamma),
                                    _t(beta), residual=leaves[2])
    assert touts[0].dtype == torch.bfloat16
    assert touts[1].dtype == touts[2].dtype == torch.float32
    tgrads = torch.autograd.grad(touts[0], leaves, tb(gout))
    onp.testing.assert_allclose(touts[0].float().detach().numpy(),
                                onp.asarray(jouts[0].astype(jnp.float32)),
                                **BF16_TOL)
    for t, j in zip(touts[1:], jouts[1:]):
        onp.testing.assert_allclose(t.detach().numpy(), onp.asarray(j),
                                    **OUT_TOL)
    # bf16 gradients: dz and the products' outputs are rounded to bf16, so
    # compare relative to each gradient's largest entry
    for name, t, j in zip(("x", "w", "residual"), tgrads, jgrads):
        j = onp.asarray(j.astype(jnp.float32))
        err = onp.abs(t.float().numpy() - j).max()
        assert err <= 2e-2 * onp.abs(j).max(), (name, err)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_fused_op_with_bias_and_stride_matches_jax_op(stride):
    x, w, gamma, beta, _ = _c1x1_inputs(50, h=8, w=8, cin=16, cout=32)
    b = _rand(55, 32)
    ho = 8 // stride[0]
    r = _rand(56, 2, ho, ho, 32)
    jo, jm, jv = invoke(
        "_fused_conv1x1_bn_act",
        [mx.nd.array(a) for a in (x, w, b, r, gamma, beta)],
        {"stride": stride, "eps": 1e-5, "fix_gamma": False,
         "has_bias": True, "has_residual": True, "relu": True})
    # a non-contiguous input: the op slices, then copies for the kernels
    to, tm, tv = tnn.fused_conv1x1_bn_act(
        _t(x), _t(w), _t(b), _t(r), _t(gamma), _t(beta), stride=stride,
        eps=1e-5, fix_gamma=False, relu=True)
    assert to.shape == (2, ho, ho, 32)
    for t, j in ((to, jo), (tm, jm), (tv, jv)):
        onp.testing.assert_allclose(t.detach().numpy(), j.asnumpy(),
                                    **OUT_TOL)
    # the bias reaches the mean only
    _, tm0, _ = tnn.fused_conv1x1_bn_act(
        _t(x), _t(w), None, _t(r), _t(gamma), _t(beta), stride=stride)
    onp.testing.assert_allclose((tm - tm0).numpy(), b, rtol=1e-5,
                                atol=1e-5)


def test_fused_op_writes_the_bias_gradient():
    """The conv bias reaches the returned mean only: its gradient is the
    mean's cotangent, written (as zeros) by a backward of the output alone,
    as the reference's vjp gives it."""
    x, w, gamma, beta, _ = _c1x1_inputs(60)
    b = _t(_rand(61, 16)).requires_grad_()
    out, mean, _ = tnn.fused_conv1x1_bn_act(
        _t(x), _t(w), b, None, _t(gamma), _t(beta))
    (db,) = torch.autograd.grad(out.sum(), [b], retain_graph=True)
    assert db is not None and not db.any()
    gm = _t(_rand(62, 16))
    (db,) = torch.autograd.grad((mean * gm).sum(), [b])
    onp.testing.assert_array_equal(db.numpy(), gm.numpy())


@pytest.mark.parametrize("m,k,n,dtype,ok", [
    (401408, 64, 256, torch.bfloat16, True),
    (6272, 512, 2048, torch.bfloat16, True),
    (1001, 8, 8, torch.float32, True),        # ragged m is masked
    (64, 12, 64, torch.float32, False),       # k not a multiple of 8
    (64, 64, 20, torch.bfloat16, False),      # n not a multiple of 8
    (64, 64, 64, torch.float16, False),       # fp16: not a kernel dtype
    (0, 64, 64, torch.float32, False)])
def test_epilogue_fits(m, k, n, dtype, ok):
    assert ck.epilogue_fits(m, k, n, dtype) is ok


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w = torch.zeros(16, 12), torch.zeros(12, 16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.matmul_stats(x, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.matmul_epilogue(torch.zeros(16, 16, dtype=torch.float16),
                           torch.zeros(16, 16, dtype=torch.float16),
                           torch.ones(16), torch.zeros(16))
    with pytest.raises(ValueError, match="residual"):
        ck.matmul_epilogue(torch.zeros(16, 8), torch.zeros(8, 8),
                           torch.ones(8), torch.zeros(8),
                           residual=torch.zeros(8, 8))


def test_cpu_wrappers_launch_nothing():
    before = ck.launch_counts()
    ck.matmul_stats(torch.ones(16, 8), torch.ones(8, 8))
    ck.matmul_epilogue(torch.ones(16, 8), torch.ones(8, 8), torch.ones(8),
                       torch.zeros(8))
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
@pytest.mark.parametrize("m,k,n", [(1000, 64, 64), (777, 256, 256),
                                   (300, 1024, 2048)])
def test_kernels_match_plain_on_card(cuda_device, dtype, m, k, n):
    # stats: fp32 sums in another order; out: one rounding to x's dtype
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(n, k, generator=g, device=cuda_device)
         / k ** 0.5).to(dtype).t()
    sc = torch.rand(n, generator=g, device=cuda_device) + 0.5
    sh = torch.randn(n, generator=g, device=cuda_device)
    r = torch.randn(m, n, generator=g, device=cuda_device).to(dtype)
    n0 = ck.launch_counts()
    s, ss = ck.matmul_stats(x, w)
    out = ck.matmul_epilogue(x, w, sc, sh, r, relu=True)
    torch.cuda.synchronize()
    n1 = ck.launch_counts()
    assert n1["matmul_stats"] == n0["matmul_stats"] + 1
    assert n1["matmul_epilogue"] == n0["matmul_epilogue"] + 1
    rs, rss = ck.matmul_stats_reference(x, w)
    ro = ck.matmul_epilogue_reference(x, w, sc, sh, r, relu=True)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(ss, rss, rtol=1e-5, atol=1e-3)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ro.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the bf16 matmul-epilogue kernel's host-side rules (on the CPU) and its
# edges (on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,cols", [(8, 64), (64, 64), (72, 128), (128, 128),
                                    (136, 256), (256, 256), (512, 256),
                                    (2048, 256)])
def test_epilogue_tile_n_rule(n, cols):
    # one tile spans the whole of N up to 256 columns, so x is read once
    assert ck.epilogue_tile_n(n) == cols


def test_kernel_operands_refuse_what_the_tma_maps_cannot_take():
    # the residual and output maps need 16-byte aligned bases and rows laid
    # out contiguously; the checks run before any launch, so they hold on
    # the CPU too
    x = torch.zeros(16, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, 16, dtype=torch.bfloat16)
    r = torch.zeros(16, 16, dtype=torch.bfloat16)
    assert ck._kernel_operands("matmul_epilogue", x, w,
                               residual=r).shape == (16, 8)
    shifted = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16)[1:].view(16, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck._kernel_operands("matmul_epilogue", x, w, residual=shifted)
    with pytest.raises(ValueError, match="contiguous"):
        ck._kernel_operands("matmul_epilogue", x, w, residual=r.t())


@pytest.fixture
def bf16_epilogue_inputs(cuda_device):
    def make(m, k, n, seed):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        x = torch.randn(m, k, generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=cuda_device)
             / k ** 0.5).to(torch.bfloat16).t()
        sc = torch.rand(n, generator=g, device=cuda_device) + 0.5
        sh = torch.randn(n, generator=g, device=cuda_device)
        r = torch.randn(m, n, generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        return x, w, sc, sh, r
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("m,k,n", [(77, 8, 8), (77, 24, 72), (1000, 8, 24),
                                   (1000, 24, 72), (129, 8, 136),
                                   (300, 512, 256), (300, 256, 520)])
def test_epilogue_kernel_matches_plain_at_the_edges(bf16_epilogue_inputs, m,
                                                    k, n, res, relu):
    # N and K inside one tile or k-box (the copies' zero fill and the
    # stores' clipping do the work), ragged M, the deep ring of 256-column
    # tiles (K >= 256) and N past 256; chip_smoke.py's EPI_TOL
    x, w, sc, sh, r = bf16_epilogue_inputs(m, k, n, m + k + n)
    r = r if res else None
    n0 = ck.launch_counts()["matmul_epilogue"]
    out = ck.matmul_epilogue(x, w, sc, sh, r, relu)
    torch.cuda.synchronize()
    assert ck.launch_counts()["matmul_epilogue"] == n0 + 1
    ref = ck.matmul_epilogue_reference(x, w, sc, sh, r, relu)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(401408, 64, 256), (6272, 512, 2048),
                                   (1000, 24, 72)])
def test_epilogue_kernel_is_bitwise_repeatable(bf16_epilogue_inputs, m, k,
                                               n):
    x, w, sc, sh, r = bf16_epilogue_inputs(m, k, n, 7)
    first = ck.matmul_epilogue(x, w, sc, sh, r, True)
    second = ck.matmul_epilogue(x, w, sc, sh, r, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------------------------------------------
# the bf16 matmul_stats at the kernel's edges: against the Pallas kernel (on
# the CPU) and against the plain version, with the kernel's static schedule
# and its own scratch per launch (on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [77, 200])
@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("n", [8, 72, 264])
def test_bf16_matmul_stats_matches_pallas_at_the_edges(m, k, n):
    # the shapes the card's kernel takes at its edges: ragged M, K inside
    # one k-box, N inside one tile or over several n-tiles
    x = jnp.asarray(_rand(m + k + n, m, k)).astype(jnp.bfloat16)
    w = jnp.asarray(_rand(n, k, n, scale=k ** -0.5)).astype(jnp.bfloat16)
    js, jss = pk.matmul_stats(x, w, block_m=m, block_n=n, block_k=k)

    def tb(a):
        return _t(onp.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    ts, tss = ck.matmul_stats(tb(x), tb(w))
    assert ts.dtype == tss.dtype == torch.float32 and ts.shape == (n,)
    onp.testing.assert_allclose(ts.numpy(), onp.asarray(js), **OUT_TOL)
    onp.testing.assert_allclose(tss.numpy(), onp.asarray(jss), **OUT_TOL)


def _stats_walk(m, n_tiles, rows):
    """The bf16 statistics kernels' static walk, a plain mirror of their
    loop: {cta: [(m-tile, n-tile), ...]} in the order each CTA takes its
    tiles, tile cta + i * grid with the n-tile fastest, for the grid of
    rows x n-tiles CTAs."""
    tiles = -(-m // 128) * n_tiles
    grid = rows * n_tiles
    return {b: [divmod(t, n_tiles) for t in range(b, tiles, grid)]
            for b in range(grid)}


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(401408, 256), (6272, 2048), (40000, 2048),
                                 (20000, 264), (3001, 520), (77, 8),
                                 (1000, 51200), (401408, 64)])
def test_stats_walk_gives_every_tile_once_and_each_cta_one_n_tile(
        cuda_device, m, n):
    # what the kernels' running sums rest on, for the tile width and the
    # scratch rows that the C side chooses on this card: a CTA's tiles
    # share one n-tile, so one scratch row per CTA holds all its columns,
    # and every (row, n-tile) of the scratch is written by exactly one CTA
    from mxnet_tpu_torch.ops import _build
    lib = _build.load("conv_bn_epilogue")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_tiles = -(-n // lib.mxt_stats_tile_n(n))
    rows = lib.mxt_stats_rows(m, n)
    assert rows == max(1, min(-(-m // 128), sms // n_tiles))
    walk = _stats_walk(m, n_tiles, rows)
    seen = sorted(t for tiles in walk.values() for t in tiles)
    assert seen == [(mt, nt) for mt in range(-(-m // 128))
                    for nt in range(n_tiles)]
    for cta, tiles in walk.items():
        assert tiles, "every CTA writes its row, so it takes a tile"
        assert {nt for _, nt in tiles} == {cta % n_tiles}
        assert [mt for mt, _ in tiles] == sorted(mt for mt, _ in tiles)


def _stats_bounds(x, w, s, ss):
    # chip_smoke.py's check_col_sums: fp32 sums of the same exact products
    # in another order, within 1e-5 of the sum of magnitudes
    z = x.float() @ w.float()
    assert torch.isfinite(s).all() and torch.isfinite(ss).all()
    assert ((s - z.sum(0)).abs() <= 1e-5 * z.abs().sum(0)).all()
    assert ((ss - (z * z).sum(0)).abs() <= 1e-5 * (z * z).sum(0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [77, 1000])
@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("n", [8, 72, 264, 2048])
def test_stats_kernel_matches_plain_at_the_edges(bf16_epilogue_inputs, m, k,
                                                 n):
    # N inside one tile, and several n-tiles with a narrow last one; K inside
    # one k-box; ragged M
    x, w = bf16_epilogue_inputs(m, k, n, m + k + n)[:2]
    n0 = ck.launch_counts()["matmul_stats"]
    s, ss = ck.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert ck.launch_counts()["matmul_stats"] == n0 + 1
    assert s.shape == ss.shape == (n,)
    _stats_bounds(x, w, s, ss)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(40000, 64, 2048), (20000, 24, 264),
                                   (10000, 136, 1032), (401408, 64, 256),
                                   (6272, 512, 2048)])
def test_stats_kernel_walks_several_tiles_bitwise_repeatably(
        bf16_epilogue_inputs, m, k, n):
    # every CTA sums several m-tiles of its n-tile; every column of the
    # scratch is written, and the sums repeat bit for bit
    x, w = bf16_epilogue_inputs(m, k, n, 11)[:2]
    first = ck.matmul_stats(x, w)
    second = ck.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _stats_bounds(x, w, *first)


@pytest.mark.cuda
def test_stats_kernels_replayed_in_two_graphs_at_once(bf16_epilogue_inputs):
    # each launch zeroes the counters of its own scratch, so two CUDA
    # graphs captured on torch's shared capture stream and replayed at the
    # same time on two streams each keep their own sums, bit for bit
    x1, w1 = bf16_epilogue_inputs(200000, 64, 256, 21)[:2]
    x2, w2 = bf16_epilogue_inputs(200000, 64, 256, 22)[:2]
    want1 = ck.matmul_stats(x1, w1)
    want2 = ck.matmul_bn_stats(x2, w2, True)[1:]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the default stream
        ck.matmul_stats(x1, w1)
        ck.matmul_bn_stats(x2, w2, True)
    torch.cuda.current_stream().wait_stream(side)
    g1, g2 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g1):
        out1 = [ck.matmul_stats(x1, w1) for _ in range(4)]
    with torch.cuda.graph(g2):
        out2 = [ck.matmul_bn_stats(x2, w2, True)[1:] for _ in range(4)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for _ in range(20):
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
