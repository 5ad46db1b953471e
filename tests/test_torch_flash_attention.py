"""The port's flash attention (mxnet_tpu_torch.ops.cuda_kernels), forward
and backward, held against the JAX package's Pallas kernels
(mxnet_tpu.ops.pallas_kernels), run in interpret mode on the CPU as
tests/test_pallas.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions by the
``cuda``-marked tests (and by chip_smoke.py), which skip without a card.
"""
import math

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import cuda_kernels as ck

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
pk = LazyModule("mxnet_tpu.ops.pallas_kernels")

# fp32: the two versions sum in different orders (online vs dense softmax)
RTOL, ATOL = 2e-4, 2e-5


def _inputs(seed, *shape, dtype=onp.float32):
    rng = onp.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,seq,d,block", [
    (3, 64, 16, 64),     # one block: _pick_block(64) == 64
    (2, 64, 16, 32),     # two k-blocks: the online rescale is exercised
    (2, 96, 8, 32),      # three k-blocks, head_dim 8
])
def test_fwd_out_and_lse_match_pallas(causal, bh, seq, d, block):
    q, k, v = _inputs(bh + seq + d, bh, seq, d)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = pk._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal, scale, block, block)
    t_out, t_lse = ck._fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal, scale)
    assert t_out.dtype == torch.float32 and t_lse.dtype == torch.float32
    assert tuple(t_lse.shape) == tuple(j_lse.shape) == (bh, seq, 1)
    onp.testing.assert_allclose(t_out.numpy(), onp.asarray(j_out),
                                rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(t_lse.numpy(), onp.asarray(j_lse),
                                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_4d_multiblock_matches_pallas(causal):
    # (B, H, S, D) with S = 256: _pick_block gives 128, so two k-blocks
    q, k, v = _inputs(7, 1, 2, 256, 16)
    j = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    t = ck.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    assert t.shape == (1, 2, 256, 16)
    onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=RTOL,
                                atol=ATOL)


def test_flash_attention_explicit_scale_matches_pallas():
    q, k, v = _inputs(8, 2, 32, 16)
    j = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, sm_scale=0.3)
    t = ck.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, sm_scale=0.3)
    onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=RTOL,
                                atol=ATOL)


def test_flash_attention_bf16_matches_pallas():
    # both sides take bf16 inputs, compute in fp32 and round out to bf16:
    # a disagreement of a couple of bf16 ulps (2^-8 relative) is allowed
    q, k, v = _inputs(3, 2, 64, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    j = pk.flash_attention(jq, jk, jv, causal=False)
    t = ck.flash_attention(tq, tk, tv, causal=False)
    assert t.dtype == torch.bfloat16
    onp.testing.assert_allclose(t.float().numpy(),
                                onp.asarray(j, onp.float32),
                                rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,seq,d,block", [
    (2, 64, 16, 64),     # one block: _pick_block(64) == 64
    (2, 256, 16, 128),   # _pick_block(256) == 128: the cross-block loops
])
def test_bwd_matches_pallas(causal, bh, seq, d, block):
    rng = onp.random.RandomState(bh + seq + int(causal))
    q, k, v, do = (rng.randn(bh, seq, d).astype(onp.float32)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    j_out, j_lse = pk._fwd(jq, jk, jv, causal, scale, block, block)
    j_grads = pk._bwd(jq, jk, jv, j_out, j_lse, jdo, causal, scale, block,
                      block)
    t_grads = ck._bwd(*(torch.from_numpy(onp.array(a)) for a in (
        q, k, v, j_out, j_lse, do)), causal, scale)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert t.dtype == torch.float32 and t.shape == (bh, seq, d)
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=RTOL,
                                    atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grad_matches_jax_grad(causal):
    # as tests/test_pallas.py: a loss through the 4-D flash attention,
    # differentiated by autograd (port) and jax.grad (Pallas custom VJP)
    rng = onp.random.RandomState(11)
    q, k, v, tgt = (rng.randn(1, 2, 64, 16).astype(onp.float32)
                    for _ in range(4))

    def j_loss(q, k, v):
        return ((pk.flash_attention(q, k, v, causal=causal) - tgt) ** 2
                ).mean()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    t_loss = ((ck.flash_attention(*leaves, causal=causal)
               - torch.from_numpy(tgt)) ** 2).mean()
    t_grads = torch.autograd.grad(t_loss, leaves)
    for name, t, j in zip("qkv", t_grads, j_grads):
        onp.testing.assert_allclose(t.numpy(), onp.asarray(j), rtol=RTOL,
                                    atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_autograd_through_plain_forward(causal):
    # float64: the two differ only in the order of the same arithmetic
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(12, 2, 37, 8))
    do = torch.from_numpy(_inputs(13, 2, 37, 8)[0]).double()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = ck.flash_attention_fwd_reference(*leaves, causal, 0.3)
    want = torch.autograd.grad(out, leaves, do)
    got = ck.flash_attention_bwd_reference(q, k, v, out.detach(),
                                           lse.detach(), do, causal, 0.3)
    for g, w in zip(got, want):
        # the plain version takes p and ds in fp32, as the TPU kernels do
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_grad_call_saves_for_backward_and_no_grad_call_does_not():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 16, 8))
    q.requires_grad_(True)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        with torch.no_grad():
            assert ck.flash_attention(q, k, v).grad_fn is None
        assert packed == []
        out = ck.flash_attention(q, k, v)
    # the forward saves q, k, v, out and lse, as the reference's custom VJP
    assert out.grad_fn is not None and len(packed) == 5
    assert [tuple(t.shape) for t in packed] == [(2, 16, 8)] * 4 + [(2, 16, 1)]
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad is None


def test_bad_inputs_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 2, 16, 8))
    with pytest.raises(ValueError, match="shape"):
        ck._fwd(q, k[:, :8], v, False, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        ck._fwd(q, k.double(), v, False, 1.0)
    with pytest.raises(ValueError, match="shape"):
        ck._fwd(q[0], k[0], v[0], False, 1.0)
    out, lse = ck._fwd(q, k, v, False, 1.0)
    with pytest.raises(ValueError, match="lse"):
        ck._bwd(q, k, v, out, lse[:, :8], out, False, 1.0)
    with pytest.raises(ValueError, match="shape"):
        ck._bwd(q, k, v, out[:, :8], lse, out, False, 1.0)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    before, libs = ck.launch_counts(), dict(_build._LIBS)
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 2, 40, 24))
    out, lse = ck._fwd(q, k, v, True, 0.2)
    ref_out, ref_lse = ck.flash_attention_fwd_reference(q, k, v, True, 0.2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    grads = ck._bwd(q, k, v, out, lse, q, True, 0.2)
    refs = ck.flash_attention_bwd_reference(q, k, v, out, lse, q, True, 0.2)
    assert all(torch.equal(g, r) for g, r in zip(grads, refs))
    assert ck.launch_counts() == before
    assert _build._LIBS == libs


@pytest.mark.parametrize("d,ok", [(64, True), (128, True), (8, True),
                                  (16, True), (12, False), (136, False),
                                  (0, False), (4, False)])
def test_flash_head_dim_rule(d, ok):
    assert ck.flash_head_dim_ok(d) is ok


def test_reference_lse_is_logsumexp_of_scaled_scores():
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(9, 1, 12, 8))
    out, lse = ck.flash_attention_fwd_reference(q, k, v, True, 0.5)
    s = (q[0] * 0.5) @ k[0].T
    s = s.masked_fill(torch.ones(12, 12, dtype=torch.bool).triu(1),
                      float("-inf"))
    assert torch.allclose(lse[0, :, 0], torch.logsumexp(s, -1).float())
    assert torch.allclose(out[0], torch.softmax(s, -1) @ v[0])


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,dtype,causal,atol", [
    (48, 128, 64, torch.bfloat16, False, 2e-2),
    (8, 512, 64, torch.bfloat16, True, 2e-2),
    (4, 200, 128, torch.float16, True, 4e-3),
    (3, 200, 64, torch.float32, False, 2e-5),
    (3, 65, 16, torch.float32, True, 2e-5),
])
def test_kernel_matches_plain_on_card(cuda_device, bh, s, d, dtype, causal,
                                      atol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device)
               .to(dtype) for _ in range(3))
    n0 = ck.launch_counts()["flash_attention_fwd"]
    out, lse = ck._fwd(q, k, v, causal, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert ck.launch_counts()["flash_attention_fwd"] == n0 + 1
    ref_out, ref_lse = ck.flash_attention_fwd_reference(
        q, k, v, causal, 1.0 / math.sqrt(d))
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,dtype,causal,tol", [
    (384, 128, 64, torch.bfloat16, False, 1e-2),
    (8, 512, 64, torch.bfloat16, True, 1e-2),
    (4, 200, 128, torch.float16, True, 2e-3),
    (3, 200, 64, torch.float32, False, 1e-5),
    (3, 65, 16, torch.float32, True, 1e-5),
])
def test_bwd_kernels_match_plain_on_card(cuda_device, bh, s, d, dtype,
                                         causal, tol):
    # max |kernel - plain| <= tol * max |plain|, as chip_smoke.py holds it
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=cuda_device)
                   .to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = ck._fwd(q, k, v, causal, scale)
    n0 = ck.launch_counts()
    grads = ck._bwd(q, k, v, out, lse, do.transpose(0, 1).contiguous()
                    .transpose(0, 1), causal, scale)
    torch.cuda.synchronize()
    n1 = ck.launch_counts()
    assert n1["flash_attention_bwd_dq"] == n0["flash_attention_bwd_dq"] + 1
    assert n1["flash_attention_bwd_dkv"] == n0["flash_attention_bwd_dkv"] + 1
    refs = ck.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                            scale)
    for got, want in zip(grads, refs):
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn(2, 16, 12, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ck._fwd(q, q, q, False, 1.0)
    q = torch.randn(2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck._fwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                False, 1.0)
