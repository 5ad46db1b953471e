"""The port's flash-attention forward (mxnet_tpu_torch.ops.cuda_kernels)
held against the JAX package's Pallas kernel (mxnet_tpu.ops.pallas_kernels),
run in interpret mode on the CPU as tests/test_pallas.py runs it.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version by the ``cuda``-marked
tests (and by chip_smoke.py), which skip without a card.
"""
import math

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import cuda_kernels as ck

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


def test_requires_grad_inputs_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 16, 8))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ck.flash_attention(q, k, v)
    with torch.no_grad():
        assert ck.flash_attention(q, k, v).shape == (2, 16, 8)


def test_bad_inputs_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 2, 16, 8))
    with pytest.raises(ValueError, match="shape"):
        ck._fwd(q, k[:, :8], v, False, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        ck._fwd(q, k.double(), v, False, 1.0)
    with pytest.raises(ValueError, match="shape"):
        ck._fwd(q[0], k[0], v[0], False, 1.0)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    before, libs = ck.launch_counts(), dict(_build._LIBS)
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 2, 40, 24))
    out, lse = ck._fwd(q, k, v, True, 0.2)
    ref_out, ref_lse = ck.flash_attention_fwd_reference(q, k, v, True, 0.2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
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
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn(2, 16, 12, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ck._fwd(q, q, q, False, 1.0)
    q = torch.randn(2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck._fwd(q.transpose(0, 1).contiguous().transpose(0, 1), q, q,
                False, 1.0)
