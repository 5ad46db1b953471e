"""The port's flagship LM (mxnet_tpu_torch.models.transformer_lm) held
against the JAX package's (mxnet_tpu.models.transformer_lm) on the CPU: the
JAX weights are carried across with ``convert.params_from_numpy`` and the
same tokens go through both.
"""
import dataclasses
import math

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from mxnet_tpu_torch.ops import cuda_kernels as ck

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jm = LazyModule("mxnet_tpu.models")

# fp32 logits and loss: same math, summed in other orders
RTOL, ATOL = 2e-4, 2e-4
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=128, num_layers=2, num_heads=2, hidden=32,
                mlp_hidden=64, max_len=64)
    base.update(kw)
    flash = base.pop("use_flash_attention", False)
    return (jm.TransformerLMConfig(dtype=getattr(jnp, dtype),
                                   use_flash_attention=flash, **base),
            tm.TransformerLMConfig(dtype=_TORCH_DTYPE[dtype],
                                   use_flash_attention=flash, **base))


def _both_params(jcfg, tcfg, seed=0):
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy({k: onp.asarray(v) for k, v in jp.items()}, tcfg,
                           device="cpu")
    return jp, tp


def _tokens(shape, vocab=128, seed=0):
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, vocab, shape).astype(onp.int32)
    labels = onp.where(rng.rand(*shape) < 0.3, toks, -1).astype(onp.int32)
    return toks, labels


@pytest.mark.parametrize("layers,seq", [(1, 16), (2, 16), (2, 64)])
def test_forward_and_loss_match_jax_fp32_einsum(layers, seq):
    jcfg, tcfg = _cfgs(num_layers=layers)
    jp, tp = _both_params(jcfg, tcfg)
    toks, labels = _tokens((2, seq))
    j_logits, j_aux = jm.forward(jp, jnp.asarray(toks), jcfg)
    t_logits, t_aux = tm.forward(tp, toks, tcfg, device="cpu")
    assert t_logits.dtype == torch.float32 and t_logits.shape == (2, seq, 128)
    onp.testing.assert_allclose(t_logits.numpy(), onp.asarray(j_logits),
                                rtol=RTOL, atol=ATOL)
    assert float(t_aux) == float(j_aux) == 0.0
    j_loss = jm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    t_loss = tm.loss_fn(tp, toks, labels, tcfg, device="cpu")
    onp.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL,
                                atol=ATOL)


def test_forward_matches_jax_fp32_flash():
    # the toy size of tests/test_pallas.py: JAX runs the Pallas kernel in
    # interpret mode, the port runs the kernel's plain version
    jcfg, tcfg = _cfgs(num_layers=1, max_len=32, use_flash_attention=True)
    jp, tp = _both_params(jcfg, tcfg)
    toks, labels = _tokens((2, 16))
    j_logits, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
    t_logits, _ = tm.forward(tp, toks, tcfg, device="cpu")
    onp.testing.assert_allclose(t_logits.numpy(), onp.asarray(j_logits),
                                rtol=RTOL, atol=ATOL)
    j_loss = jm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    t_loss = tm.loss_fn(tp, toks, labels, tcfg, device="cpu")
    onp.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL,
                                atol=ATOL)


def test_forward_matches_jax_bf16():
    # bf16 weights and residual stream on both sides; the frameworks round
    # to bf16 at different places (bias adds, gelu, the einsum scores), so
    # the logits (|logit| <= ~1 at init) may differ by a few bf16 ulps
    # (2^-8 relative; 2e-3 seen at this size)
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _both_params(jcfg, tcfg)
    assert tp["embed.weight"].dtype == torch.bfloat16
    assert tp["layer0.ln1.gamma"].dtype == torch.float32
    toks, labels = _tokens((2, 32))
    j_logits, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
    t_logits, _ = tm.forward(tp, toks, tcfg, device="cpu")
    assert t_logits.dtype == torch.float32
    diff = onp.abs(t_logits.numpy() - onp.asarray(j_logits))
    assert diff.max() < 1e-2, diff.max()
    assert diff.mean() < 1e-3, diff.mean()
    j_loss = jm.loss_fn(jp, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    t_loss = tm.loss_fn(tp, toks, labels, tcfg, device="cpu")
    assert abs(float(t_loss) - float(j_loss)) < 1e-2


@pytest.mark.parametrize("flash", [False, True])
def test_loss_is_plain_masked_cross_entropy(flash):
    # the plain masked NLL that chip_smoke.py holds loss_fn against
    _, tcfg = _cfgs(use_flash_attention=flash)
    jcfg, _ = _cfgs()
    _, tp = _both_params(jcfg, tcfg)
    toks, labels = _tokens((2, 32))
    logits, _ = tm.forward(tp, toks, tcfg, device="cpu")
    want = torch.nn.functional.cross_entropy(
        logits.view(-1, 128), torch.as_tensor(labels).long().view(-1),
        ignore_index=-1)
    got = tm.loss_fn(tp, toks, labels, tcfg, device="cpu")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_auto_mode_on_cpu_runs_the_plain_flash_version():
    _, tcfg = _cfgs()                                   # einsum
    auto = dataclasses.replace(tcfg, use_flash_attention=None)
    jcfg, _ = _cfgs()
    _, tp = _both_params(jcfg, tcfg)
    toks, _ = _tokens((2, 24))
    launches, fallbacks = ck.launch_counts(), tm.flash_fallback_count()
    ref, _ = tm.forward(tp, toks, tcfg, device="cpu")
    got, _ = tm.forward(tp, toks, auto, device="cpu")
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert ck.launch_counts() == launches
    assert tm.flash_fallback_count() == fallbacks


def test_unsupported_head_dim_falls_back_counted():
    # head_dim 12 is not a multiple of 8: auto mode counts one fallback per
    # attention site and runs the einsum path; forcing flash raises
    jcfg, tcfg = _cfgs(num_heads=3, hidden=36)
    _, tp = _both_params(jcfg, tcfg)
    toks, _ = _tokens((2, 10))
    ref, _ = tm.forward(tp, toks, tcfg, device="cpu")
    before = tm.flash_fallback_count()
    auto = dataclasses.replace(tcfg, use_flash_attention=None)
    got, _ = tm.forward(tp, toks, auto, device="cpu")
    assert tm.flash_fallback_count() == before + tcfg.num_layers
    assert torch.equal(got, ref)
    forced = dataclasses.replace(tcfg, use_flash_attention=True)
    with pytest.raises(ValueError, match="head_dim"):
        tm.forward(tp, toks, forced, device="cpu")


def test_ragged_seq_takes_flash():
    # the CUDA kernel masks ragged tiles, so seq needs no alignment rule
    jcfg, tcfg = _cfgs(use_flash_attention=True)
    jp, tp = _both_params(jcfg, tcfg)
    toks, _ = _tokens((1, 13))
    before = tm.flash_fallback_count()
    t_logits, _ = tm.forward(tp, toks, tcfg, device="cpu")
    assert tm.flash_fallback_count() == before
    j_logits, _ = jm.forward(jp, jnp.asarray(toks),
                             dataclasses.replace(jcfg,
                                                 use_flash_attention=False))
    onp.testing.assert_allclose(t_logits.numpy(), onp.asarray(j_logits),
                                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_names_shapes_dtypes_match_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert list(tp) == list(tm.param_shapes(tcfg))
    assert set(tp) == set(jp)
    for name, a in jp.items():
        t = tp[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).split(".")[1] == str(a.dtype), name
        assert t.device.type == "cpu"


def test_init_params_scales_and_seed():
    cfg = tm.TransformerLMConfig(vocab_size=512, num_layers=2, num_heads=4,
                                 hidden=128, mlp_hidden=512, max_len=64,
                                 dtype=torch.float32)
    p = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    again = tm.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    trunc_std = 0.8796                 # std of N(0, 1) truncated to [-2, 2]
    resid = 0.02 / math.sqrt(2 * cfg.num_layers)
    for name, want in (("embed.weight", 0.02),
                       ("layer0.attn.qkv.weight", 0.02),
                       ("layer1.ffn_1.weight", 0.02),
                       ("layer0.attn.out_proj.weight", resid),
                       ("layer1.ffn_2.weight", resid)):
        w = p[name]
        assert abs(w.std().item() / (want * trunc_std) - 1) < 0.05, name
        assert w.abs().max().item() <= 2 * want + 1e-7, name
    assert torch.equal(p["layer0.ln1.gamma"], torch.ones(128))
    assert torch.equal(p["layer1.ffn_2.bias"], torch.zeros(128))
    assert torch.equal(p["final_ln.beta"], torch.zeros(128))


@pytest.mark.parametrize("change", [
    dict(num_experts=4), dict(use_ring_attention=True)])
def test_unported_configs_raise(change):
    jcfg, tcfg = _cfgs()
    _, tp = _both_params(jcfg, tcfg)
    bad = dataclasses.replace(tcfg, **change)
    toks, labels = _tokens((1, 8))
    with pytest.raises(NotImplementedError):
        tm.forward(tp, toks, bad, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.loss_fn(tp, toks, labels, bad, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.init_params(bad, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_jax_fp32(remat):
    # remat recomputes each layer in the backward (jax.checkpoint in the
    # reference, torch.utils.checkpoint in the port); the gradients of the
    # loss stay those of the plain graph
    jcfg, tcfg = _cfgs(remat=remat)
    jp, tp = _both_params(jcfg, tcfg)
    toks, labels = _tokens((2, 16))
    j_grads = jax.grad(jm.loss_fn)(jp, jnp.asarray(toks), jnp.asarray(labels),
                                   jcfg)
    leaves = {k: w.requires_grad_() for k, w in tp.items()}
    t_loss = tm.loss_fn(leaves, toks, labels, tcfg, device="cpu")
    t_grads = torch.autograd.grad(t_loss, list(leaves.values()))
    for name, g in zip(leaves, t_grads):
        j = onp.asarray(j_grads[name])
        onp.testing.assert_allclose(g.numpy(), j, rtol=RTOL,
                                    atol=1e-5 * float(abs(j).max()),
                                    err_msg=name)


def test_mesh_argument_raises():
    jcfg, tcfg = _cfgs()
    _, tp = _both_params(jcfg, tcfg)
    toks, _ = _tokens((1, 8))
    with pytest.raises(NotImplementedError, match="mesh"):
        tm.forward(tp, toks, tcfg, mesh=object(), device="cpu")


def test_params_from_numpy_checks_names_and_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = {k: onp.asarray(v)
          for k, v in jm.init_params(jax.random.PRNGKey(1), jcfg).items()}
    tp = params_from_numpy(jp, tcfg, device="cpu")
    for name, a in jp.items():       # bf16 carried bit for bit
        assert onp.array_equal(tp[name].float().numpy(),
                               a.astype(onp.float32)), name
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in jp.items()
                           if k != "embed.weight"}, tcfg, device="cpu")
    bad = dict(jp)
    bad["layer0.ffn_1.bias"] = onp.zeros((3,), onp.float32)
    with pytest.raises(ValueError, match="ffn_1.bias"):
        params_from_numpy(bad, tcfg, device="cpu")


def test_tensor_from_numpy_keeps_dtype():
    for a in (onp.arange(4, dtype=onp.int32), onp.ones(3, onp.float16),
              onp.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))):
        t = tensor_from_numpy(a)
        assert t.dtype == {"int32": torch.int32, "float16": torch.float16,
                           "bfloat16": torch.bfloat16}[a.dtype.name]
        assert onp.array_equal(t.float().numpy(), a.astype(onp.float32))


def test_forward_with_params_elsewhere_raises():
    jcfg, tcfg = _cfgs()
    _, tp = _both_params(jcfg, tcfg)
    toks, _ = _tokens((1, 8))
    with pytest.raises(ValueError, match="params are on"):
        tm.forward(tp, toks, tcfg, device="meta")
