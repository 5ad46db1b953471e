"""Flagship transformer LM (BERT-class pre-LN encoder) in PyTorch.

Counterpart of ``mxnet_tpu/models/transformer_lm.py``, whose math it keeps:
the same flat ``{name: Tensor}`` parameter dict (names, shapes, dtypes), the
fp32 layer norm, the residual stream in ``cfg.dtype``, tanh-GELU, tied
output head with fp32 logits, the masked-LM loss, and the train step's
Adam(W)/LAMB arithmetic. Attention goes through the hand-written
flash-attention kernels
(:func:`mxnet_tpu_torch.ops.cuda_kernels.flash_attention`: forward, and
the dq and dk/dv backward kernels) on CUDA.

Ported so far: the single-device forward and loss, rematerialisation
(``cfg.remat``), ``init_opt_state`` and the single-device
``make_train_step`` with gradient accumulation, whose step is captured
once per input shape and replayed after that (``program_store``), the
counterpart of the reference's ``jax.jit(step, donate_argnums=...)``.
Callers capture the forward the same way (``program_store.capture``), as
the reference's callers ``jax.jit`` it. Mixture-of-experts layers,
ring attention and a device mesh raise ``NotImplementedError``; the
sharding plan and pipeline stages are not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import config as _config
from .. import program_store as _pstore
from .. import telemetry as _telemetry
from ..context import resolve_device
from ..ops import cuda_kernels as _kernels

__all__ = ["TransformerLMConfig", "param_shapes", "init_params", "forward",
           "loss_fn", "init_opt_state", "make_train_step",
           "flash_fallback_count"]

# Attention sites that wanted the flash kernel but took the O(S^2) einsum
# path because the kernel does not take their head dim: counted at every
# such call and logged once per process, so a mis-sized config does not
# quietly lose the kernel.
_FLASH_FALLBACK = _telemetry.counter(
    "transformer_lm.flash_fallback",
    "attention sites that wanted the flash-attention kernel but fell back "
    "to the O(S^2) einsum path on an unsupported head_dim")
_FLASH_FALLBACK_LOGGED = False


def flash_fallback_count() -> int:
    """Attention sites that wanted the flash kernel but fell back to the
    einsum path. View over the ``transformer_lm.flash_fallback`` counter."""
    return int(_FLASH_FALLBACK.value)


def _count_flash_fallback(seq: int, head_dim: int) -> None:
    global _FLASH_FALLBACK_LOGGED
    _FLASH_FALLBACK.inc()
    if not _FLASH_FALLBACK_LOGGED:
        _FLASH_FALLBACK_LOGGED = True
        logging.getLogger("mxnet_tpu_torch.models").warning(
            "flash attention fell back to the O(S^2) einsum path: "
            "head_dim=%d (seq=%d) is not a multiple of 8 in [8, 128], which "
            "the CUDA kernel needs. [logged once; fallbacks counted in "
            "models.transformer_lm.flash_fallback_count()]", head_dim, seq)


@dataclasses.dataclass
class TransformerLMConfig:
    vocab_size: int = 30528          # bert-base vocab rounded to 64
    num_layers: int = 12
    num_heads: int = 12
    hidden: int = 768
    mlp_hidden: int = 3072
    max_len: int = 512
    dtype: Any = torch.bfloat16
    # MoE: 0 = dense MLP everywhere (the only setting ported so far)
    num_experts: int = 0
    use_ring_attention: bool = False
    remat: bool = False
    # None = auto: flash attention (the CUDA kernel on CUDA tensors, its
    # plain version on CPU tensors), einsum where the kernel does not take
    # the head dim (counted); True forces flash (raises where it cannot);
    # False takes the einsum path
    use_flash_attention: Any = None

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


def _check_ported(cfg: TransformerLMConfig, mesh: Any = None) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "num_experts > 0 (mixture-of-experts layers) is not ported to "
            "mxnet_tpu_torch yet")
    if cfg.use_ring_attention:
        raise NotImplementedError(
            "use_ring_attention is not ported to mxnet_tpu_torch yet")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported to mxnet_tpu_torch yet; the forward "
            "and the train step run on one device")


def param_shapes(cfg: TransformerLMConfig
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of the parameter dict, in init order."""
    _check_ported(cfg)
    H, M, V = cfg.hidden, cfg.mlp_hidden, cfg.vocab_size
    f32, dt = torch.float32, cfg.dtype
    p = {"embed.weight": ((V, H), dt),
         "pos_embed.weight": ((cfg.max_len, H), dt)}
    for i in range(cfg.num_layers):
        pre = f"layer{i}."
        p[pre + "attn.qkv.weight"] = ((3 * H, H), dt)
        p[pre + "attn.qkv.bias"] = ((3 * H,), dt)
        p[pre + "attn.out_proj.weight"] = ((H, H), dt)
        p[pre + "attn.out_proj.bias"] = ((H,), dt)
        for ln in ("ln1", "ln2"):
            p[pre + ln + ".gamma"] = ((H,), f32)
            p[pre + ln + ".beta"] = ((H,), f32)
        p[pre + "ffn_1.weight"] = ((M, H), dt)
        p[pre + "ffn_1.bias"] = ((M,), dt)
        p[pre + "ffn_2.weight"] = ((H, M), dt)
        p[pre + "ffn_2.bias"] = ((H,), dt)
    p["final_ln.gamma"] = ((H,), f32)
    p["final_ln.beta"] = ((H,), f32)
    return p


def init_params(cfg: TransformerLMConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Flat param dict; truncated-normal(0.02) like BERT, with
    0.02/sqrt(2L) on the residual-branch outputs (out_proj, ffn_2), zero
    biases, unit gammas. Draws come from ``generator`` (seed 0 on the
    target device if None); they differ from the JAX package's draws, so
    parity tests carry the JAX weights over with ``convert``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    resid_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    p: Dict[str, torch.Tensor] = {}
    for name, (shape, dtype) in param_shapes(cfg).items():
        if name.endswith("weight"):
            t = torch.empty(shape, dtype=torch.float32,
                            device=generator.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            scale = resid_scale if name.endswith(
                ("out_proj.weight", "ffn_2.weight")) else 0.02
            p[name] = (t * scale).to(device=dev, dtype=dtype)
        elif name.endswith("gamma"):
            p[name] = torch.ones(shape, dtype=dtype, device=dev)
        else:
            p[name] = torch.zeros(shape, dtype=dtype, device=dev)
    return p


def _layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def _use_flash(cfg: TransformerLMConfig, seq: int, head_dim: int) -> bool:
    if cfg.use_flash_attention is False:
        return False
    ok = _kernels.flash_head_dim_ok(head_dim)
    if cfg.use_flash_attention is True and not ok:
        raise ValueError(
            f"use_flash_attention=True requires head_dim ({head_dim}) to be "
            f"a multiple of 8 in [8, 128] (CUDA kernel)")
    if not ok:
        _count_flash_fallback(seq, head_dim)
    return ok


def _attention(x, p, pre: str, cfg: TransformerLMConfig):
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = x @ p[pre + "attn.qkv.weight"].T + p[pre + "attn.qkv.bias"]
    # (B, S, 3, nh, hd) -> three contiguous (B, nh, S, hd)
    q, k, v = qkv.reshape(B, S, 3, nh, hd).permute(2, 0, 3, 1, 4) \
        .contiguous().unbind(0)
    if _use_flash(cfg, S, hd):
        out = _kernels.flash_attention(q, k, v, causal=False).to(x.dtype)
    else:
        scale = 1.0 / math.sqrt(hd)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                           v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, S, H)
    return out @ p[pre + "attn.out_proj.weight"].T + \
        p[pre + "attn.out_proj.bias"]


def _mlp(x, p, pre: str):
    h = F.gelu(x @ p[pre + "ffn_1.weight"].T + p[pre + "ffn_1.bias"],
               approximate="tanh")
    return h @ p[pre + "ffn_2.weight"].T + p[pre + "ffn_2.bias"]


def _block(params, x, i: int, cfg: TransformerLMConfig):
    """One pre-LN transformer block (attention + MLP residual)."""
    pre = f"layer{i}."
    x = x + _attention(_layer_norm(x, params[pre + "ln1.gamma"],
                                   params[pre + "ln1.beta"]),
                       params, pre, cfg)
    return x + _mlp(_layer_norm(x, params[pre + "ln2.gamma"],
                                params[pre + "ln2.beta"]), params, pre)


def _tokens_on(tokens, params, device) -> torch.Tensor:
    dev = resolve_device(device)
    emb = params["embed.weight"]
    if emb.device.type != dev.type or (
            dev.index is not None and emb.device != dev):
        raise ValueError(f"params are on {emb.device}, but the forward was "
                         f"asked to run on {dev}")
    return torch.as_tensor(tokens, device=emb.device).long()


def forward(params, tokens, cfg: TransformerLMConfig, mesh=None, *,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] float32, aux loss float32).

    Runs on ``device`` (``cuda`` if None, where ``params`` must live). The
    aux loss is 0: mixture-of-experts layers are not ported yet."""
    _check_ported(cfg, mesh)
    tokens = _tokens_on(tokens, params, device)
    S = tokens.shape[1]
    x = (params["embed.weight"][tokens] + params["pos_embed.weight"][:S]) \
        .to(cfg.dtype)
    # remat: keep only each layer's input and recompute the layer in the
    # backward, as jax.checkpoint does in the reference
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        if remat:
            # no random ops to replay, and no RNG state to stash (which a
            # captured step could not read)
            x = checkpoint(_block, params, x, i, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(params, x, i, cfg)
    x = _layer_norm(x, params["final_ln.gamma"], params["final_ln.beta"])
    logits = x @ params["embed.weight"].T.to(cfg.dtype)
    return logits.float(), torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def _masked_nll(logits, labels):
    """Per-position masked NLL: labels int, -1 = unmasked (ignored).
    Returns (nll [B,S] with zeros at masked positions, valid mask [B,S])."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def loss_fn(params, tokens, labels, cfg: TransformerLMConfig, mesh=None,
            aux_weight: float = 0.01, *, device=None) -> torch.Tensor:
    """Masked-LM style CE: labels [B,S] int, -1 = unmasked (ignored)."""
    logits, aux = forward(params, tokens, cfg, mesh, device=device)
    labels = torch.as_tensor(labels, device=logits.device).long()
    nll, valid = _masked_nll(logits, labels)
    denom = valid.sum().clamp(min=1)
    return nll.sum() / denom + aux_weight * aux


def init_opt_state(params) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Adam/LAMB first and second moments: two dicts of fp32 zeros with the
    params' names, shapes and device."""
    def zeros():
        return {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                for n, w in params.items()}
    return zeros(), zeros()


def _grads(params, tokens, labels, cfg: TransformerLMConfig, grad_accum: int,
           aux_weight: float, device):
    """(loss, gradients in ``params``' order) of the masked-LM objective.

    ``grad_accum == k > 1`` splits the batch into k micro-batches whose
    objective is ``Σ nll / total_valid + aux_weight * aux / k``, with
    ``total_valid`` counted over the whole batch, and sums the micro
    gradients into fp32 buffers (not through ``.grad``, which would sum in
    the params' dtype). The loss is the sum of the micro objectives."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_() for n in names]
    ps = dict(zip(names, leaves))
    if grad_accum == 1:
        loss = loss_fn(ps, tokens, labels, cfg, aux_weight=aux_weight,
                       device=device)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} must divide grad_accum {grad_accum}")
    mb = B // grad_accum
    total_valid = (labels >= 0).sum().clamp(min=1).float()
    acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
           for w in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(grad_accum):
        logits, aux = forward(ps, tokens[i * mb:(i + 1) * mb], cfg,
                              device=device)
        nll, _ = _masked_nll(logits, labels[i * mb:(i + 1) * mb])
        obj = nll.sum() / total_valid + aux_weight * aux / grad_accum
        for a, g in zip(acc, torch.autograd.grad(obj, leaves)):
            a.add_(g)
        loss += obj.detach()
    return loss, acc


def _step_scalar(t, device) -> torch.Tensor:
    """The step number as a 0-dim fp32 tensor on ``device``, made without
    a host sync: a fill for a Python number or a CPU tensor, a cast for a
    tensor already there."""
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        return t.to(device=device, dtype=torch.float32)
    return torch.full((), float(t), dtype=torch.float32, device=device)


def make_train_step(cfg: TransformerLMConfig, mesh=None,
                    optimizer: str = "adam", lr: float = 1e-4,
                    beta1: float = 0.9, beta2: float = 0.999,
                    epsilon: float = 1e-8, wd: float = 0.01,
                    grad_accum: int = 1, aux_weight: float = 0.01, *,
                    device=None) -> Callable:
    """Build the single-device train step
    ``step(params, opt_m, opt_v, tokens, labels, t) -> (params, opt_m,
    opt_v, loss)``, with the reference's arithmetic:

    - gradients of ``loss_fn``, or with ``grad_accum=k`` summed in fp32 over
      k micro-batches normalised by the whole batch's valid-label count
      (the batch must divide by k);
    - ``optimizer="adam"``: Adam with decoupled decay, ``lr_t = lr *
      sqrt(1 - beta2**t) / (1 - beta1**t)`` taken in fp32 on the device,
      ``w -= lr_t * m / (sqrt(v) + epsilon) + lr * wd * w``;
    - ``optimizer="lamb"``: ``upd = m / (sqrt(v) + epsilon) + wd * w``,
      ``w -= lr * trust * upd`` with the per-tensor trust ratio
      ``|w| / |upd|`` (1 where either norm is 0), no bias correction.

    Weight decay applies to every param. Moments are fp32; the update is
    computed in fp32 and cast back to each param's dtype (no fp32 master
    copy). In place of the reference's buffer donation, the step updates the
    caller's param and moment tensors in place and returns the same dicts;
    the params keep ``requires_grad=False``. ``t`` is the step number, a
    Python number or a 0-dim tensor, written into a device scalar before
    each call. The step never waits for the device: ``loss`` is a 0-dim
    fp32 tensor there. Runs on ``device`` (``cuda`` if None), where the
    params must live; pass tokens and labels already on it to avoid a
    host-to-device copy, which waits for the device.

    With ``MXNET_COMPILED_STEP`` on (the default, read at each call) the
    step is a program of the ``train_step`` namespace: captured at its
    first call for each input shape and set of param and moment tensors,
    and replayed after that (1 dispatch a step); a call with other param
    or moment tensors drops the programs over the earlier ones. On the CPU
    the same body runs through the same static buffers. With the knob at
    0 the body runs eagerly, with the same arithmetic."""
    _check_ported(cfg, mesh)
    if optimizer not in ("adam", "lamb"):
        raise ValueError(f"optimizer must be 'adam' or 'lamb', not "
                         f"{optimizer!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)
    programs = _pstore.scope("train_step")

    def update(ws, ms, vs, grads, t):
        """The optimizer's update of ``ws``, ``ms`` and ``vs`` in place."""
        # fp32 temporaries (each as large as the params in fp32) are
        # released as soon as they are used, to keep the step's peak memory
        # low; the rounding steps are the reference's
        g = [x.float() for x in grads]      # the step owns these
        del grads
        torch._foreach_mul_(ms, beta1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1 - beta1))
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - beta2)
        torch._foreach_mul_(vs, beta2)
        torch._foreach_add_(vs, g)
        del g
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, epsilon)
        upd = torch._foreach_div(ms, denom)
        del denom
        wf = [w.float() for w in ws]
        if optimizer == "lamb":
            torch._foreach_add_(upd, torch._foreach_mul(wf, wd))
            r1 = torch.stack(torch._foreach_norm(wf))
            r2 = torch.stack(torch._foreach_norm(upd))
            trust = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                                torch.ones_like(r1))
            new = [w - s * u for w, s, u in
                   zip(wf, (lr * trust).unbind(0), upd)]
        else:
            # fp32 on the device, as the reference's jitted step takes it
            lr_t = lr * torch.sqrt(1 - torch.pow(beta2, t)) \
                / (1 - torch.pow(beta1, t))
            torch._foreach_mul_(upd, lr_t)
            new = torch._foreach_sub(wf, upd)
            del upd
            torch._foreach_sub_(new, torch._foreach_mul(wf, lr * wd))
        torch._foreach_copy_(ws, new)

    def body_for(params, opt_m, opt_v):
        names = list(params)
        ws = [params[n] for n in names]
        ms = [opt_m[n] for n in names]
        vs = [opt_v[n] for n in names]

        def body(tokens, labels, t):
            ps = dict(zip(names, ws))
            loss, grads = _grads(ps, tokens, labels, cfg, grad_accum,
                                 aux_weight, dev)
            with torch.no_grad():
                update(ws, ms, vs, grads, t)
            return loss

        return body

    def step(params, opt_m, opt_v, tokens, labels, t):
        tokens = _tokens_on(tokens, params, dev)
        labels = torch.as_tensor(labels, device=tokens.device).long()
        t = _step_scalar(t, tokens.device)
        if not _config.get("MXNET_COMPILED_STEP"):
            loss = body_for(params, opt_m, opt_v)(tokens, labels, t)
            return params, opt_m, opt_v, loss
        held = [d[n] for d in (params, opt_m, opt_v) for n in params]
        key = (_pstore.tensor_key((tokens, labels)), _pstore.knob_key(),
               tuple(params), _pstore.storage_key(held))
        loss = _pstore.run(programs, key,
                           lambda: body_for(params, opt_m, opt_v),
                           (tokens, labels, t), keep=held)
        return params, opt_m, opt_v, loss

    return step
