"""Flagship transformer LM (BERT-class pre-LN encoder) in PyTorch.

Counterpart of ``mxnet_tpu/models/transformer_lm.py``, whose math it keeps:
the same flat ``{name: Tensor}`` parameter dict (names, shapes, dtypes), the
fp32 layer norm, the residual stream in ``cfg.dtype``, tanh-GELU, tied
output head with fp32 logits, the masked-LM loss, and the train step's
Adam(W)/LAMB arithmetic. Attention goes through the hand-written
flash-attention kernels
(:func:`mxnet_tpu_torch.ops.cuda_kernels.flash_attention`: forward, and
the dq and dk/dv backward kernels) on CUDA.

The forward, the loss, rematerialisation (``cfg.remat``),
``init_opt_state`` and ``make_train_step`` with gradient accumulation run
on one device or on a mesh (``parallel.make_mesh``) over the axes ``dp``,
``fsdp``, ``tp``, ``sp`` and ``ep``. The step is captured once per input
shape and replayed after that (``program_store``), the counterpart of the
reference's ``jax.jit(step, donate_argnums=...)``. ``num_experts > 0``
makes every layer's MLP a top-k mixture of experts
(``parallel.moe.moe_layer``) whose load-balance aux losses the forward
sums, and the loss and the train step weight by ``aux_weight`` (under
``grad_accum=k`` per micro-batch, divided by k: the reference's semantics,
kept).

On a mesh each rank computes on its own shards and writes the collectives
itself (the reference's XLA partitioner derives them from the
shardings): parameters are this rank's blocks of :func:`sharding_plan`
(``ShardingPlan.shard_tree``), or whole; tokens and labels are the global
batch, split over ``(dp, fsdp)`` on rows and ``sp`` on the sequence. Under
``tp`` attention runs on this rank's heads (the qkv block of the plan is
not head-aligned, so it is gathered and the rank's heads taken from it),
the MLP and the experts on this rank's hidden block, the embedding on its
vocabulary rows, and the masked NLL takes the whole vocabulary's
log-softmax from a distributed max and sum. Under ``sp`` the positions are
offset by the rank's ``sp`` coordinate and attention runs as ring
attention (``cfg.use_ring_attention``) or against K and V gathered over
``sp``. Under ``ep`` each rank runs its own experts on every token of its
rows and the combine is summed over ``ep``. The forward uses flash
attention on the local q, k, v wherever ``sp`` is 1 (the reference turns
it off on a mesh of more than one device only because ``pallas_call`` has
no partitioning rule). Axes of size 1 are elided, so a mesh of one is the
single-device program bit for bit.

Pipeline parallelism (``pp``) goes through :func:`make_pp_pipeline`,
:func:`pp_loss_fn` and :func:`make_pp_train_step`
(``parallel.pipeline.HeteroPipeline``).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import config as _config
from .. import program_store as _pstore
from .. import telemetry as _telemetry
from ..context import resolve_device
from ..ops import cuda_kernels as _kernels
from ..parallel import collectives as _coll
from ..parallel import moe as _moe
from ..parallel.ring_attention import ring_attention as _ring_attention
from ..parallel.sharding import PartitionSpec as P, ShardingPlan

__all__ = ["TransformerLMConfig", "param_shapes", "init_params", "forward",
           "loss_fn", "sharding_plan", "init_opt_state", "make_train_step",
           "pp_stages", "make_pp_pipeline", "pp_loss_fn", "pp_pad_batch",
           "make_pp_train_step", "flash_fallback_count"]

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
    # MoE: 0 = dense MLP everywhere; E > 0 = every layer is a top-k MoE
    num_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
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


def _check_mesh(mesh) -> None:
    if mesh is not None and not hasattr(mesh, "shape"):
        raise TypeError(f"mesh must be a parallel.Mesh, not "
                        f"{type(mesh).__name__}")


# the axes a forward on a mesh computes on blockwise, and the parameters
# it reads as blocks over them; every other split is gathered whole before
# use (the plan's embed rule also splits pos_embed.weight over tp)
_LOCAL_AXES = ("tp", "ep")
_BLOCKWISE = re.compile(r"^embed\.weight$|attn\.(qkv|out_proj)\.|"
                        r"(^|\.)ffn_[12]\.|(^|\.)expert\.")
_BATCH_AXES = ("dp", "fsdp")


class _Shards:
    """This rank's place on the mesh the LM runs over: the sizes and
    coordinates of ``tp``, ``sp`` and ``ep``, and the axes above 1 that
    split the batch rows (``dp``, ``fsdp``) and that the gradients of the
    replicated parameters are summed over (those and ``sp``). Checks that
    the config's widths divide the axes the forward splits them over."""

    def __init__(self, mesh, cfg: "TransformerLMConfig"):
        self.mesh = mesh
        size = lambda a: int(mesh.shape.get(a, 1))          # noqa: E731
        at = lambda a: mesh.coordinate(a) if size(a) > 1 else 0  # noqa
        self.tp, self.sp, self.ep = size("tp"), size("sp"), size("ep")
        self.tp_idx, self.sp_idx, self.ep_idx = at("tp"), at("sp"), at("ep")
        self.batch_axes = tuple(a for a in _BATCH_AXES if size(a) > 1)
        self.n_batch = math.prod(size(a) for a in self.batch_axes)
        self.grad_axes = self.batch_axes + (("sp",) if self.sp > 1 else ())
        if self.tp > 1:
            widths = {"num_heads": cfg.num_heads,
                      "vocab_size": cfg.vocab_size}
            if not cfg.num_experts:
                widths["mlp_hidden"] = cfg.mlp_hidden
            for what, n in widths.items():
                if n % self.tp:
                    raise ValueError(f"{what}={n} does not split over the "
                                     f"{self.tp}-way 'tp' axis")
        if self.ep > 1 and cfg.num_experts % self.ep:
            raise ValueError(f"num_experts={cfg.num_experts} does not "
                             f"split over the {self.ep}-way 'ep' axis")

    def local_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (over ``dp``, ``fsdp``) and positions (over
        ``sp``) of the global ``[B, S]`` batch leaf ``t``."""
        spec = P(self.batch_axes or None, "sp" if self.sp > 1 else None)
        for d, n in ((0, self.n_batch), (1, self.sp)):
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of the batch {tuple(t.shape)} "
                                 f"does not split {n} ways over the mesh")
        return _coll.local_block(t, spec, self.mesh)


def _block_shape(shape, spec, mesh) -> tuple:
    out = list(shape)
    padded = (tuple(spec) + (None,) * len(shape))[:len(shape)]
    for d, axes in enumerate(padded):
        for a in (() if axes is None else
                  (axes if isinstance(axes, tuple) else (axes,))):
            out[d] //= int(mesh.shape.get(a, 1))
    return tuple(out)


def _param_specs(params, cfg: "TransformerLMConfig", mesh
                 ) -> Dict[str, tuple]:
    """Each parameter's spec on ``mesh``: the one it was placed with
    (``ShardingPlan.shard`` and ``spmd.ensure_placed`` record it), else
    whole where it has the whole shape, else :func:`sharding_plan`'s.
    A block of another shape raises."""
    from ..parallel import spmd as _spmd

    plan, key = sharding_plan(cfg), _spmd.mesh_key(mesh)
    specs = {}
    for name, (shape, _dt) in param_shapes(cfg).items():
        t = params[name]
        placed = getattr(t, "_spmd_placement", None)
        if placed is not None and placed[0] == key:
            spec = tuple(placed[1])
        elif tuple(t.shape) == shape:
            spec = ()
        else:
            spec = tuple(plan.spec_for(name, shape, mesh))
        if _block_shape(shape, spec, mesh) != tuple(t.shape):
            raise ValueError(
                f"parameter {name!r} of shape {tuple(t.shape)} is neither "
                f"whole {shape} nor its block of {spec} on {mesh.shape}")
        if _BLOCKWISE.search(name):
            # the forward reads these as the plan's tp / ep blocks
            want = _local_part(plan.spec_for(name, shape, mesh), mesh)
            if _local_part(spec, mesh) != want:
                raise ValueError(
                    f"parameter {name!r} is placed {spec}; on {mesh.shape} "
                    f"its tp / ep split must be sharding_plan's {want}")
        specs[name] = spec
    return specs


def _local_part(spec, mesh) -> tuple:
    """The ``tp`` / ``ep`` axes above 1 of ``spec``, dim by dim."""
    out = []
    for axes in spec:
        t = () if axes is None else \
            (axes if isinstance(axes, tuple) else (axes,))
        out.append(tuple(a for a in t if a in _LOCAL_AXES
                         and int(mesh.shape.get(a, 1)) > 1))
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _gather_spec(name: str, spec) -> P:
    """The part of ``spec`` that is gathered before the forward reads
    ``name``: all of it, less ``tp`` and ``ep`` for the parameters read as
    blocks."""
    if not _BLOCKWISE.search(name):
        return P(*spec)
    out = []
    for axes in spec:
        t = () if axes is None else \
            (axes if isinstance(axes, tuple) else (axes,))
        t = tuple(a for a in t if a not in _LOCAL_AXES)
        out.append(t[0] if len(t) == 1 else (t or None))
    return P(*out)


def _compute_params(params, specs, sh: _Shards) -> Dict[str, torch.Tensor]:
    """The tensors the forward reads: the blocks gathered whole, less the
    ``tp`` and ``ep`` splits of the parameters read as blocks."""
    from ..parallel import spmd as _spmd

    return {n: _spmd.gather_full(params[n], _gather_spec(n, specs[n]),
                                 sh.mesh) for n in specs}


def param_shapes(cfg: TransformerLMConfig
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of the parameter dict, in init order."""
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
        if cfg.num_experts:
            E = cfg.num_experts
            p[pre + "moe.gate.weight"] = ((H, E), dt)
            p[pre + "expert.ffn_1.weight"] = ((E, H, M), dt)
            p[pre + "expert.ffn_2.weight"] = ((E, M, H), dt)
        else:
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
    0.02/sqrt(2L) on the residual-branch outputs (out_proj, ffn_2 and the
    experts' ffn_2), zero biases, unit gammas. Draws come from
    ``generator`` (seed 0 on the target device if None); they differ from
    the JAX package's draws, so parity tests carry the JAX weights over
    with ``convert``."""
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


def _attention(x, p, pre: str, cfg: TransformerLMConfig,
               sh: Optional[_Shards] = None):
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    w, b = p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"]
    if sh is not None and sh.tp > 1:
        # the plan's qkv block is rows of [q; k; v], not whole heads:
        # gather it (its gradient reduce-scattered back) and take this
        # rank's heads of q, k and v
        w = _coll.gather_dim(w, sh.mesh, "tp", 0)
        b = _coll.gather_dim(b, sh.mesh, "tp", 0)
        hl, nh = H // sh.tp, nh // sh.tp
        w = w.view(3, sh.tp, hl, H)[:, sh.tp_idx].reshape(3 * hl, H)
        b = b.view(3, sh.tp, hl)[:, sh.tp_idx].reshape(3 * hl)
        x = _coll.copy_to(x, sh.mesh, "tp")
    qkv = x @ w.T + b
    # (B, S, 3, nh, hd) -> three contiguous (B, nh, S, hd)
    q, k, v = qkv.reshape(B, S, 3, nh, hd).permute(2, 0, 3, 1, 4) \
        .contiguous().unbind(0)
    sp = sh.sp if sh is not None else 1
    if sp > 1 and cfg.use_ring_attention:
        # the sequence stays split over sp; K/V rotate around the ring
        out = _ring_attention(q, k, v, "sp", mesh=sh.mesh)
    elif sp > 1:
        # whole-sequence attention of this rank's queries: K and V gathered
        # over sp (their gradients reduce-scattered back), as XLA gathers
        # them in the reference
        k = _coll.gather_dim(k, sh.mesh, "sp", 2)
        v = _coll.gather_dim(v, sh.mesh, "sp", 2)
        out = _einsum_attention(q, k, v, hd, x.dtype)
    elif _use_flash(cfg, S, hd):
        out = _kernels.flash_attention(q, k, v, causal=False).to(x.dtype)
    else:
        out = _einsum_attention(q, k, v, hd, x.dtype)
    out = out.transpose(1, 2).reshape(B, S, nh * hd)
    y = out @ p[pre + "attn.out_proj.weight"].T
    if sh is not None and sh.tp > 1:
        y = _coll.reduce_from(y, sh.mesh, "tp")
    return y + p[pre + "attn.out_proj.bias"]


def _einsum_attention(q, k, v, hd: int, dtype):
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float()).to(dtype)


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _mlp(x, p, pre: str, cfg: TransformerLMConfig,
         sh: Optional[_Shards] = None):
    """(the MLP's output, its aux loss): the dense MLP's aux is 0.0, the
    MoE's the gating load-balance loss of the whole batch."""
    if cfg.num_experts:
        return _moe_mlp(x, p, pre, cfg, sh)
    w1, b1 = p[pre + "ffn_1.weight"], p[pre + "ffn_1.bias"]
    if sh is not None and sh.tp > 1:
        x = _coll.copy_to(x, sh.mesh, "tp")
    h = F.gelu(x @ w1.T + b1, approximate="tanh")
    y = h @ p[pre + "ffn_2.weight"].T
    if sh is not None and sh.tp > 1:
        y = _coll.reduce_from(y, sh.mesh, "tp")
    return y + p[pre + "ffn_2.bias"], 0.0


def _moe_mlp(x, p, pre: str, cfg: TransformerLMConfig,
             sh: Optional[_Shards]):
    args = (p[pre + "moe.gate.weight"].to(x.dtype),
            p[pre + "expert.ffn_1.weight"], p[pre + "expert.ffn_2.weight"])
    kw = dict(k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
    if sh is None:
        return _moe.moe_layer(x, *args, **kw)
    S = x.shape[1]
    if sh.sp > 1:
        # routing takes each row's whole sequence (capacity and queue
        # positions run over it): gather it, and keep this rank's positions
        # of the output
        x = _coll.gather_dim(x, sh.mesh, "sp", 1)
    out, aux = _moe.moe_layer(x, *args, mesh=sh.mesh, **kw)
    if sh.sp > 1:
        out = out[:, sh.sp_idx * S:(sh.sp_idx + 1) * S]
        # every sp member computes the same aux, and the gradients are
        # summed over sp: count its gradient once
        aux = _GradScale.apply(aux, 1.0 / sh.sp)
    if sh.batch_axes:
        # the mean over the whole batch's rows of the members' row means
        aux = _coll.reduce_from(aux, sh.mesh, sh.batch_axes) / sh.n_batch
    return out, aux


def _block(params, x, i: int, cfg: TransformerLMConfig,
           sh: Optional[_Shards] = None):
    """One pre-LN transformer block (attention + MLP/MoE residual):
    (output, the MLP's aux loss)."""
    pre = f"layer{i}."
    x = x + _attention(_layer_norm(x, params[pre + "ln1.gamma"],
                                   params[pre + "ln1.beta"]),
                       params, pre, cfg, sh)
    m, aux = _mlp(_layer_norm(x, params[pre + "ln2.gamma"],
                              params[pre + "ln2.beta"]), params, pre, cfg,
                  sh)
    return x + m, aux


def _tokens_on(tokens, params, device) -> torch.Tensor:
    dev = resolve_device(device)
    emb = params["embed.weight"]
    if emb.device.type != dev.type or (
            dev.index is not None and emb.device != dev):
        raise ValueError(f"params are on {emb.device}, but the forward was "
                         f"asked to run on {dev}")
    return torch.as_tensor(tokens, device=emb.device).long()


def _embed(params, tokens, cfg: TransformerLMConfig,
           sh: Optional[_Shards] = None):
    S = tokens.shape[1]
    w = params["embed.weight"]
    if sh is not None and sh.tp > 1:
        # this rank's vocabulary rows: its tokens looked up, the others 0,
        # summed over tp (exactly one member holds each token)
        rows = w.shape[0]
        local = tokens - sh.tp_idx * rows
        inside = (local >= 0) & (local < rows)
        e = torch.where(inside[..., None], w[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=w.dtype, device=w.device))
        e = _coll.reduce_from(e, sh.mesh, "tp")
    else:
        e = w[tokens]
    start = sh.sp_idx * S if sh is not None else 0
    return (e + params["pos_embed.weight"][start:start + S]).to(cfg.dtype)


def _forward_local(params, tokens, cfg: TransformerLMConfig,
                   sh: Optional[_Shards] = None):
    """(this rank's logits [b, s, V / tp] fp32, the aux loss) of its
    tokens; the whole forward where ``sh`` is None."""
    x = _embed(params, tokens, cfg, sh)
    aux_total = 0.0
    # remat: keep only each layer's input and recompute the layer in the
    # backward, as jax.checkpoint does in the reference
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        if remat:
            # no random ops to replay, and no RNG state to stash (which a
            # captured step could not read)
            x, aux = checkpoint(_block, params, x, i, cfg, sh,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _block(params, x, i, cfg, sh)
        aux_total = aux_total + aux
    x = _layer_norm(x, params["final_ln.gamma"], params["final_ln.beta"])
    if sh is not None and sh.tp > 1:
        x = _coll.copy_to(x, sh.mesh, "tp")
    logits = x @ params["embed.weight"].T.to(cfg.dtype)
    if not isinstance(aux_total, torch.Tensor):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits.float(), aux_total.float()


def _on_mesh(params, tokens, cfg: TransformerLMConfig, mesh, device):
    """(shards, the compute tensors, this rank's tokens) for a forward on
    ``mesh``; the global tokens go to the mesh's device."""
    sh = _Shards(mesh, cfg)
    ps = _compute_params(params, _param_specs(params, cfg, mesh), sh)
    tokens = _tokens_on(tokens, params, device if device is not None
                        else mesh.device)
    return sh, ps, sh.local_tokens(tokens)


def forward(params, tokens, cfg: TransformerLMConfig, mesh=None, *,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] float32, aux loss float32).

    Runs on ``device`` (``cuda`` if None, where ``params`` must live). The
    aux loss is the sum over layers of the MoE gating load-balance losses
    (0 for a dense config). On ``mesh`` (see the module docstring) the
    params are this rank's blocks or whole, the tokens global, and every
    rank returns the whole logits and aux."""
    _check_mesh(mesh)
    if mesh is None:
        return _forward_local(params, _tokens_on(tokens, params, device),
                              cfg)
    sh, ps, toks = _on_mesh(params, tokens, cfg, mesh, device)
    logits, aux = _forward_local(ps, toks, cfg, sh)
    logits = _coll.gather_replicated(logits, mesh, "tp", 2)
    logits = _coll.gather_replicated(logits, mesh, "sp", 1)
    return _coll.gather_replicated(logits, mesh, sh.batch_axes, 0), aux


def _masked_nll(logits, labels):
    """Per-position masked NLL: labels int, -1 = unmasked (ignored).
    Returns (nll [B,S] with zeros at masked positions, valid mask [B,S])."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def _masked_nll_local(logits, labels, sh: Optional[_Shards]):
    """:func:`_masked_nll` of this rank's positions from its vocabulary
    block of the logits: the whole vocabulary's log-softmax through a max
    and a sum over ``tp``."""
    if sh is None or sh.tp == 1:
        return _masked_nll(logits, labels)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    m = _coll.all_reduce(logits.detach().amax(dim=-1), "tp", op="max",
                         mesh=sh.mesh)
    z = logits - m[..., None]
    total = _coll.reduce_from(z.exp().sum(dim=-1), sh.mesh, "tp")
    rows = logits.shape[-1]
    local = safe - sh.tp_idx * rows
    inside = (local >= 0) & (local < rows)
    picked = torch.gather(z, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
    picked = _coll.reduce_from(
        torch.where(inside, picked, torch.zeros_like(picked)), sh.mesh, "tp")
    nll = torch.log(total) - picked
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def _local_objective(ps, tokens, labels, cfg: TransformerLMConfig,
                     sh: Optional[_Shards], denom, aux_weight: float,
                     k: int = 1):
    """``Σ nll / denom + aux_weight * aux / k`` over the whole batch, from
    this rank's tokens and labels (the NLL sum reduced over the batch and
    sequence axes); the same value on every rank."""
    logits, aux = _forward_local(ps, tokens, cfg, sh)
    nll, _valid = _masked_nll_local(logits, labels, sh)
    total = nll.sum()
    if sh is not None:
        total = _coll.reduce_from(total, sh.mesh, sh.grad_axes)
    if k == 1:
        return total / denom + aux_weight * aux
    return total / denom + aux_weight * aux / k


def loss_fn(params, tokens, labels, cfg: TransformerLMConfig, mesh=None,
            aux_weight: float = 0.01, *, device=None) -> torch.Tensor:
    """Masked-LM style CE: labels [B,S] int, -1 = unmasked (ignored). On
    ``mesh`` the labels are global, and every rank returns the loss of
    the whole batch."""
    _check_mesh(mesh)
    if mesh is None:
        logits, aux = forward(params, tokens, cfg, device=device)
        labels = torch.as_tensor(labels, device=logits.device).long()
        nll, valid = _masked_nll(logits, labels)
        denom = valid.sum().clamp(min=1)
        return nll.sum() / denom + aux_weight * aux
    sh, ps, toks = _on_mesh(params, tokens, cfg, mesh, device)
    labels = torch.as_tensor(labels, device=toks.device).long()
    denom = (labels >= 0).sum().clamp(min=1)
    return _local_objective(ps, toks, sh.local_tokens(labels), cfg, sh,
                            denom, aux_weight)


def sharding_plan(cfg: TransformerLMConfig) -> ShardingPlan:
    """tp over attention and MLP (Megatron), ep over experts, embeddings
    over tp (reference :272-287); fsdp composes by the caller stacking
    plans. ``plan.shard_tree(params, mesh)`` gives this rank's blocks."""
    return ShardingPlan([
        (r"attn\.qkv\.weight$", P(("tp",), None)),
        (r"attn\.qkv\.bias$", P("tp")),
        (r"attn\.out_proj\.weight$", P(None, "tp")),
        (r"expert\.ffn_1\.weight$", P("ep", None, "tp")),
        (r"expert\.ffn_2\.weight$", P("ep", "tp", None)),
        (r"(^|\.)ffn_1\.weight$", P("tp", None)),
        (r"(^|\.)ffn_1\.bias$", P("tp")),
        (r"(^|\.)ffn_2\.weight$", P(None, "tp")),
        (r"embed\.weight$", P("tp", None)),
    ])


def init_opt_state(params) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """Adam/LAMB first and second moments: two dicts of fp32 zeros with the
    params' names, shapes and device (and, for blocks placed on a mesh,
    their placement, so that sharding them again is a no-op)."""
    def zeros():
        out = {}
        for n, w in params.items():
            z = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            placed = getattr(w, "_spmd_placement", None)
            if placed is not None:
                z._spmd_placement = placed
            out[n] = z
        return out
    return zeros(), zeros()


def _grads(params, tokens, labels, cfg: TransformerLMConfig, grad_accum: int,
           aux_weight: float, device, sh: Optional[_Shards] = None,
           specs: Optional[Dict[str, tuple]] = None):
    """(loss, gradients in ``params``' order) of the masked-LM objective.

    ``grad_accum == k > 1`` splits the batch into k micro-batches whose
    objective is ``Σ nll / total_valid + aux_weight * aux / k``, with
    ``total_valid`` counted over the whole batch, and sums the micro
    gradients into fp32 buffers (not through ``.grad``, which would sum in
    the params' dtype). The loss is the sum of the micro objectives.

    On a mesh (``sh``) ``tokens`` and ``labels`` are the global batch and
    ``params`` this rank's blocks (``specs``): the forward reads them
    gathered over the axes other than ``tp`` and ``ep``, each micro-batch
    is the global one's rows and positions of this rank, and every
    gradient comes back as this rank's block of the whole batch's
    (``spmd.reduce_grad`` over the batch and sequence axes)."""
    names = list(params)
    if sh is None:
        leaves = [params[n].detach().requires_grad_() for n in names]
    else:
        from ..parallel import spmd as _spmd

        leaves = [_spmd.gather_full(params[n].detach(),
                                    _gather_spec(n, specs[n]), sh.mesh)
                  .requires_grad_() for n in names]
    ps = dict(zip(names, leaves))
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} must divide grad_accum {grad_accum}")
    if sh is None and grad_accum == 1:
        loss = loss_fn(ps, tokens, labels, cfg, aux_weight=aux_weight,
                       device=device)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    mb = B // grad_accum
    total_valid = (labels >= 0).sum().clamp(min=1)
    if grad_accum > 1:
        total_valid = total_valid.float()
    acc = None
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(grad_accum):
        toks, labs = (t[i * mb:(i + 1) * mb] for t in (tokens, labels))
        if sh is not None:
            toks, labs = sh.local_tokens(toks), sh.local_tokens(labs)
        obj = _local_objective(ps, toks, labs, cfg, sh, total_valid,
                               aux_weight, grad_accum)
        gs = torch.autograd.grad(obj, leaves)
        if grad_accum == 1:
            acc, loss = list(gs), obj.detach()
            break
        if acc is None:
            acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                   for w in leaves]
        for a, g in zip(acc, gs):
            a.add_(g)
        loss += obj.detach()
    if sh is not None:
        acc = [_spmd.reduce_grad(g, _gather_spec(n, specs[n]), sh.mesh,
                                 sh.grad_axes) for n, g in zip(names, acc)]
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
    """Build the train step ``step(params, opt_m, opt_v, tokens, labels,
    t) -> (params, opt_m, opt_v, loss)``, with the reference's arithmetic:

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
    0 the body runs eagerly, with the same arithmetic.

    On ``mesh`` (reference :442-526; see the module docstring) every rank
    calls the step with its blocks of the params and moments (the moments
    shaped like their params) and the GLOBAL tokens and labels, split
    over ``(dp, fsdp)`` on rows and ``sp`` on the sequence (the reference's
    batch spec ``P(('dp', 'fsdp'), 'sp')``); under ``grad_accum=k`` each
    micro-batch is the global one's rows of this rank. Each block is
    updated in place from its block of the whole batch's gradient, and
    LAMB's norms are those of the whole tensors (the squared norms summed
    over the axes that split a block). The loss is the whole batch's on
    every rank. Axes of size 1 are elided: on a mesh of one the step is
    the single-device step bit for bit. Runs on the mesh's device."""
    _check_mesh(mesh)
    if optimizer not in ("adam", "lamb"):
        raise ValueError(f"optimizer must be 'adam' or 'lamb', not "
                         f"{optimizer!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    sh = _Shards(mesh, cfg) if mesh is not None else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    programs = _pstore.scope("train_step")

    def whole_norms(ts, split):
        """The norms of the whole tensors of which ``ts`` are blocks: the
        squared norms of the blocks ``split`` over some axes (``{axes:
        [index]}``) summed over those axes."""
        rs = list(torch._foreach_norm(ts))
        for axes, idx in split.items():
            sq = torch.stack([rs[i] * rs[i] for i in idx])
            sq = _coll.all_reduce(sq, axes, mesh=mesh).sqrt()
            for i, r in zip(idx, sq.unbind(0)):
                rs[i] = r
        return torch.stack(rs)

    def update(ws, ms, vs, grads, t, split):
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
            r1 = whole_norms(wf, split)
            r2 = whole_norms(upd, split)
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
        specs, split = None, {}
        if sh is not None:
            specs = _param_specs(params, cfg, mesh)
            for i, n in enumerate(names):
                if opt_m[n].shape != ws[i].shape or \
                        opt_v[n].shape != ws[i].shape:
                    raise ValueError(f"the moments of {n!r} are not shaped "
                                     "like its block")
                axes = tuple(a for d in specs[n] if d is not None
                             for a in (d if isinstance(d, tuple) else (d,))
                             if mesh.shape.get(a, 1) > 1)
                if axes:
                    split.setdefault(axes, []).append(i)

        def body(tokens, labels, t):
            ps = dict(zip(names, ws))
            loss, grads = _grads(ps, tokens, labels, cfg, grad_accum,
                                 aux_weight, dev, sh, specs)
            with torch.no_grad():
                update(ws, ms, vs, grads, t, split)
            return loss

        return body

    def step(params, opt_m, opt_v, tokens, labels, t):
        tokens = _tokens_on(tokens, params, dev)
        labels = torch.as_tensor(labels, device=tokens.device).long()
        t = _step_scalar(t, tokens.device)
        if not _config.get("MXNET_COMPILED_STEP"):
            loss = body_for(params, opt_m, opt_v)(tokens, labels, t)
            return params, opt_m, opt_v, loss
        from ..parallel import spmd as _spmd

        held = [d[n] for d in (params, opt_m, opt_v) for n in params]
        key = (_pstore.tensor_key((tokens, labels)), _pstore.knob_key(),
               tuple(params), _pstore.storage_key(held),
               _spmd.mesh_key(mesh))
        loss = _pstore.run(programs, key,
                           lambda: body_for(params, opt_m, opt_v),
                           (tokens, labels, t), keep=held)
        return params, opt_m, opt_v, loss

    return step


# ---------------------------------------------------------------------------
# pipeline parallelism: the LM as heterogeneous pp stages
# ---------------------------------------------------------------------------
def pp_stages(cfg: TransformerLMConfig, params, pp: int):
    """Split the params and the compute into ``pp`` stages for
    :class:`parallel.pipeline.HeteroPipeline` (reference :301-343).

    Stage 0 is the token and position embedding and the first layers;
    the last stage the last layers, the final LN, the LM head and the
    per-sample masked-NLL reduction (``(nll_sum [mb], valid_count [mb])``,
    so that the caller combines the micro-batch losses exactly). The tied
    embedding / head weight is split into two copies (``embed.weight`` on
    stage 0, ``head.weight`` on the last), whose gradients
    :func:`make_pp_train_step` sums every step, so equal-initialised
    copies stay tied. Returns ``(stage_fns, stage_params)``."""
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} must divide pp {pp}")
    if cfg.num_experts:
        raise ValueError("the pp path takes dense MLP stages only")
    per = cfg.num_layers // pp
    stage_params, stage_fns = [], []
    for s in range(pp):
        sp = {}
        if s == 0:
            sp["embed.weight"] = params["embed.weight"]
            sp["pos_embed.weight"] = params["pos_embed.weight"]
        for i in range(s * per, (s + 1) * per):
            pre = f"layer{i}."
            for k, v in params.items():
                if k.startswith(pre):
                    sp[k] = v
        if s == pp - 1:
            sp["final_ln.gamma"] = params["final_ln.gamma"]
            sp["final_ln.beta"] = params["final_ln.beta"]
            sp["head.weight"] = params["embed.weight"]
        stage_params.append(sp)
        stage_fns.append(_make_stage_fn(cfg, s, per, pp))
    return stage_fns, stage_params


def _make_stage_fn(cfg: TransformerLMConfig, s: int, per: int, pp: int):
    def stage(p, act, labels):
        if s == 0:
            tokens = act.long()                    # [mb, S]
            S = tokens.shape[1]
            x = (p["embed.weight"][tokens] + p["pos_embed.weight"][:S]) \
                .to(cfg.dtype)
        else:
            x = act                                # [mb, S, H]
        for i in range(s * per, (s + 1) * per):
            # no mesh inside a stage: flash attention on this device
            x, _aux = _block(p, x, i, cfg)
        if s == pp - 1:
            x = _layer_norm(x, p["final_ln.gamma"], p["final_ln.beta"])
            logits = (x @ p["head.weight"].T.to(cfg.dtype)).float()
            nll, valid = _masked_nll(logits, labels.long())
            return nll.sum(dim=-1), valid.sum(dim=-1).float()
        return x

    return stage


def make_pp_pipeline(cfg: TransformerLMConfig, params, mesh, *,
                     num_microbatches: int, example_tokens,
                     remat: bool = False):
    """A :class:`parallel.pipeline.HeteroPipeline` of this LM over the
    mesh axes ``pp`` (and ``dp``), with the embedding and the head tied
    (reference :346-363)."""
    from ..parallel.pipeline import HeteroPipeline

    pp = int(mesh.shape.get("pp", 1))
    stage_fns, stage_params = pp_stages(cfg, params, pp)
    example_tokens = torch.as_tensor(example_tokens)
    pipe = HeteroPipeline(
        stage_fns, stage_params, mesh, num_microbatches=num_microbatches,
        example_x=example_tokens,
        example_extras=(torch.empty(tuple(example_tokens.shape),
                                    dtype=torch.int32, device="meta"),),
        remat=remat)
    # embed (stage 0) and head (last stage) are tied copies; the train
    # step sums their gradients so that they stay tied
    pipe.tied = (((0, "embed.weight"), (pp - 1, "head.weight")),)
    return pipe


def pp_loss_fn(pipe, packed_params, tokens, labels):
    """The masked-LM CE through the pipeline (matches :func:`loss_fn` for
    dense configs up to the fp32 packing), the same on every rank."""
    nll_sum, counts = pipe.apply(packed_params, tokens, labels)
    return nll_sum.sum() / counts.sum().clamp(min=1.0)


def pp_pad_batch(tokens, labels, multiple: int):
    """Pad a ragged batch up to the next multiple of ``multiple`` rows
    (``num_microbatches * dp``): the pad rows carry label -1 everywhere, so
    with the masked CE normalised by the whole batch's valid count the
    padded batch's loss and gradients are the unpadded batch's (reference
    :378-398)."""
    tokens, labels = torch.as_tensor(tokens), torch.as_tensor(labels)
    pad = (-tokens.shape[0]) % multiple
    if pad == 0:
        return tokens, labels
    tz = torch.zeros((pad,) + tuple(tokens.shape[1:]), dtype=tokens.dtype,
                     device=tokens.device)
    lm = torch.full((pad,) + tuple(labels.shape[1:]), -1, dtype=labels.dtype,
                    device=labels.device)
    return torch.cat([tokens, tz]), torch.cat([labels, lm])


def make_pp_train_step(pipe, optimizer: str = "adam", lr: float = 1e-4,
                       beta1: float = 0.9, beta2: float = 0.999,
                       epsilon: float = 1e-8, wd: float = 0.0) -> Callable:
    """Adam(W) or SGD on the packed ``[n_stages, P]`` fp32 stage buffer
    (reference :401-439): ``step(packed, m, v, tokens, labels, t) ->
    (packed, m, v, loss)``. The updates are elementwise, so exact in packed
    space (the padding sees zero gradients, moments and decay). The
    micro-batch gradients accumulate inside the pipeline's schedule, and
    the gradients of tied leaves (``pipe.tied``) are summed over their
    stages before the update. Every rank holds the whole buffer and the
    moments (the reference places them ``P('pp', None)``) and updates them
    in place, returning the same tensors; the loss is a 0-dim tensor on
    the device. With ``MXNET_COMPILED_STEP`` on the step is captured at
    its first call for each input shape and replayed after that, as
    :func:`make_train_step`."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"optimizer must be 'adam' or 'sgd', not "
                         f"{optimizer!r}")
    ties = getattr(pipe, "tied", ())
    programs = _pstore.scope("train_step")

    def body_for(packed, m, v):
        def body(tokens, labels, t):
            leaf = packed.detach().requires_grad_()
            loss = pp_loss_fn(pipe, leaf, tokens, labels)
            (g,) = torch.autograd.grad(loss, [leaf])
            with torch.no_grad():
                if ties:
                    g = pipe.tie_grads(g, ties)
                if optimizer == "sgd":
                    packed.copy_(packed - lr * g - lr * wd * packed)
                else:
                    m.mul_(beta1).add_(g * (1 - beta1))
                    v.mul_(beta2).add_(g.square() * (1 - beta2))
                    lr_t = lr * torch.sqrt(1 - torch.pow(beta2, t)) \
                        / (1 - torch.pow(beta1, t))
                    upd = m / (v.sqrt() + epsilon)
                    packed.copy_(packed - lr_t * upd - lr * wd * packed)
            return loss.detach()

        return body

    def step(packed, m, v, tokens, labels, t):
        dev = packed.device
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        t = _step_scalar(t, dev)
        if not _config.get("MXNET_COMPILED_STEP"):
            return packed, m, v, body_for(packed, m, v)(tokens, labels, t)
        held = [packed, m, v]
        key = ("pp", _pstore.tensor_key((tokens, labels)),
               _pstore.knob_key(), id(pipe), _pstore.storage_key(held))
        loss = _pstore.run(programs, key, lambda: body_for(packed, m, v),
                           (tokens, labels, t), keep=held)
        return packed, m, v, loss

    return step
