"""Mixture-of-experts FFN with top-k gating and capacity.

Counterpart of ``mxnet_tpu/parallel/moe.py``: top-k gating with capacity
and the dense dispatch/combine einsums (static shapes, no data-dependent
sizes, so a step that runs them stays capturable as one CUDA graph; a
gather/scatter dispatch is speed work for later), the load-balance
aux-loss scope that the compiled train step folds into the loss, and
``MoEBlock``, the Gluon block. Tokens over an expert's capacity are
dropped: their combine weights are zero.

Expert parallelism over ``ep``: the reference annotates the expert-dim
intermediates with ``sharding.constraint(P('ep', 'dp'))`` and lets XLA
partition the einsums. The port places the expert weights ``P('ep')`` on
dim 0 (``spmd.param_spec``'s name rule, and ``P('ep', None, 'tp')`` /
``P('ep', 'tp', None)`` in the language model's plan). The language
model's mesh step runs each rank's own experts on every token of its rows
and sums the combine over ``ep`` (:func:`moe_layer` with ``mesh``); the
compiled Gluon step (``cached_step.TrainStep``) gathers the expert blocks
whole before the forward and keeps its block of their gradients. The
batch is not split over ``ep`` in either (the reference's data axes are
``dp`` and ``fsdp``), so the dispatch is the single-device one bit for
bit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["top_k_gating", "moe_layer", "aux_scope", "record_aux",
           "MoEBlock"]


# ---------------------------------------------------------------------------
# load-balance aux-loss plumbing (the Trainer loss path)
# ---------------------------------------------------------------------------
# A Gluon forward has no side channel for the gating aux loss; this
# thread-local scope is it. cached_step.TrainStep opens the scope around the
# forward (compiled and eager paths) and folds MXNET_MOE_AUX_WEIGHT *
# sum(recorded) into the differentiated loss heads, so the load-balance loss
# reaches the optimizer without touching the user's loss_fn signature.

_AUX = threading.local()


@contextlib.contextmanager
def aux_scope():
    """Collect the aux losses MoE blocks record during the enclosed
    forward. Yields the (mutable) list; nesting restores the outer scope on
    exit."""
    prev = getattr(_AUX, "lst", None)
    _AUX.lst = []
    try:
        yield _AUX.lst
    finally:
        _AUX.lst = prev


def record_aux(aux) -> bool:
    """Record one load-balance aux-loss value into the active scope; a
    no-op returning False when no scope is open (callers such as
    ``models/transformer_lm.py`` fold the aux themselves)."""
    lst = getattr(_AUX, "lst", None)
    if lst is None:
        return False
    lst.append(aux)
    return True


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=dtype)``, by comparison (no host
    read, so it captures)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k_gating(x, gate_w, *, num_experts: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None):
    """Dispatch and combine tensors of top-k routing.

    x: [G, S, M] (groups, tokens, model dim); gate_w: [M, E]. Returns
    (dispatch [G, S, E, C] of 0/1 in ``x``'s dtype, combine [G, S, E, C],
    the aux loss, a scalar). Tokens over the capacity C are dropped (zero
    combine weights), which keeps every shape static. The choices are taken
    one after another by ``argmax``, which, as ``jnp.argmax``, takes the
    first index among ties."""
    G, S, _M = x.shape
    E = num_experts
    if capacity is None:
        capacity = max(1, int(capacity_factor * S * k / E))
    C = capacity

    logits = torch.einsum("gsm,me->gse", x, gate_w)
    probs = torch.softmax(logits, dim=-1)

    # load-balancing auxiliary loss (Shazeer et al.): mean prob * mean
    # assignment
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=1)                                     # [G, E]
    ce = _one_hot(top1, E, x.dtype).mean(dim=1)
    aux_loss = (me * ce).sum(dim=-1).mean() * E

    dispatch = torch.zeros((G, S, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros((G, S, E, C), dtype=x.dtype, device=x.device)
    # running per-expert position counters over the k choices
    position_in_expert = torch.zeros((G, E), dtype=torch.int32,
                                     device=x.device)
    p = probs
    for _ in range(k):
        idx = torch.argmax(p, dim=-1)                          # [G, S]
        gate = torch.gather(p, -1, idx[..., None])[..., 0]
        p = p * (1.0 - _one_hot(idx, E, p.dtype))              # mask chosen
        onehot = _one_hot(idx, E, torch.int32)                 # [G, S, E]
        # each token's position in its chosen expert's queue
        pos = position_in_expert[:, None, :] \
            + torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        pos_tok = (pos * onehot).sum(dim=-1, dtype=torch.int32)  # [G, S]
        position_in_expert = position_in_expert \
            + onehot.sum(dim=1, dtype=torch.int32)
        keep = (pos_tok < C).to(x.dtype)                       # capacity
        gate = gate * keep
        pos_oh = _one_hot(torch.clamp(pos_tok, max=C - 1), C, x.dtype)
        contrib = onehot.to(x.dtype)[..., None] * pos_oh[:, :, None, :]
        dispatch = dispatch + contrib * keep[..., None, None]
        combine = combine + contrib * gate[..., None, None]
    return dispatch, combine, aux_loss


def _gelu(x):
    # jax.nn.gelu's default, the tanh form
    return F.gelu(x, approximate="tanh")


def moe_layer(x, gate_w, w_in, w_out, *, k: int = 2,
              capacity_factor: float = 1.25, capacity: Optional[int] = None,
              activation: Callable = _gelu, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE FFN.

    x: [G, S, M]; gate_w: [M, E]; w_in: [E, M, H]; w_out: [E, H, M].
    Returns (output [G, S, M], aux_loss).

    On ``mesh`` with an ``ep`` or ``tp`` axis above 1, ``x`` and
    ``gate_w`` are alike on every member of those axes, and ``w_in`` /
    ``w_out`` are this rank's blocks ``[E / ep, M, H / tp]`` /
    ``[E / ep, H / tp, M]`` (``P('ep', None, 'tp')`` and ``P('ep', 'tp',
    None)``). Every member routes all E experts, with the same dispatch
    bit for bit, runs its own experts on its hidden block, and the
    combine is summed over ``ep`` and ``tp``: the batch is not split over
    ``ep``, so no token moves and no all-to-all is needed."""
    E = gate_w.shape[-1]
    dispatch, combine, aux = top_k_gating(
        x, gate_w, num_experts=E, k=k, capacity_factor=capacity_factor,
        capacity=capacity)
    axes = () if mesh is None else tuple(
        a for a in ("ep", "tp") if int(mesh.shape.get(a, 1)) > 1)
    if axes:
        from . import collectives as _coll

        n_local = w_in.shape[0]
        e0 = (mesh.coordinate("ep") if "ep" in axes else 0) * n_local
        dispatch = dispatch[:, :, e0:e0 + n_local]
        # x and the combine weights feed every member's own experts: their
        # gradients are summed over the members
        combine = _coll.copy_to(combine, mesh, axes)[:, :, e0:e0 + n_local]
        x = _coll.copy_to(x, mesh, axes)
    # [G,S,E,C] x [G,S,M] -> expert inputs [E, G, C, M]
    expert_in = torch.einsum("gsec,gsm->egcm", dispatch, x)
    h = activation(torch.einsum("egcm,emh->egch", expert_in, w_in))
    expert_out = torch.einsum("egch,ehm->egcm", h, w_out)
    out = torch.einsum("gsec,egcm->gsm", combine, expert_out)
    if axes:
        out = _coll.reduce_from(out, mesh, axes)
    return out, aux


# ---------------------------------------------------------------------------
# Gluon adapter
# ---------------------------------------------------------------------------
_MOE_BLOCK_CLS = None


def _moe_block_cls():
    """Build the MoEBlock class at first use: importing Gluon here, not at
    module import, keeps ``mxnet_tpu_torch.parallel`` free of an import
    cycle through the Gluon package."""
    global _MOE_BLOCK_CLS
    if _MOE_BLOCK_CLS is not None:
        return _MOE_BLOCK_CLS

    from ..gluon.block import Block
    from ..gluon.parameter import Parameter

    class _Holder(Block):
        """Bare parameter holder, so that ``collect_params`` yields the
        reference's structural names (``gate.weight``,
        ``expert.ffn_1.weight``, ``expert.ffn_2.weight``)."""

    class MoEBlock(Block):
        """Dense-dispatch top-k MoE FFN (:func:`moe_layer`) as a Gluon
        block (reference ``parallel/moe.py:161``). Parameters: ``gate.weight
        [M, E]``, ``expert.ffn_1.weight [E, M, H]`` and
        ``expert.ffn_2.weight [E, H, M]``. The gating load-balance aux loss
        is recorded into the ambient :func:`aux_scope`, and
        ``cached_step.TrainStep`` folds ``MXNET_MOE_AUX_WEIGHT * sum`` into
        the differentiated loss heads on both the compiled and eager paths.
        Input ``x`` is ``[G, S, M]``; the output matches. The parameters
        live where ``initialize`` puts them (``cuda`` unless given the
        CPU)."""

        def __init__(self, units: int, hidden: int, num_experts: int, *,
                     k: int = 2, capacity_factor: float = 1.25,
                     capacity: Optional[int] = None,
                     activation: Callable = _gelu, dtype: str = "float32"):
            super().__init__()
            self._k = k
            self._capacity_factor = capacity_factor
            self._capacity = capacity
            self._activation = activation
            self.gate = _Holder()
            self.gate.weight = Parameter(
                "weight", shape=(units, num_experts), dtype=dtype)
            self.expert = _Holder()
            self.expert.ffn_1 = _Holder()
            self.expert.ffn_1.weight = Parameter(
                "weight", shape=(num_experts, units, hidden), dtype=dtype)
            self.expert.ffn_2 = _Holder()
            self.expert.ffn_2.weight = Parameter(
                "weight", shape=(num_experts, hidden, units), dtype=dtype)

        def forward(self, x):
            out, aux = moe_layer(
                x, self.gate.weight.data(), self.expert.ffn_1.weight.data(),
                self.expert.ffn_2.weight.data(), k=self._k,
                capacity_factor=self._capacity_factor,
                capacity=self._capacity, activation=self._activation)
            record_aux(aux)
            return out

    _MOE_BLOCK_CLS = MoEBlock
    return _MOE_BLOCK_CLS


def __getattr__(name):
    if name == "MoEBlock":
        return _moe_block_cls()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
