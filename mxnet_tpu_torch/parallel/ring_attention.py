"""Ring attention: the sequence as a mesh axis (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

Q, K and V are split over ``sp``, member i holding the tokens
``[i * S_local, (i + 1) * S_local)``. Each of the ``n`` steps attends this
rank's queries to the K/V block it holds, then passes that block one hop
around the ring (``collectives.ppermute``, whose backward sends the
cotangent back the other way). The softmax accumulates online, a running
max and a running sum in fp32, so the S x S score matrix is never made.
The block step is plain torch in fp32, as the reference's is plain
``jnp`` that XLA lowers: two einsums, the running max and the running
sum. It is the same math as ``softmax(q kᵀ / sqrt(d)) v`` within fp32
rounding.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import collectives as _coll
from .mesh import Mesh
from .sharding import PartitionSpec

__all__ = ["ring_attention", "ring_attention_sharded",
           "local_attention_block"]


def local_attention_block(q, k, v, m_prev, l_prev, o_prev, *, scale,
                          mask=None):
    """One online-softmax accumulation step (reference :46-66).

    q: [B, H, Sq, D]; k/v: [B, H, Sk, D]; m_prev/l_prev: [B, H, Sq]
    running max and normalizer; o_prev: the unnormalized output
    accumulator [B, H, Sq, D]. Returns (m, l, o)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_new = o_prev * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name: str = "sp", *, causal: bool = False,
                   scale: Optional[float] = None,
                   mesh: Optional[Mesh] = None):
    """Blockwise ring attention over the mesh axis ``axis_name`` on this
    rank's shards q, k, v ``[B, H, S_local, D]`` (the reference's body
    inside ``shard_map``, :69-114). ``mesh`` defaults to the current or
    ambient one. Differentiable through every step and rotation."""
    mesh = _coll._mesh(mesh)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = int(mesh.shape[axis_name])
    my_idx = mesh.coordinate(axis_name)
    B, H, S, D = q.shape
    Sk = k.shape[2]
    m = torch.full((B, H, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    qf = q.float()
    kt, vt = k, v
    # the block held at step t came from member (my_idx + t) % n
    perm = [(i, (i - 1) % n) for i in range(n)]
    q_pos = my_idx * S + torch.arange(S, device=q.device)
    for t in range(n):
        mask = None
        if causal:
            src = (my_idx + t) % n
            k_pos = src * Sk + torch.arange(Sk, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        m, l, o = local_attention_block(qf, kt.float(), vt.float(), m, l, o,
                                        scale=scale, mask=mask)
        if t + 1 < n:
            # the reference's scan also rotates after the last step; that
            # block is never read, so the port leaves the transfer out
            kt = _coll.ppermute(kt, axis_name, perm, mesh)
            vt = _coll.ppermute(vt, axis_name, perm, mesh)
    # fully masked rows (causal, leading tokens on later members) have l=0
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh: Mesh, *, axis_name: str = "sp",
                           causal: bool = False,
                           batch_axes: Sequence[str] = ("dp",)):
    """The entry on global arrays (reference :117-127): q, k, v
    ``[B, H, S, D]`` whole on every rank, split over ``(batch_axes,
    axis_name)``; each rank runs :func:`ring_attention` on its block and
    every rank returns the whole output. Differentiable: with a loss that
    every rank computes alike on the output, each rank gets the whole
    gradient of q, k and v."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis_name!r}")
    b_axes = tuple(a for a in batch_axes if a in mesh.shape)
    spec = PartitionSpec(b_axes or None, None, axis_name, None)
    live = tuple(a for a in b_axes + (axis_name,) if mesh.shape[a] > 1)
    blocks = [_coll.local_block(_coll.copy_to(t, mesh, live), spec, mesh)
              for t in (q, k, v)]
    out = ring_attention(*blocks, axis_name=axis_name, causal=causal,
                         mesh=mesh)
    out = _coll.gather_replicated(out, mesh, (axis_name,), 2)
    return _coll.gather_replicated(out, mesh, b_axes, 0)
