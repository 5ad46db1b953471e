"""Named collectives over mesh axes (counterpart of
``mxnet_tpu/parallel/collectives.py``).

The reference names ``jax.lax`` collectives after the KVStore's reduce and
broadcast and runs them inside ``shard_map`` regions. In the port every
rank of the ``torch.distributed`` world holds its local shard, so a
function body runs "inside ``shard_map``" as it stands: an ``axis_name``
is the process group of that ``DeviceMesh`` dimension (``Mesh.group``), of
the mesh given, else the current one (``mesh_scope``), else the ambient
one (``with mesh:``). These functions always call the backend, also over
an axis of size 1 (the card's mesh of one checks NCCL that way, eager and
inside a CUDA graph capture); the train steps elide axes of size 1 on
their own (``spmd``), as XLA does. A mesh without a world (one device)
has no group: each collective is then its one-rank definition.

:func:`run_sharded` / :func:`shard_map` take the global arrays, hand each
rank its shard by ``in_specs``, run the body, and assemble the global
outputs by ``out_specs`` with all-gathers, so that every rank returns what
``jax.shard_map`` returns.

:func:`gather_rows` and :func:`all_reduce_sum` are the differentiable
forms the steps use: the rows of a batch gathered over its axes (backward:
a reduce-scatter of the cotangent), and a sum whose backward is the same
sum (batch-norm statistics). :func:`gather_dim`,
:func:`gather_replicated`, :func:`copy_to` and :func:`reduce_from` are
the forms of the language model's mesh step, ring attention and the
pipeline: every rank there computes the same replicated loss and seeds
its cotangent 1, so a sum whose output all members then use alike passes
the cotangent back as it is (Megatron's ``g``), and a value all members
hold alike but compute on differently sums its cotangent over them
(Megatron's ``f``). :func:`ppermute` and :func:`ring_shift` are
differentiable: the backward runs the inverse permutation.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .mesh import Mesh, _AMBIENT, current_mesh

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute",
    "ring_shift", "axis_index", "axis_size", "broadcast_from", "pmean",
    "run_sharded", "shard_map", "gather_rows", "gather_dim",
    "gather_replicated", "copy_to", "reduce_from", "all_reduce_sum",
]


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is None:
        mesh = current_mesh() or (_AMBIENT[-1] if _AMBIENT else None)
    if mesh is None:
        raise ValueError("no mesh: pass mesh=, or call inside "
                         "mesh_scope(mesh) or `with mesh:`")
    return mesh


def _dist():
    import torch.distributed as dist

    return dist


def _as_axes(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x, axis_name, op: str = "sum", mesh: Optional[Mesh] = None):
    """CommDevice::Reduce + Broadcast fused: one all-reduce (``sum``,
    ``mean``, ``max`` or ``min``) over ``axis_name`` (an axis or a tuple
    of axes)."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce op {op}")
    mesh = _mesh(mesh)
    out = x.clone()
    n = 1
    for a in _as_axes(axis_name):
        g = mesh.group(a)
        n *= mesh.shape[a]
        if g is not None:
            dist = _dist()
            dist.all_reduce(out, op=getattr(
                dist.ReduceOp, _OPS.get(op, "SUM")), group=g)
    return out / n if op == "mean" else out


def pmean(x, axis_name, mesh: Optional[Mesh] = None):
    return all_reduce(x, axis_name, "mean", mesh)


def _gather_one(x, mesh: Mesh, axis: str, dim: int):
    g = mesh.group(axis)
    if g is None:
        return x.clone()
    n = mesh.shape[axis]
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist = _dist()
    # the newer names where the torch has them (the older ones warn there)
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, xm, group=g)
    return out.movedim(0, dim)


def _scatter_one(x, mesh: Mesh, axis: str, dim: int):
    g = mesh.group(axis)
    if g is None:
        return x.clone()
    n = mesh.shape[axis]
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways over {axis!r}")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist = _dist()
    scatter = getattr(dist, "reduce_scatter_single",
                      dist.reduce_scatter_tensor)
    scatter(out, xm, group=g)
    return out.movedim(0, dim)


def all_gather(x, axis_name, axis: int = 0, tiled: bool = True,
               mesh: Optional[Mesh] = None):
    """The shards of ``axis_name`` concatenated along ``axis``
    (``tiled=True``), or stacked on a new leading ``axis``. A tuple of
    axes gathers the last (innermost) first, so the first varies
    slowest."""
    mesh = _mesh(mesh)
    d = axis % (x.dim() + (0 if tiled else 1))
    out = x if tiled else x.unsqueeze(d)
    for a in reversed(_as_axes(axis_name)):
        out = _gather_one(out, mesh, a, d)
    return out


def reduce_scatter(x, axis_name, axis: int = 0,
                   mesh: Optional[Mesh] = None):
    """``psum_scatter(tiled=True)``: the sum over ``axis_name``, split
    along ``axis``, this rank keeping its chunk."""
    mesh = _mesh(mesh)
    d = axis % x.dim()
    out = x
    for a in _as_axes(axis_name):
        out = _scatter_one(out, mesh, a, d)
    return out


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               mesh: Optional[Mesh] = None):
    """``lax.all_to_all(tiled=True)``: ``x`` split into n chunks along
    ``split_axis``, chunk j sent to member j, the chunks received
    concatenated along ``concat_axis`` in member order."""
    mesh = _mesh(mesh)
    g = mesh.group(axis_name)
    n = mesh.shape[axis_name]
    s = split_axis % x.dim()
    c = concat_axis % x.dim()
    if x.shape[s] % n:
        raise ValueError(f"all_to_all: dim {s} of {tuple(x.shape)} does "
                         f"not split {n} ways over {axis_name!r}")
    chunks = x.movedim(s, 0).reshape((n, x.shape[s] // n)
                                     + tuple(x.movedim(s, 0).shape[1:]))
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    if g is None:
        recv.copy_(send)
    else:
        _dist().all_to_all_single(recv, send, group=g)
    # recv[j] is member j's chunk (split dim leading): put the split dim
    # back, then lay the members side by side along concat_axis
    parts = [p.movedim(0, s) for p in recv.unbind(0)]
    return torch.cat(parts, dim=c)


class _PPermute(torch.autograd.Function):
    """``ppermute`` whose backward sends the cotangent back along the
    inverse permutation (``lax.ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, x, axis_name, pairs, mesh):
        ctx.axis_name, ctx.pairs, ctx.mesh = axis_name, pairs, mesh
        return _ppermute(x, axis_name, pairs, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.pairs]
        return (_ppermute(g.contiguous(), ctx.axis_name, inverse, ctx.mesh),
                None, None, None)


def ppermute(x, axis_name: str, perm, mesh: Optional[Mesh] = None):
    """``lax.ppermute``: member ``src`` sends its ``x`` to member ``dst``
    for every ``(src, dst)`` of ``perm``; a member no pair sends to gets
    zeros. Differentiable: the backward sends the cotangent along the
    inverse pairs."""
    mesh = _mesh(mesh)
    pairs = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, axis_name, pairs, mesh)
    return _ppermute(x, axis_name, pairs, mesh)


def _ppermute(x, axis_name: str, pairs, mesh: Mesh):
    g = mesh.group(axis_name)
    me = mesh.coordinate(axis_name)
    out = torch.zeros_like(x)
    if g is None:
        for s, d in pairs:
            if s == me and d == me:
                out.copy_(x)
        return out
    dist = _dist()
    ops = []
    send = x.contiguous()
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(g, d), g))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(g, s), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_shift(x, axis_name: str, shift: int = 1, *,
               size: Optional[int] = None, mesh: Optional[Mesh] = None):
    """Rotate the shards ``shift`` places around the ring of
    ``axis_name``."""
    mesh = _mesh(mesh)
    if size is None:
        size = mesh.shape[axis_name]
    perm = [(i, (i + shift) % size) for i in range(size)]
    return ppermute(x, axis_name, perm, mesh)


def axis_index(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's coordinate along ``axis_name``."""
    return _mesh(mesh).coordinate(axis_name)


def axis_size(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    return int(_mesh(mesh).shape[axis_name])


def broadcast_from(x, axis_name: str, src: int = 0,
                   mesh: Optional[Mesh] = None):
    """KVStore Broadcast: every member gets member ``src``'s ``x``, as the
    reference's masked all-reduce (a select, not a multiply, so that
    another member's inf or NaN cannot reach the sum)."""
    is_src = axis_index(axis_name, mesh) == src
    return all_reduce(x if is_src else torch.zeros_like(x), axis_name,
                      mesh=mesh)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
def _spec_dims(spec, ndim: int):
    padded = (tuple(spec or ()) + (None,) * ndim)[:ndim]
    return [() if a is None else _as_axes(a) for a in padded]


def local_block(x, spec, mesh: Mesh):
    """This rank's block of the global ``x`` under ``spec`` (a tuple of
    axis names or tuples of them, None for a whole dim)."""
    out = x
    for d, axes in enumerate(_spec_dims(spec, x.dim())):
        for a in axes:
            n = mesh.shape[a]
            if n > 1:
                out = out.chunk(n, dim=d)[mesh.coordinate(a)] \
                    if out.shape[d] % n == 0 else _refuse(out, d, a, n)
    return out


def _refuse(x, d, a, n):
    raise ValueError(f"dim {d} of {tuple(x.shape)} does not split {n} ways "
                     f"over {a!r}")


def global_from_blocks(x, spec, mesh: Mesh):
    """The global array whose ``spec`` blocks the ranks hold (an
    all-gather a sharded dim)."""
    out = x
    for d, axes in enumerate(_spec_dims(spec, x.dim())):
        for a in reversed(axes):
            if mesh.shape[a] > 1:
                out = _gather_one(out, mesh, a, d)
    return out


def run_sharded(fn: Callable, mesh: Mesh, in_specs, out_specs,
                check_vma: bool = False):
    """``fn`` over each rank's shards (reference :103-111): the returned
    function takes the global arrays, passes ``fn`` its blocks by
    ``in_specs`` inside ``mesh_scope(mesh)``, and returns the global
    outputs by ``out_specs`` (a spec or a tuple of specs), the same on
    every rank."""
    from .mesh import mesh_scope

    def wrapped(*args):
        specs = (in_specs,) * len(args) if _is_spec(in_specs) \
            else tuple(in_specs)
        blocks = [local_block(a, s, mesh) if isinstance(a, torch.Tensor)
                  else a for a, s in zip(args, specs)]
        with mesh_scope(mesh):
            out = fn(*blocks)
        if isinstance(out, (tuple, list)):
            outs = out_specs if not _is_spec(out_specs) \
                else (out_specs,) * len(out)
            return type(out)(global_from_blocks(o, s, mesh)
                             for o, s in zip(out, outs))
        return global_from_blocks(out, out_specs, mesh)

    return wrapped


def _is_spec(s) -> bool:
    """One spec (a ``PartitionSpec`` or None), not a tuple of them."""
    from .sharding import PartitionSpec

    return s is None or isinstance(s, PartitionSpec)


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs,
              check_vma: bool = False):
    """:func:`run_sharded` under ``jax.shard_map``'s name."""
    return run_sharded(fn, mesh, in_specs, out_specs, check_vma)


# ---------------------------------------------------------------------------
# differentiable forms (the steps' batch gather and statistics)
# ---------------------------------------------------------------------------
def _live(mesh: Mesh, axes) -> tuple:
    return tuple(a for a in _as_axes(axes) if mesh.shape.get(a, 1) > 1)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` whose backward sums the cotangent over the
    members and keeps this rank's block (a reduce-scatter): for a value
    each member then computes on differently."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        out = x
        for a in reversed(axes):
            out = _gather_one(out, mesh, a, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous()
        for a in ctx.axes:
            out = _scatter_one(out, ctx.mesh, a, ctx.dim)
        return out, None, None, None


def gather_rows(x, mesh: Mesh, axes: Sequence[str]):
    """The batch rows of every member of ``axes`` concatenated (the first
    axis slowest), differentiably: the backward sums the cotangent over
    the members and keeps this rank's rows (a reduce-scatter). Axes of
    size 1 are elided."""
    return gather_dim(x, mesh, axes, 0)


def gather_dim(x, mesh: Mesh, axes, dim: int):
    """The blocks of every member of ``axes`` concatenated along ``dim``
    (the first axis slowest), differentiably, with :func:`gather_rows`'
    backward. Axes of size 1 are elided."""
    axes = _live(mesh, axes)
    if not axes or not isinstance(x, torch.Tensor):
        return x
    return _Gather.apply(x, mesh, axes, dim % x.dim())


class _GatherSlice(torch.autograd.Function):
    """All-gather along ``dim`` whose backward keeps this rank's block of
    the cotangent: for a value every member then computes on alike (a
    replicated loss)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        out = x
        for a in reversed(axes):
            out = _gather_one(out, mesh, a, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g
        for a in ctx.axes:
            n = ctx.mesh.shape[a]
            out = out.chunk(n, dim=ctx.dim)[ctx.mesh.coordinate(a)]
        return out.contiguous(), None, None, None


def gather_replicated(x, mesh: Mesh, axes, dim: int):
    """:func:`gather_dim` for a value that every member then uses alike:
    the backward keeps this rank's block of the (equal) cotangents
    instead of summing them. Axes of size 1 are elided."""
    axes = _live(mesh, axes)
    if not axes or not isinstance(x, torch.Tensor):
        return x
    return _GatherSlice.apply(x, mesh, axes, dim % x.dim())


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a value the members
    hold alike, which each then computes on differently (Megatron's
    ``f``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.axes, mesh=ctx.mesh), None, None


def copy_to(x, mesh: Mesh, axes):
    """``x`` itself, whose gradient is summed over the members of ``axes``
    in the backward. Axes of size 1 are elided."""
    axes = _live(mesh, axes)
    if not axes or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, mesh, axes)


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: partial values summed
    into one that every member then uses alike (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x, mesh: Mesh, axes):
    """The sum of ``x`` over the members of ``axes``, for a value every
    member then uses alike: the backward hands each member the cotangent
    as it is. Axes of size 1 are elided."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFrom.apply(x, mesh, axes)
    return all_reduce(x, axes, mesh=mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.axes, mesh=ctx.mesh), None, None


def all_reduce_sum(x, mesh: Mesh, axes: Sequence[str]):
    """The sum of ``x`` over the members of ``axes``, differentiably (the
    backward is the same sum of the cotangent). Axes of size 1 are
    elided."""
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return x
    return _AllReduceSum.apply(x, mesh, axes)
