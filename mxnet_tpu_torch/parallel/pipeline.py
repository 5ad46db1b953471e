"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

The reference's schedule is GPipe written as ``lax.scan`` inside
``shard_map``: ``num_microbatches + n_stages - 1`` ticks, every stage
computing each tick on its own weights, the activations moving one stage
a tick with ``ppermute``, the micro-batches filling and draining the
bubble, and the gradient taken by differentiating through the scan. The
port keeps that schedule, tick for tick, on each rank of the ``pp`` axis
(each rank its stage): the forward runs the ticks and sends each tick's
activation to the next stage (``collectives.ppermute``), and the
backward runs the ticks in reverse, each stage's vector-Jacobian product
of its tick and the cotangent sent back one stage, so that every rank
enters every transfer in the same order. The stages run on this device's
kernels (flash attention in the language model's stages).

Two APIs:

- :func:`pipelined` / :func:`pipeline_apply`: identical stages (stage
  params stacked on a leading axis split over ``pp``, a shape-preserving
  stage function);
- :class:`HeteroPipeline`: heterogeneous stages (embed, block stack,
  head) with per-stage functions and parameter trees and boundaries of
  any shape. Each stage's params are flattened into one padded fp32 row,
  the rows stacked into the ``[n_stages, P]`` buffer; activations cross
  stage boundaries in a packed fp32 "wire" as wide as the widest boundary
  (derived once at construction by running each stage on zeros, where
  the reference uses ``jax.eval_shape``). Micro-batch gradient
  accumulation comes with the schedule; ``remat=True`` keeps only each
  tick's input and recomputes the stage in the backward.

Every rank holds the whole ``[n_stages, P]`` buffer as the functional
API's value (``packed_params``, the value the reference's global array
has); :class:`PipelineBlock` under ``Trainer.compile_step`` stores this
rank's row, ``P('pp', None)`` by ``spmd.param_spec``'s name rule.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch

from . import collectives as _coll
from .mesh import Mesh

__all__ = ["pipeline_apply", "pipelined", "stack_stage_params",
           "HeteroPipeline", "PipelineBlock", "bubble_fraction"]

# the largest integer magnitude fp32 holds exactly: the packed wire casts
# every leaf to fp32, so wider values would silently round
_WIRE_EXACT_MAX = 2 ** 24


def bubble_fraction(n_stages: int, num_microbatches: int) -> float:
    """GPipe bubble fraction: the fill/drain steps (``n_stages - 1``) as a
    share of the whole schedule (``num_microbatches + n_stages - 1``)."""
    return (n_stages - 1) / float(num_microbatches + n_stages - 1)


# ---------------------------------------------------------------------------
# trees: dicts (keys sorted), lists and tuples of tensors, as jax's pytrees
# ---------------------------------------------------------------------------
def _flatten(tree, path=""):
    """[(path, leaf)] in jax's order and keystr form, and the structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        pairs, defs = [], []
        for k in keys:
            p, d = _flatten(tree[k], f"{path}['{k}']")
            pairs += p
            defs.append(d)
        return pairs, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        pairs, defs = [], []
        for i, v in enumerate(tree):
            p, d = _flatten(v, f"{path}[{i}]")
            pairs += p
            defs.append(d)
        return pairs, (type(tree), len(tree), tuple(defs))
    return [(path, tree)], None


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, defs = d
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys, defs)}
        return kind(build(sub) for sub in defs)

    return build(treedef)


def _leaves(tree) -> list:
    return [leaf for _p, leaf in _flatten(tree)[0]]


def _map(fn, tree):
    pairs, treedef = _flatten(tree)
    return _unflatten(treedef, [fn(leaf) for _p, leaf in pairs])


def _wide_int(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and \
        dtype != torch.bool and dtype.itemsize >= 4


def _check_wire_tree(tree, where: str, *, allow_abstract_32: bool = False):
    """Refuse leaves the packed fp32 wire cannot carry exactly (reference
    :70-122). Narrow integers always round-trip. Integers of 32 bits or
    more round-trip only below 2**24: concrete leaves are value-checked;
    abstract leaves (``meta`` tensors: stage boundaries, examples given by
    shape) cannot be, so they refuse, except 32-bit example inputs with
    ``allow_abstract_32`` (token ids, far below 2**24)."""
    from ..base import MXNetError

    for path, leaf in _flatten(tree)[0]:
        dt = getattr(leaf, "dtype", torch.float32)
        if not _wide_int(dt):
            continue
        name = path or "<root>"
        dname = str(dt).replace("torch.", "")
        if leaf.device.type != "meta":
            vmax = int(leaf.detach().abs().max()) if leaf.numel() else 0
            if vmax >= _WIRE_EXACT_MAX:
                raise MXNetError(
                    f"HeteroPipeline wire precision: {where} leaf {name} "
                    f"(dtype {dname}) holds |value| {vmax} >= 2**24, which "
                    "the packed fp32 wire cannot represent exactly. Keep "
                    "integer leaves below 2**24 or cast to float32 (or a "
                    "<=16-bit integer) before the pipeline boundary.")
            continue
        if dt.itemsize == 4 and allow_abstract_32:
            continue
        raise MXNetError(
            f"HeteroPipeline wire precision: {where} leaf {name} has "
            f"abstract dtype {dname}; integer values >= 2**24 do not "
            "round-trip through the packed fp32 wire and a "
            f"{'64-bit' if dt.itemsize >= 8 else 'computed'} integer "
            "boundary cannot be bounds-checked at wire-spec derivation "
            "time. Cast to float32 (or a <=16-bit integer) at the stage "
            "boundary.")


def stack_stage_params(per_stage_params):
    """``[{name: tensor}, ...]`` (one dict a stage, one structure) ->
    ``{name: tensor stacked on a new leading stage axis}`` (split dim 0
    over ``pp``)."""
    keys = per_stage_params[0].keys()
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in keys}


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
class _Schedule(torch.autograd.Function):
    """The GPipe ticks of this rank's stage (see the module docstring).

    ``run(j, params, act, extras)`` runs stage ``j`` on one micro-batch;
    ``feeds`` are stage 0's inputs, one a micro-batch; the output is the
    last stage's output a micro-batch, stacked, on every member of the
    axis (the reference's masked ``psum``, whose cotangent every member
    then holds alike: the backward hands it to the last stage). The
    backward returns the gradients of ``pbuf`` and, where they need them,
    of the feeds; extras get none."""

    @staticmethod
    def forward(ctx, pbuf, feeds, spec, *extras):
        run, mesh, axis, remat, zero_act, grad = spec
        n, idx = _axis_index(mesh, axis)
        M = feeds.shape[0]
        ctx.spec, ctx.n, ctx.idx, ctx.M = spec, n, idx, M
        ctx.save = grad and not remat
        fwd = [(i, (i + 1) % n) for i in range(n)]
        buf = zero_act
        ins, outs_t, recorded = [], [], [None] * M
        pl = pbuf.detach().requires_grad_(pbuf.requires_grad)
        for t in range(M + n - 1):
            cur = feeds[min(t, M - 1)] if idx == 0 else buf
            ex = [e[min(max(t - idx, 0), M - 1)] for e in extras]
            if ctx.save:
                with torch.enable_grad():
                    cl = cur.detach().requires_grad_(
                        idx != 0 or feeds.requires_grad)
                    act = run(idx, pl, cl, ex)
                ins.append(cl)
                outs_t.append(act)
            else:
                with torch.no_grad():
                    act = run(idx, pl.detach(), cur, ex)
                ins.append(cur.detach())
            slot = t - (n - 1)
            if idx == n - 1 and slot >= 0:
                recorded[slot] = act.detach()
            if n > 1 and t + 1 < M + n - 1:
                buf = _coll._ppermute(act.detach(), axis, fwd, mesh)
        if idx == n - 1:
            out = torch.stack(recorded)
        else:
            out = torch.zeros((M,) + tuple(zero_act.shape),
                              dtype=zero_act.dtype, device=zero_act.device)
        if n > 1:
            out = _coll.all_reduce(out, axis, mesh=mesh)
        ctx.ins, ctx.outs_t, ctx.pl, ctx.extras = ins, outs_t, pl, extras
        ctx.feeds_grad = feeds.requires_grad
        ctx.feeds_shape = feeds.shape
        return out

    @staticmethod
    def backward(ctx, g_out):
        run, mesh, axis, _remat, zero_act, _grad = ctx.spec
        n, idx, M = ctx.n, ctx.idx, ctx.M
        pl = ctx.pl
        back = [((i + 1) % n, i) for i in range(n)]
        g_p = torch.zeros_like(pl) if pl.requires_grad else None
        g_feeds = torch.zeros(ctx.feeds_shape, dtype=zero_act.dtype,
                              device=zero_act.device) \
            if ctx.feeds_grad else None
        g_recv = torch.zeros_like(zero_act)
        for t in reversed(range(M + n - 1)):
            g_act = g_recv
            slot = t - (n - 1)
            if idx == n - 1 and slot >= 0:
                g_act = g_act + g_out[slot]
            cl = ctx.ins[t]
            if ctx.save:
                act = ctx.outs_t[t]
            else:
                ex = [e[min(max(t - idx, 0), M - 1)] for e in ctx.extras]
                with torch.enable_grad():
                    cl = cl.requires_grad_(idx != 0 or ctx.feeds_grad)
                    act = run(idx, pl, cl, ex)
            wrt = [x for x in (cl, pl) if x.requires_grad]
            gs = torch.autograd.grad(act, wrt, g_act, allow_unused=True)
            gs = dict(zip(map(id, wrt), gs))
            g_cur = gs.get(id(cl))
            g_pt = gs.get(id(pl))
            if g_pt is not None:
                g_p += g_pt
            if idx == 0:
                if g_feeds is not None and g_cur is not None:
                    g_feeds[min(t, M - 1)] += g_cur
                g_cur = None
            if n > 1 and t > 0:
                send = torch.zeros_like(zero_act) if g_cur is None \
                    else g_cur.contiguous()
                g_recv = _coll._ppermute(send, axis, back, mesh)
        ctx.ins = ctx.outs_t = ctx.extras = None
        return (g_p, g_feeds, None) + (None,) * (len(ctx.needs_input_grad)
                                                 - 3)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _axis_index(mesh, axis) -> Tuple[int, int]:
    n = int(mesh.shape.get(axis, 1))
    return n, (mesh.coordinate(axis) if n > 1 else 0)


def pipeline_apply(stage_fn: Callable, stacked_params, x, *,
                   num_microbatches: int, axis_name: str = "pp",
                   mesh: Mesh = None):
    """Run ``stage_fn(params, act) -> act`` through every pipeline stage,
    on this rank's stage (reference :157-203, the body inside
    ``shard_map``): ``stacked_params`` leaves have a leading stage dim of
    1 (this rank's stage's block), ``x`` is the whole batch ``[B, ...]``
    (only stage 0 reads it). Returns the last stage's output on every
    rank. Differentiable with respect to the params and ``x``."""
    mesh = _coll._mesh(mesh)
    keys = sorted(stacked_params)
    local = [stacked_params[k][0] for k in keys]
    shapes = [tuple(t.shape) for t in local]
    sizes = [math.prod(s) for s in shapes]
    pbuf = torch.cat([t.reshape(-1) for t in local])
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} must divide num_microbatches "
                         f"{num_microbatches}")
    micro = x.reshape((num_microbatches, B // num_microbatches)
                      + tuple(x.shape[1:]))

    def run(_j, p, act, _ex):
        parts = torch.split(p, sizes)
        return stage_fn({k: t.view(s) for k, t, s in
                         zip(keys, parts, shapes)}, act)

    zero = torch.zeros_like(micro[0])
    out = _Schedule.apply(pbuf, micro, (run, mesh, axis_name, False, zero,
                                        _needs_grad(pbuf, micro)))
    return out.reshape((B,) + tuple(x.shape[1:]))


def pipelined(stage_fn: Callable, mesh: Mesh, *, num_microbatches: int,
              axis_name: str = "pp", param_spec=None, x_spec=None):
    """The entry on global arrays (reference :206-219): the stacked params
    split over ``pp`` on dim 0, the input whole on every rank, the output
    whole on every rank. With a loss every rank computes alike on the
    output, each rank gets the whole gradient of the stacked params."""
    from .sharding import PartitionSpec

    def fn(stacked, x):
        n, _idx = _axis_index(mesh, axis_name)
        live = (axis_name,) if n > 1 else ()
        local = {}
        for k, a in stacked.items():
            spec = PartitionSpec(axis_name) if param_spec is None else \
                param_spec[k]
            local[k] = _coll.local_block(_coll.copy_to(a, mesh, live), spec,
                                         mesh)
        return pipeline_apply(stage_fn, local, x,
                              num_microbatches=num_microbatches,
                              axis_name=axis_name, mesh=mesh)

    return fn


# ---------------------------------------------------------------------------
# heterogeneous pipeline
# ---------------------------------------------------------------------------
def _pack_spec(tree, batched: bool):
    """(structure, [(shape, dtype, offset, size)], total): each leaf's
    place in a flat fp32 row (``batched``: per sample, dim 0 dropped)."""
    pairs, treedef = _flatten(tree)
    specs, off = [], 0
    for _p, leaf in pairs:
        shape = tuple(leaf.shape[1:] if batched else leaf.shape)
        n = math.prod(shape)
        specs.append((shape, leaf.dtype, off, n))
        off += n
    return treedef, specs, off


def _pack(tree, size: int, device) -> torch.Tensor:
    """A tree flattened into one fp32 row padded to ``size``; integer
    leaves are cast by value (exact below 2**24)."""
    leaves = _leaves(tree)
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves]) \
        if leaves else torch.zeros((0,), device=device)
    return torch.nn.functional.pad(flat, (0, size - flat.shape[0]))


class _Unpack(torch.autograd.Function):
    """A packed row's leaves (copies, in their dtypes), whose backward
    packs the leaves' cotangents into one row: one pass over the row,
    where slicing it once a leaf would make a row-sized gradient a leaf."""

    @staticmethod
    def forward(ctx, buf, specs):
        ctx.specs, ctx.size, ctx.device = specs, buf.shape[0], buf.device
        out = tuple(buf[off:off + n].view(shape).to(dtype, copy=True)
                    for shape, dtype, off, n in specs)
        ctx.mark_non_differentiable(*[t for t in out
                                      if not t.is_floating_point()])
        return out

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            torch.zeros(n, dtype=torch.float32, device=ctx.device)
            if g is None else g.reshape(-1).float()
            for (_s, _d, _o, n), g in zip(ctx.specs, grads)])
        return torch.nn.functional.pad(flat, (0, ctx.size - flat.shape[0])), \
            None


def _unpack(buf, treedef, specs):
    if not specs:
        return _unflatten(treedef, [])
    if not (torch.is_grad_enabled() and buf.requires_grad):
        return _unflatten(treedef, [
            buf[off:off + n].view(shape).to(dtype)
            for shape, dtype, off, n in specs])
    return _unflatten(treedef, list(_Unpack.apply(buf, tuple(specs))))


def _batched_pack(tree, size: int) -> torch.Tensor:
    leaves = _leaves(tree)
    B = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(B, -1).float() for leaf in leaves], 1)
    return torch.nn.functional.pad(flat, (0, size - flat.shape[1]))


def _batched_unpack(buf, treedef, specs):
    B = buf.shape[0]
    return _unflatten(treedef, [
        buf[:, off:off + n].reshape((B,) + shape).to(dtype)
        for shape, dtype, off, n in specs])


class HeteroPipeline:
    """GPipe pipeline with heterogeneous stages over the ``pp`` mesh axis
    (reference :289-521).

    Parameters
    ----------
    stage_fns : one ``fn(stage_params, act, *extras) -> act`` a stage;
        ``act`` is a tree of tensors with a leading (micro-)batch dim, and
        the boundaries may differ in shape. ``extras`` are per-micro-batch
        side inputs (labels) handed to every stage for the micro-batch
        that stage is on.
    stage_params : one tree a stage (structures may differ).
    mesh : a mesh whose ``pp`` axis has ``len(stage_fns)`` members (a
        ``dp`` axis, if present, splits every batch dim).
    num_microbatches : the micro-batch count (must divide the batch).
    example_x / example_extras : trees of tensors (``meta`` tensors give
        a shape and dtype only) from which the wire is derived once.
    remat : recompute each stage call in the backward.
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any], mesh: Mesh, *,
                 num_microbatches: int, example_x: Any,
                 example_extras: Tuple[Any, ...] = (),
                 axis_name: str = "pp", batch_axis: str = "dp",
                 remat: bool = False):
        n = len(stage_fns)
        if n != len(stage_params):
            raise ValueError("one param tree a stage")
        if int(mesh.shape.get(axis_name, 1)) != n:
            raise ValueError(
                f"mesh axis '{axis_name}' (size "
                f"{mesh.shape.get(axis_name, 1)}) must equal the number of "
                f"stages ({n})")
        self.stage_fns = list(stage_fns)
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis if batch_axis in mesh.shape else None
        self.num_microbatches = num_microbatches
        self.n_stages = n
        self.remat = remat
        self.device = mesh.device
        # every stage's params and every boundary cross the fp32 wire:
        # refuse here the leaves it cannot carry exactly
        for j, p in enumerate(stage_params):
            _check_wire_tree(p, f"stage {j} param")
        _check_wire_tree(example_x, "pipeline input (example_x)",
                         allow_abstract_32=True)
        self._p_specs = [_pack_spec(p, False) for p in stage_params]
        self._p_size = max(s[2] for s in self._p_specs) or 1
        # leaf paths a stage, in pack order: where a named leaf sits in its
        # stage's row (weight tying)
        self._p_paths = [[path for path, _l in _flatten(p)[0]]
                         for p in stage_params]
        self.packed_params = torch.stack([
            _pack(p, self._p_size, self.device).to(self.device)
            for p in stage_params])
        dp = int(mesh.shape.get(batch_axis, 1)) if self.batch_axis else 1
        B = _leaves(example_x)[0].shape[0]
        if B % (num_microbatches * dp):
            raise ValueError(f"batch {B} must divide num_microbatches*dp "
                             f"({num_microbatches}x{dp})")
        mb = B // (num_microbatches * dp)
        self._example_extras = tuple(example_extras)

        def zeros_mb(tree):
            return _map(lambda leaf: torch.zeros(
                (mb,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                device=self.device), tree)

        extras_mb = tuple(zeros_mb(e) for e in example_extras)
        boundary = zeros_mb(example_x)
        self._b_specs = []
        with torch.no_grad():
            for j, fn in enumerate(self.stage_fns):
                self._b_specs.append(_pack_spec(boundary, True))
                params = _unpack(self.packed_params[j], *self._p_specs[j][:2])
                out = fn(params, boundary, *extras_mb)
                # a computed boundary is abstract: a wide-int one refuses
                _check_wire_tree(_map(lambda leaf: leaf.to("meta"), out),
                                 f"stage {j} output boundary")
                boundary = out
        self._out_spec = _pack_spec(boundary, True)
        self._w_size = max([s[2] for s in self._b_specs]
                           + [self._out_spec[2]])
        self._mb = mb

    # -- params ------------------------------------------------------------
    def unpack_stage_params(self, packed=None) -> List[Any]:
        """``[n_stages, P]`` buffer -> the per-stage param trees."""
        if packed is None:
            packed = self.packed_params
        return [_unpack(packed[j], treedef, specs)
                for j, (treedef, specs, _n) in enumerate(self._p_specs)]

    def leaf_slice(self, stage: int, key: str) -> Tuple[int, int]:
        """(offset, size) of the named leaf in stage ``stage``'s packed row
        (``key`` matched as the last path component)."""
        want = f"['{key}']"
        for path, (_shape, _dt, off, n) in zip(self._p_paths[stage],
                                               self._p_specs[stage][1]):
            if path == want or path.endswith(want):
                return off, n
        raise KeyError(f"no leaf matching {key!r} in stage {stage}: "
                       f"{self._p_paths[stage]}")

    def tie_grads(self, grads, ties):
        """Sum the gradient slices of weight-tied leaves on different
        stages and write the sum back to every member (the tied embedding
        and head). ``grads`` is a whole ``[n_stages, P]`` cotangent;
        ``ties`` an iterable of ``((stage, key), (stage, key), ...)``
        groups. Returns a new tensor."""
        grads = grads.clone()
        for group in ties:
            slices = [self.leaf_slice(s, k) for s, k in group]
            n = slices[0][1]
            if any(sz != n for _o, sz in slices):
                raise ValueError("tied leaves differ in size")
            total = sum(grads[s, off:off + n]
                        for (s, _k), (off, _n) in zip(group, slices))
            for (s, _k), (off, _n) in zip(group, slices):
                grads[s, off:off + n] = total
        return grads

    # -- forward -------------------------------------------------------------
    def _run_stage(self, j, pbuf, wire_in, extras_mb):
        params = _unpack(pbuf, *self._p_specs[j][:2])
        act = _batched_unpack(wire_in, *self._b_specs[j][:2])
        out = self.stage_fns[j](params, act, *extras_mb)
        return _batched_pack(out, self._w_size)

    def apply(self, packed_params, x, *extras):
        """The whole pipeline: ``x`` ``[B, ...]`` -> the last stage's
        outputs ``[B, ...]``, the same on every rank (micro-batching is
        internal). ``packed_params`` is the whole ``[n_stages, P]`` buffer.
        Differentiable with respect to ``packed_params`` and ``x``: with a
        loss every rank computes alike on the output, each rank gets the
        whole gradients. Inside a step that already split the batch over
        ``dp`` (``spmd.data_parallel``), ``x`` and ``extras`` are this
        rank's rows and the outputs too, and summing the gradients over
        ``dp`` is the step's."""
        from . import spmd as _spmd

        mesh, axis = self.mesh, self.axis_name
        n, idx = _axis_index(mesh, axis)
        dp_axes = () if self.batch_axis is None else \
            _coll._live(mesh, self.batch_axis)
        split = bool(dp_axes) and self.batch_axis not in \
            _spmd.active_batch_axes()
        live = _coll._live(mesh, (axis,) + (dp_axes if split else ()))
        pbuf = _coll.copy_to(packed_params, mesh, live)[idx]
        x = _map(lambda t: _coll.copy_to(t, mesh, live), x)
        if split:
            x = _map(lambda t: _spmd.local_rows(t, mesh, dp_axes), x)
            extras = tuple(_map(lambda t: _spmd.local_rows(t, mesh, dp_axes),
                                e) for e in extras)
        M = self.num_microbatches
        B = _leaves(x)[0].shape[0]
        mb = B // M
        if mb * M != B or mb != self._mb:
            raise ValueError(f"this rank's batch of {B} rows does not make "
                             f"{M} micro-batches of {self._mb} (the wire's)")

        def to_micro(tree):
            return _map(lambda t: t.reshape((M, mb) + tuple(t.shape[1:])),
                        tree)

        xm = to_micro(x)
        feeds = torch.stack([_batched_pack(_map(lambda t: t[i], xm),
                                           self._w_size) for i in range(M)])
        ex = [leaf for e in extras for leaf in _leaves(to_micro(e))]
        ex_def = [_flatten(to_micro(e))[1] for e in extras]
        counts = [len(_leaves(e)) for e in extras]

        def run(j, p, wire, ex_leaves):
            parts, k = [], 0
            for d, c in zip(ex_def, counts):
                parts.append(_unflatten(d, ex_leaves[k:k + c]))
                k += c
            return self._run_stage(j, p, wire, parts)

        zero = torch.zeros((mb, self._w_size), dtype=torch.float32,
                           device=feeds.device)
        out_wire = _Schedule.apply(
            pbuf, feeds, (run, mesh, axis, self.remat, zero,
                          _needs_grad(pbuf, feeds)), *ex)
        outs = [_batched_unpack(out_wire[i], *self._out_spec[:2])
                for i in range(M)]
        pairs0, treedef = _flatten(outs[0])
        leaves = [torch.cat([_leaves(o)[k] for o in outs])
                  for k in range(len(pairs0))]
        if split:
            leaves = [_coll.gather_replicated(t, mesh, dp_axes, 0)
                      for t in leaves]
        return _unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# Gluon adapter
# ---------------------------------------------------------------------------
_PIPELINE_BLOCK_CLS = None


def _pipeline_block_cls():
    """Build the PipelineBlock class at first use: importing Gluon here,
    not at module import, keeps ``mxnet_tpu_torch.parallel`` free of an
    import cycle through the Gluon package."""
    global _PIPELINE_BLOCK_CLS
    if _PIPELINE_BLOCK_CLS is not None:
        return _PIPELINE_BLOCK_CLS

    from ..gluon.block import Block
    from ..gluon.parameter import Parameter

    class PipelineBlock(Block):
        """A :class:`HeteroPipeline` as a Gluon block (reference
        :544-596): one trainable parameter, the packed ``[n_stages, P]``
        fp32 stage buffer named ``pp_stages``, so that
        ``Trainer.compile_step`` runs the pipeline's schedule inside its
        one program a step (N + 1 a window under accumulation). On a mesh
        with a ``pp`` axis above 1, ``spmd.param_spec`` places it
        ``P('pp', None)`` (rank i holds stage i's row) and the optimizer
        updates it elementwise in packed space. The gradients of tied
        leaves (``pipe.tied``) are summed over their stages by
        :meth:`compiled_grad_transform`, which the step applies after its
        backward. The batch shape is the wire's, fixed at the pipeline's
        construction."""

        def __init__(self, pipe: HeteroPipeline):
            super().__init__()
            self._pipe = pipe
            self.pp_stages = Parameter(
                "pp_stages", shape=tuple(pipe.packed_params.shape),
                dtype="float32")
            # the value is the packed buffer itself
            self.pp_stages._set_leaf(pipe.packed_params.detach().clone())

        @property
        def pipe(self) -> HeteroPipeline:
            return self._pipe

        def unpack_stage_params(self):
            """The per-stage param trees of the current value (the
            pipeline's ``packed_params`` keeps the initial buffer)."""
            return self._pipe.unpack_stage_params(
                self.pp_stages.data().detach())

        def compiled_grad_transform(self, named_grads):
            """The step's gradient hook: the tied leaves' gradient slices
            summed over their stages, on the whole packed cotangent.
            Linear, so applying it to each micro-batch under accumulation
            equals applying it to the window's sum."""
            ties = getattr(self._pipe, "tied", ())
            if not ties:
                return named_grads
            out = dict(named_grads)
            for name, g in named_grads.items():
                if name == "pp_stages" or name.endswith(".pp_stages"):
                    out[name] = self._pipe.tie_grads(g, ties)
            return out

        def forward(self, x, *extras):
            return self._pipe.apply(self.pp_stages.data(), x, *extras)

    _PIPELINE_BLOCK_CLS = PipelineBlock
    return _PIPELINE_BLOCK_CLS


def __getattr__(name):
    if name == "PipelineBlock":
        return _pipeline_block_cls()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
