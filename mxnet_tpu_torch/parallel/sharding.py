"""Sharding plans: parameter-name patterns to partition specs (counterpart
of ``mxnet_tpu/parallel/sharding.py``).

A :class:`ShardingPlan` is an ordered rule list matched against the
structural parameter name, yielding a :class:`PartitionSpec`. A rule that
does not divide the shape falls back to replication on the offending
dim, counted and, on the :func:`constraint` path, warned once
(:func:`legalize_refusal_count`), as the reference's ``_legalize``.

Where the reference places a global ``jax.Array`` with a
``NamedSharding``, the port keeps each rank's block: :func:`shard_array`
returns this rank's block of a global tensor (``spmd.gather_full`` the
global tensor back). The spec functions take any mesh that has
``.shape``.

:func:`constraint` legalizes its spec as the reference's does. The axes of
the batch of the step it runs in (``spmd.data_parallel``) are already real
there, since each rank holds its rows; another axis above 1 (``tp``) is
made real through DTensor: the tensor is redistributed to the spec's
``Shard`` placements over that axis's sub-mesh, and the torch ops that
follow run on the DTensor (the steps enter
``torch.distributed.tensor.experimental.implicit_replication`` around
their forward and backward, and turn a DTensor output or gradient back
into a full local tensor). The port's hand-written kernels take local
tensors only and raise on a DTensor.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, List, Sequence, Tuple, Union

import torch

from .. import telemetry as _telemetry
from . import collectives as _coll

__all__ = ["PartitionSpec", "NamedSharding", "ShardingPlan", "fsdp_plan",
           "tensor_parallel_plan", "expert_parallel_plan", "replicated_plan",
           "shard_array", "constraint",
           "legalize_refusal_count", "reset_legalize_refusals"]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per dim, an axis name, a tuple of
    names (the first varying slowest) or None (whole)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            tuple(a) if isinstance(a, list) else a for a in axes))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


Spec = PartitionSpec


class NamedSharding:
    """A spec on a mesh (what the reference's ``NamedSharding`` pairs)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


_LEGALIZE_REFUSAL = _telemetry.counter(
    "sharding.legalize_refusal",
    "spec dims refused (degraded to replication) because the shape "
    "could not divide the mesh axis evenly")
_WARNED_REFUSALS: set = set()


def legalize_refusal_count() -> int:
    return int(_LEGALIZE_REFUSAL.value)


def reset_legalize_refusals() -> None:
    _LEGALIZE_REFUSAL.reset()


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, (tuple, list)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axes]


def _legalize(spec, shape: Tuple[int, ...], mesh,
              loud: bool = False) -> PartitionSpec:
    """Drop sharding on dims the shape cannot divide evenly and on axes the
    mesh does not have (reference :63-102). Divisibility refusals are
    counted and, with ``loud``, warned once per (shape, dim, axes)."""
    out = []
    padded = (tuple(spec) + (None,) * len(shape))[: len(shape)]
    for i, axes in enumerate(padded):
        if axes is None:
            out.append(None)
            continue
        ax_tuple = axes if isinstance(axes, (tuple, list)) else (axes,)
        ax_tuple = tuple(a for a in ax_tuple if a in mesh.shape)
        if not ax_tuple:
            out.append(None)
            continue
        n = _axis_size(mesh, ax_tuple)
        if n == 1:
            out.append(None)
        elif shape[i] % n != 0:
            _LEGALIZE_REFUSAL.inc()
            if loud:
                key = (tuple(shape), i, ax_tuple, n)
                if key not in _WARNED_REFUSALS:
                    _WARNED_REFUSALS.add(key)
                    warnings.warn(
                        f"sharding constraint refused on dim {i} of shape "
                        f"{tuple(shape)}: {shape[i]} is not divisible by "
                        f"the {n}-way mesh axis {ax_tuple} — dim "
                        "REPLICATED instead (pad the value at the batch "
                        "boundary to shard it)", stacklevel=4)
            out.append(None)
        else:
            out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


class ShardingPlan:
    """Ordered (regex, PartitionSpec) rules; first match wins."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]] = (),
                 default: PartitionSpec = PartitionSpec()):
        self.rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), PartitionSpec(*spec)) for pat, spec in rules]
        self.default = PartitionSpec(*default)

    def add(self, pattern: str, spec) -> "ShardingPlan":
        self.rules.append((re.compile(pattern), PartitionSpec(*spec)))
        return self

    def extend(self, other: "ShardingPlan") -> "ShardingPlan":
        self.rules.extend(other.rules)
        return self

    def spec_for(self, name: str, shape: Tuple[int, ...],
                 mesh) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(name):
                return _legalize(spec, shape, mesh)
        return _legalize(self.default, shape, mesh)

    def shard(self, name: str, arr: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's block of ``arr`` under the plan's spec for it; a
        block this rank already holds on ``mesh`` (placed by an earlier
        call) as it is, as the reference's placement of an array already
        placed so is a no-op."""
        from .spmd import mesh_key

        placed = getattr(arr, "_spmd_placement", None)
        if placed is not None and placed[0] == mesh_key(mesh):
            return arr
        return shard_array(arr, mesh,
                           self.spec_for(name, tuple(arr.shape), mesh))

    def shard_tree(self, params: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, torch.Tensor]:
        return {n: self.shard(n, a, mesh) for n, a in params.items()}

    def specs_tree(self, params: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, PartitionSpec]:
        return {n: self.spec_for(n, tuple(a.shape), mesh)
                for n, a in params.items()}


def replicated_plan() -> ShardingPlan:
    """Pure data parallelism: every parameter replicated (reference
    :143-146)."""
    return ShardingPlan()


def fsdp_plan(axis: str = "fsdp", min_size: int = 1024) -> ShardingPlan:
    """ZeRO-3: shard every parameter's largest evenly divisible dim over
    ``axis``; leaves below ``min_size`` elements stay replicated
    (reference :149-178)."""

    class _FSDP(ShardingPlan):
        def spec_for(self, name, shape, mesh):
            for pat, spec in self.rules:
                if pat.search(name):
                    return _legalize(spec, shape, mesh)
            if not shape:
                return PartitionSpec()
            n = mesh.shape.get(axis, 1)
            size = 1
            for s in shape:
                size *= s
            if n == 1 or size < min_size:
                return PartitionSpec()
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % n == 0:
                    spec = [None] * len(shape)
                    spec[i] = axis
                    return PartitionSpec(*spec)
            return PartitionSpec()

    return _FSDP()


def expert_parallel_plan(axis: str = "ep") -> ShardingPlan:
    """Expert weights (``[E, ...]`` leaves under an ``expert.`` prefix)
    shard dim 0 over ``axis``; everything else replicates (reference
    :181-192)."""
    return ShardingPlan([
        (r"(^|\.)expert\..*", PartitionSpec(axis)),
        (r".*", PartitionSpec()),
    ])


def tensor_parallel_plan(axis: str = "tp") -> ShardingPlan:
    """Megatron-style sharding by structural-name convention (reference
    :195-210): column-parallel projections shard their output features,
    row-parallel ones their input features, embeddings their vocab dim."""
    return ShardingPlan([
        (r"(qkv|query|key|value|q_proj|k_proj|v_proj|ffn_1|fc1|up|gate|inter)"
         r".*weight$", Spec(axis, None)),
        (r"(qkv|query|key|value|q_proj|k_proj|v_proj|ffn_1|fc1|up|gate|inter)"
         r".*bias$", Spec(axis)),
        (r"(out_proj|o_proj|proj|ffn_2|fc2|down|output).*weight$",
         Spec(None, axis)),
        (r"embed.*weight$", Spec(axis, None)),
    ])


def shard_array(arr: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global ``arr`` under ``spec`` legalized on
    ``mesh``, on the mesh's device (reference :213-214 places the global
    array)."""
    from .spmd import mesh_key

    lspec = _legalize(spec, tuple(arr.shape), mesh)
    out = _coll.local_block(arr.to(mesh.device), lspec, mesh).contiguous()
    if out is arr:
        out = arr.view_as(arr)
    # the block records its placement (what ``spmd.ensure_placed`` reads)
    out._spmd_placement = (mesh_key(mesh), tuple(lspec))
    return out


def _ambient_mesh():
    """The mesh in scope: ``mesh_scope``'s current mesh, else the innermost
    ``with mesh:`` (reference :217-244)."""
    from .mesh import _AMBIENT, current_mesh

    return current_mesh() or (_AMBIENT[-1] if _AMBIENT else None)


def constraint(x, spec: Union[PartitionSpec, Sequence], mesh=None):
    """``lax.with_sharding_constraint`` that keeps model code mesh-agnostic
    (reference :247-300): ``mesh=None`` resolves the enclosing mesh and no
    mesh at all is a no-op; the spec is legalized against the value's shape
    (a dim an axis cannot divide is refused loudly and counted); a
    non-canonical axis the mesh lacks raises. NDArrays pass through
    unwrapped and rewrapped. The batch axes of the step this runs in are
    already real; another axis above 1 becomes a DTensor redistributed to
    the spec's ``Shard`` placements (see the module docstring)."""
    data = getattr(x, "_data", None)
    if data is not None and hasattr(x, "ctx"):
        from ..ndarray.ndarray import _wrap

        return _wrap(constraint(data, spec, mesh), x.ctx)
    if mesh is None:
        mesh = _ambient_mesh()
    if mesh is None or not getattr(mesh, "shape", None):
        return x
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    from .mesh import AXIS_NAMES

    known = set(mesh.shape) | set(AXIS_NAMES)
    for axes in tuple(spec):
        for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
            if a is not None and a not in known:
                raise ValueError(
                    f"sharding constraint names axis {a!r} but the mesh "
                    f"in scope only has {sorted(mesh.shape)} (canonical "
                    f"axes {AXIS_NAMES} legalize away when absent) — a "
                    "typo'd axis must not silently drop the constraint")
    lspec = _legalize(spec, tuple(getattr(x, "shape", ())), mesh, loud=True)
    return _realize(x, lspec, mesh)


def _realize(x, lspec: PartitionSpec, mesh):
    """``x`` with the non-batch axes of ``lspec`` made real as a DTensor
    over their sub-mesh (the batch axes of the running step are real
    already); ``x`` itself where none is left."""
    from . import spmd as _spmd

    done = set(_spmd.active_batch_axes())
    dims = []
    for d, axes in enumerate(lspec):
        for a in (() if axes is None else
                  (axes if isinstance(axes, tuple) else (axes,))):
            if a not in done and mesh.shape.get(a, 1) > 1:
                dims.append((a, d))
    if not dims or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = tuple(a for a, _d in dims)
    sub = mesh.device_mesh[names] if len(names) > 1 else \
        mesh.device_mesh[names[0]]
    if isinstance(x, DTensor):
        x = x.full_tensor()
    dt = DTensor.from_local(x, sub, [Replicate()] * len(names),
                            run_check=False)
    return dt.redistribute(sub, [Shard(d) for _a, d in dims])
