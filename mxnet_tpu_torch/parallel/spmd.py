"""SPMD data parallelism: ``kvstore='tpu'`` / ``'nccl'`` as a mesh
(counterpart of ``mxnet_tpu/parallel/spmd.py``).

The reference turns the KVStore's push/pull into shardings of ONE donated
XLA program over a ``jax.sharding.Mesh``: the batch shards over ``dp``,
an ``fsdp`` axis shards parameters and optimizer state, and the XLA
partitioner schedules the collectives inside the program. The port runs
the same program on every rank of a ``torch.distributed`` world
(``parallel.mesh``), one captured program a step on each rank, with the
collectives written into the step (``cached_step.TrainStep``,
``parallel.train.ShardedTrainer``) by the rules of this module, so that
each rank's numbers are those of the reference's one program over the
global batch:

- the step takes the GLOBAL batch; the net runs on this rank's rows of
  its ``dp`` coordinate (:func:`local_rows`, :func:`put_batch`), its
  outputs are gathered over ``dp`` (``collectives.gather_rows``), and
  every rank runs the loss on the global outputs and labels. The loss's
  cotangent is seeded ``1 / (the batch axes' size)`` and the gather's
  backward sums over the members, so a gradient that reaches a parameter
  through the rows and one that reaches it directly (a regularizer in the
  loss) both come out whole once the parameters' gradients are summed
  over the batch axes (:func:`reduce_grad`);
- batch norm inside the step normalizes with the global batch's moments
  (:func:`global_moments`, called by ``ops.nn.batch_norm`` and the fused
  conv + batch-norm ops), so running statistics are equal on every rank;
- the first rank's parameters are broadcast to every rank at the first
  placement (:func:`broadcast_`, the KVStore's init); parameters and
  optimizer state are stored as this rank's block of
  :func:`param_spec` (the ``fsdp`` rule), gathered whole before the
  forward (:func:`gather_full`), and their gradients reduced to the block
  (:func:`reduce_grad`: a reduce-scatter over a batch axis the block is
  split over, a slice over another, an all-reduce over the rest);
- a collective over an axis of size 1 is elided, as XLA elides it, so a
  mesh of one is the single-device step bit for bit.

:func:`resolve_mesh` reads ``MXNET_SPMD_MESH`` (``auto`` / ``off`` /
``<int>`` / ``dp=…,fsdp=…,tp=…``, reference :234-286) over every rank of
the world; the device each rank takes skips the devices in the
sentinel's quarantine list (``mesh.admitted_devices``, reference
:199-232). A quarantined rank is not yet left out of the world's mesh
(ROADMAP A7b). :func:`put_batch` takes the global batch,
as the reference's tests pass it; the multi-controller form, where each
process reads only its shard (the DataLoader's ``num_shards``), waits for
the DataLoader (A9). :func:`param_spec` places the packed pipeline
stage buffer over ``pp`` and expert weights over ``ep`` by name; the
batch splits over ``dp`` only, so the ``pp``, ``ep`` and ``fsdp`` members
of one ``dp`` row compute on the same rows and the gradients of their
blocks are slices of the whole (:func:`reduce_grad`).
"""
from __future__ import annotations

import math
import re
import threading
import warnings
import weakref
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch

from .. import config as _config
from .. import faults as _faults
from .. import telemetry as _telemetry
from . import collectives as _coll
from .mesh import Mesh, admitted_ranks, make_mesh, world_size
from .sharding import NamedSharding, PartitionSpec, _legalize

__all__ = ["DATA_AXIS", "MODEL_AXIS", "TENSOR_AXIS", "PIPE_AXIS",
           "EXPERT_AXIS", "model_axes_active", "mesh_for_store",
           "resolve_mesh", "batch_sharding", "replicated", "batch_spec_for",
           "param_spec", "param_sharding", "put_batch", "ensure_placed",
           "mesh_key", "reshard_count", "replicated_batch_count",
           "record_layout", "param_bytes_per_device",
           "opt_bytes_per_device", "reset_counters", "local_rows",
           "data_parallel", "active_batch_axes", "global_moments",
           "gather_full", "reduce_grad", "broadcast_"]

DATA_AXIS = "dp"
MODEL_AXIS = "fsdp"
TENSOR_AXIS = "tp"
PIPE_AXIS = "pp"
EXPERT_AXIS = "ep"

_MESH_STORES = ("tpu", "nccl")
_PIPE_PACKED_RE = re.compile(r"(^|\.)pp_stages$")
_EXPERT_RE = re.compile(r"(^|\.)expert\.")

_lock = threading.Lock()
_RESHARD = _telemetry.counter(
    "spmd.reshard",
    "param/state leaves actually placed by ensure_placed (first-step "
    "placement expected; a steady-state bump is a silent copy)")
_REPLICATED_BATCH = _telemetry.counter(
    "spmd.replicated_batch",
    "batches replicated because the 'dp' axis could not divide the "
    "batch axis evenly (correct but no scale-out that step)")
_WARNED_SHAPES: set = set()
_LAYOUT_BYTES = {"param": 0, "opt": 0}


def record_layout(param_leaves, opt_leaves) -> None:
    """Record the bytes of the placed parameter and optimizer-state blocks
    on this rank (reference :129-166)."""
    def nbytes(ts):
        return sum(int(t.numel()) * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    with _lock:
        _LAYOUT_BYTES["param"] = nbytes(param_leaves)
        _LAYOUT_BYTES["opt"] = nbytes(opt_leaves)


def param_bytes_per_device() -> int:
    """Bytes of parameters on this rank's device under the current layout
    (gauge ``spmd.param_bytes_per_device``)."""
    return int(_LAYOUT_BYTES["param"])


def opt_bytes_per_device() -> int:
    """Bytes of optimizer state on this rank's device (gauge
    ``spmd.opt_bytes_per_device``)."""
    return int(_LAYOUT_BYTES["opt"])


_telemetry.gauge_fn(
    "spmd.param_bytes_per_device", param_bytes_per_device,
    "bytes of parameters resident on one device under the current "
    "layout (replicated: the full model; fsdp-sharded: ~1/N)")
_telemetry.gauge_fn(
    "spmd.opt_bytes_per_device", opt_bytes_per_device,
    "bytes of optimizer state resident on one device under the current "
    "layout (replicated: the full state; fsdp-sharded: ~1/N)")


def reshard_count() -> int:
    return int(_RESHARD.value)


def replicated_batch_count() -> int:
    return int(_REPLICATED_BATCH.value)


def reset_counters() -> None:
    _RESHARD.reset()
    _REPLICATED_BATCH.reset()
    with _lock:
        _LAYOUT_BYTES["param"] = 0
        _LAYOUT_BYTES["opt"] = 0


# ---------------------------------------------------------------------------
# mesh resolution (MXNET_SPMD_MESH)
# ---------------------------------------------------------------------------
def resolve_mesh(spec: Optional[str] = None) -> Optional[Mesh]:
    """``MXNET_SPMD_MESH`` (or ``spec``) as a mesh over the world's ranks,
    or None when SPMD is off (reference :234-286): ``auto`` (the default)
    puts every admitted rank (the world's less the quarantined,
    ``mesh.admitted_ranks``) on ``dp`` and a world of one resolves to
    None;
    ``0`` / ``off`` / ``none`` disable; ``<int>`` puts that many ranks on
    ``dp`` (``1`` gives a mesh of one); ``dp=4,fsdp=2`` goes through
    :func:`mesh.make_mesh` and must name ``dp``. A size the world cannot
    give raises ``ValueError`` naming the devices it needs."""
    raw = spec if spec is not None else _config.get("MXNET_SPMD_MESH")
    raw = (raw or "auto").strip().lower()
    if raw in ("0", "off", "none", "disabled"):
        return None
    n_dev = world_size()
    if raw in ("auto", ""):
        # every ADMITTED rank: a restart after the sentinel quarantined a
        # rank re-places onto a mesh without it (reference :254-262)
        n_adm = len(admitted_ranks())
        if n_adm < 2:
            return None
        return make_mesh({DATA_AXIS: n_adm})
    if raw.isdigit():
        n = int(raw)
        if n < 1:
            return None
        if n != n_dev:
            raise ValueError(
                f"MXNET_SPMD_MESH={n} needs {n} devices, {n_dev} visible "
                "(the ranks of the torch.distributed world)")
        return make_mesh({DATA_AXIS: n})
    axes = {}
    for part in raw.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    if DATA_AXIS not in axes:
        raise ValueError(
            f"MXNET_SPMD_MESH={raw!r} must name the '{DATA_AXIS}' axis "
            "(e.g. 'dp=8'), or be 'auto'/'off'/an integer")
    return make_mesh(axes)


def mesh_for_store(kv_type: Optional[str]) -> Optional[Mesh]:
    """The mesh a ``TrainStep`` runs over for a kvstore type: the resolved
    ``MXNET_SPMD_MESH`` for ``'tpu'`` / ``'nccl'``, None otherwise
    (reference :288-298)."""
    if kv_type is None or kv_type.lower() not in _MESH_STORES:
        return None
    return resolve_mesh()


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------
def replicated(mesh) -> NamedSharding:
    """Parameters, optimizer state and scalars: whole on every rank."""
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh) -> NamedSharding:
    """The batch's placement: axis 0 over ``dp`` and only ``dp``."""
    return NamedSharding(mesh, PartitionSpec(DATA_AXIS))


def param_spec(shape: Tuple[int, ...], mesh, min_size: Optional[int] = None,
               name: Optional[str] = None) -> PartitionSpec:
    """The placement of one parameter or optimizer-state leaf (reference
    :317-370). The name rules come first (``name`` is the structural
    parameter name where the caller knows it): the packed pipeline stage
    buffer ``pp_stages`` takes ``P('pp', None)`` when its leading dim is
    the ``pp`` axis's size, and ``expert.*`` leaves take ``P('ep')`` on
    dim 0 when ``ep`` divides the expert count. Otherwise the ``fsdp``
    rule: the largest dim the ``fsdp`` axis divides evenly. Leaves under
    ``min_size`` elements (``MXNET_FSDP_MIN_SIZE``) stay replicated; a
    large leaf no dim of which divides the axis replicates loudly (counted
    and warned once per shape by the ``_legalize`` path)."""
    if name and shape:
        n_pp = int(mesh.shape.get(PIPE_AXIS, 1))
        if n_pp > 1 and _PIPE_PACKED_RE.search(name) and shape[0] == n_pp:
            return PartitionSpec(PIPE_AXIS, *([None] * (len(shape) - 1)))
        n_ep = int(mesh.shape.get(EXPERT_AXIS, 1))
        if n_ep > 1 and _EXPERT_RE.search(name) and shape[0] % n_ep == 0:
            return PartitionSpec(EXPERT_AXIS, *([None] * (len(shape) - 1)))
    if min_size is None:
        min_size = int(_config.get("MXNET_FSDP_MIN_SIZE"))
    n = int(mesh.shape.get(MODEL_AXIS, 1))
    if n <= 1 or not shape:
        return PartitionSpec()
    if math.prod(int(s) for s in shape) < min_size:
        return PartitionSpec()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0:
            spec = [None] * len(shape)
            spec[i] = MODEL_AXIS
            return PartitionSpec(*spec)
    return _legalize(PartitionSpec(MODEL_AXIS), tuple(shape), mesh,
                     loud=True)


def param_sharding(shape: Tuple[int, ...], mesh,
                   name: Optional[str] = None) -> NamedSharding:
    return NamedSharding(mesh, param_spec(shape, mesh, name=name))


def model_axes_active(mesh) -> bool:
    """True when a model-side placement axis (``fsdp``/``pp``/``ep``) is
    above 1."""
    return any(int(mesh.shape.get(a, 1)) > 1
               for a in (MODEL_AXIS, PIPE_AXIS, EXPERT_AXIS))


def batch_spec_for(shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """``P('dp')`` when the batch axis divides evenly, else ``P()``:
    replicated, counted in :func:`replicated_batch_count` and warned once
    per shape. Never raises."""
    n = int(mesh.shape.get(DATA_AXIS, 1))
    if n <= 1 or not shape:
        return PartitionSpec()
    if shape[0] % n != 0:
        with _lock:
            _REPLICATED_BATCH.inc()
            key = (tuple(shape), n)
            if key not in _WARNED_SHAPES:
                _WARNED_SHAPES.add(key)
                warnings.warn(
                    f"SPMD batch axis {shape[0]} is not divisible by the "
                    f"{n}-way '{DATA_AXIS}' mesh axis; this input is "
                    "REPLICATED for correctness (no data-parallel speedup "
                    "for it). Pad the batch or pick a divisible batch "
                    "size.", stacklevel=3)
        return PartitionSpec()
    return PartitionSpec(DATA_AXIS)


def mesh_key(mesh) -> Optional[tuple]:
    """The mesh's part of a program key: axes, sizes, ranks and device.
    A ``Mesh`` is remembered under its key (:func:`mesh_of`); the spec
    functions also take stand-ins that only carry these fields."""
    if mesh is None:
        return None
    key = (tuple(mesh.axis_names),
           tuple(int(mesh.shape[a]) for a in mesh.axis_names),
           tuple(mesh.ranks), str(mesh.device))
    if isinstance(mesh, Mesh):
        _MESHES[key] = mesh
    return key


# the live meshes by key: a block's placement (``_spmd_placement``) names
# its mesh by key, and the checkpoints and the sentinel's digest find it
_MESHES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def mesh_of(key) -> Optional[Mesh]:
    """The live mesh of a placement's key, None when it is gone."""
    return _MESHES.get(key)


# ---------------------------------------------------------------------------
# blocks, placement and the batch
# ---------------------------------------------------------------------------
def ensure_placed(arr: torch.Tensor, sharding: NamedSharding
                  ) -> torch.Tensor:
    """``arr`` as this rank's block of ``sharding``: untouched when it is
    already that block (placed by an earlier call), else the block of the
    whole ``arr`` on the mesh's device, a copy counted in
    :func:`reshard_count` (steady state must not pay it)."""
    key = (mesh_key(sharding.mesh), tuple(sharding.spec))
    if getattr(arr, "_spmd_placement", None) == key:
        return arr
    _RESHARD.inc()
    with torch.no_grad():
        out = _coll.local_block(arr.detach().to(sharding.mesh.device),
                                sharding.spec, sharding.mesh).clone()
    out._spmd_placement = key
    return out


def broadcast_(tensors, mesh) -> None:
    """Every rank's ``tensors`` overwritten in place by the mesh's first
    rank's (the KVStore's init broadcast, so that replicated leaves start
    equal on every rank); nothing on a mesh of one."""
    if mesh is None or mesh.size <= 1 or mesh.device_mesh is None:
        return
    import torch.distributed as dist

    src = mesh.ranks[0]
    with torch.no_grad():
        for t in tensors:
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=src, group=mesh.world_group)


def local_rows(t, mesh, axes: Sequence[str] = (DATA_AXIS,)):
    """This rank's rows of the global batch leaf ``t`` over ``axes`` (the
    first slowest); ``t`` itself where no axis is above 1."""
    if not isinstance(t, torch.Tensor) or t.dim() < 1:
        return t
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return t
    return _coll.local_block(t, PartitionSpec(axes), mesh)


def _put_batch_once(arr, mesh, spec):
    if not isinstance(arr, torch.Tensor):
        import numpy as np

        arr = torch.as_tensor(np.asarray(arr))
    out = arr.to(mesh.device)
    return local_rows(out, mesh, tuple(spec[0:1]))


def put_batch(arr, mesh):
    """This rank's rows of the global batch leaf ``arr`` on the mesh's
    device, by :func:`batch_spec_for` (an indivisible batch stays whole on
    every rank, loudly). A transient failure retries under the shared
    policy (site ``spmd.put``)."""
    shape = tuple(getattr(arr, "shape", ()))
    spec = batch_spec_for(shape, mesh)
    return _faults.retry_call(_put_batch_once, arr, mesh, spec,
                              site="spmd.put")


# ---------------------------------------------------------------------------
# the steps' data-parallel scope and their reductions
# ---------------------------------------------------------------------------
class _Scope(threading.local):
    def __init__(self):
        super().__init__()
        self.stack = []


_SCOPE = _Scope()


@contextmanager
def data_parallel(mesh, axes: Sequence[str]):
    """The scope of a step's forward over this rank's rows of a batch split
    over ``axes``: batch norm takes the global moments over them
    (:func:`global_moments`) and ``sharding.constraint`` treats them as
    real. Axes of size 1 are dropped."""
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    _SCOPE.stack.append((mesh, axes))
    try:
        yield axes
    finally:
        _SCOPE.stack.pop()


def active_batch_axes() -> tuple:
    return _SCOPE.stack[-1][1] if _SCOPE.stack else ()


def global_moments(mean, var, count: int):
    """``(mean, var, count)`` of the whole batch from this rank's fp32
    moments over ``count`` rows, inside :func:`data_parallel` (Chan's
    pairwise combination over equal counts, through differentiable sums);
    the arguments themselves outside it or over axes of size 1."""
    if not _SCOPE.stack or not _SCOPE.stack[-1][1]:
        return mean, var, count
    mesh, axes = _SCOPE.stack[-1]
    n = math.prod(mesh.shape[a] for a in axes)
    total = count * n
    g_mean = _coll.all_reduce_sum(mean * count, mesh, axes) / total
    d = mean - g_mean
    g_var = _coll.all_reduce_sum((var + d * d) * count, mesh, axes) / total
    return g_mean, g_var, total


def batch_sync():
    """The (mesh, axes) a batch-statistics reduction runs over, or None
    (what a fused op's backward keeps from its forward)."""
    if not _SCOPE.stack or not _SCOPE.stack[-1][1]:
        return None
    return _SCOPE.stack[-1]


def _spec_axes(spec, ndim: int):
    padded = (tuple(spec) + (None,) * ndim)[:ndim]
    return [() if a is None else (tuple(a) if isinstance(a, tuple) else (a,))
            for a in padded]


def gather_full(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of which each rank holds its ``spec`` block (the
    block itself where no axis above 1 splits it)."""
    if not any(mesh.shape.get(a, 1) > 1
               for axes in _spec_axes(spec, block.dim()) for a in axes):
        return block
    return _coll.global_from_blocks(block, spec, mesh)


def reduce_grad(g: torch.Tensor, spec, mesh,
                batch_axes: Sequence[str]) -> torch.Tensor:
    """This rank's block of the whole gradient: ``g`` is this rank's part
    of the gradient of the whole tensor, summed over ``batch_axes``
    (the axes whose members hold different rows). A dim split over a batch
    axis reduce-scatters over it; a dim split over another axis (whose
    members hold the same gradient) is sliced; the batch axes left
    all-reduce. Axes of size 1 are elided."""
    batch_axes = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)
    dims = _spec_axes(spec, g.dim())
    used = {a for axes in dims for a in axes}
    rest = tuple(a for a in batch_axes if a not in used)
    out = g
    if rest:
        out = _coll.all_reduce(out, rest, mesh=mesh)
    for d, axes in enumerate(dims):
        for a in axes:
            n = mesh.shape.get(a, 1)
            if n <= 1:
                continue
            if a in batch_axes:
                out = _coll._scatter_one(out, mesh, a, d)
            else:
                out = out.chunk(n, dim=d)[mesh.coordinate(a)]
    return out.contiguous() if out is not g else out


def split_axes(mesh, batch_spec) -> tuple:
    """The axes above 1 that dim 0 of ``batch_spec`` splits the batch
    over."""
    if not batch_spec or batch_spec[0] is None:
        return ()
    first = batch_spec[0]
    axes = first if isinstance(first, tuple) else (first,)
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def cotangent_scale(mesh, axes: Sequence[str]) -> float:
    """The loss cotangent a rank seeds when every rank computes the global
    loss and the gradients are summed over ``axes``."""
    return 1.0 / math.prod(mesh.shape.get(a, 1) for a in axes)


def full_tensors(ts):
    """DTensors (a ``constraint`` left them) as whole local tensors; other
    values as they are."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # pragma: no cover - torch without it
        return ts

    def one(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    if isinstance(ts, (list, tuple)):
        return type(ts)(one(t) for t in ts)
    return one(ts)


@contextmanager
def tensor_ops(mesh):
    """The scope of a step's forward and backward where a DTensor made by
    ``constraint`` meets the plain tensors of the ops that follow: an
    implicit replication where a non-batch axis above 1 can make one,
    nothing otherwise."""
    if mesh is None or mesh.device_mesh is None or not any(
            s > 1 for a, s in mesh.shape.items() if a != DATA_AXIS):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield
