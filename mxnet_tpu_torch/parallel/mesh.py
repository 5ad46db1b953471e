"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The reference expresses every kind of parallelism as a sharding of one
program over a named ``jax.sharding.Mesh``. The port's mesh is the same
named axes over the ranks of an initialized ``torch.distributed`` world,
one device a rank, as a ``DeviceMesh`` with ``mesh_dim_names``: each rank
runs the step's program on its own shard and the collectives
(``parallel.collectives``) run over the process group of a mesh
dimension. Axis names (any subset, size-1 axes are free), in
``AXIS_NAMES``' order so that ``tp`` varies fastest (on one host, the
neighbouring ranks are the ones NVLink joins best):

- ``dp``   data parallel (gradient all-reduce; the KVStore axis)
- ``fsdp`` fully-sharded data parallel (parameter and optimizer state)
- ``tp``   tensor parallel within layers
- ``sp``   sequence parallel (ring attention, ``parallel.ring_attention``)
- ``ep``   expert parallel (the experts of ``parallel.moe``)
- ``pp``   pipeline parallel (``parallel.pipeline``)

A mesh whose axes are all 1 needs no world: it is the one device of
``devices[0]`` (``cuda`` when None), as before. A world that is
initialized makes a ``DeviceMesh`` even of one rank (the card's mesh of
one), so that ``parallel.collectives`` run through its backend.

Quarantine (reference ``spmd.py:200-232``): the CUDA device a rank takes
(:func:`world_device`) skips every device index in the sentinel's active
quarantine (:func:`admitted_devices`), so a restart after a corrupt
device was quarantined runs without it; when every device is
quarantined the list is ignored, with a warning. A quarantined RANK
(``Quarantine.add_rank``, a suspect's restart or a heartbeat verdict) is
left out of the mesh: ``make_mesh`` and ``auto_mesh`` over such a world
build the mesh over the admitted ranks (:func:`admitted_ranks`; a
``DeviceMesh`` of those ranks and a ``torch.distributed.new_group`` of
them for the mesh-wide collectives, each made on every rank of the
world, as group creation needs), and the quarantined rank's process
raises ``MXNetError`` naming the quarantine once it has taken its part
in making them. Every mesh made without quarantined ranks emits the
reference's ``corruption`` event ``spmd.quarantine_excluded``;
quarantining every rank is ignored the same loud way as every device.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence

import torch

from ..context import resolve_device

__all__ = ["AXIS_NAMES", "Mesh", "make_mesh", "auto_mesh", "current_mesh",
           "set_mesh", "mesh_scope", "world_size", "world_device",
           "admitted_devices", "admitted_ranks"]

AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

_CURRENT: List[Optional["Mesh"]] = [None]
# the meshes entered with ``with mesh:`` (sharding.constraint's ambient)
_AMBIENT: List["Mesh"] = []


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks of the initialized ``torch.distributed`` world (1 without
    one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def world_device(devices: Optional[Sequence] = None) -> torch.device:
    """This rank's device: ``devices[rank]`` (or ``devices[0]``) when
    given; else the CPU under a gloo world, and ``cuda:<rank %
    device_count>`` otherwise (raises without CUDA)."""
    dist = _dist()
    rank = dist.get_rank() if dist is not None else 0
    if devices:
        return resolve_device(devices[rank] if len(devices) > rank
                              else devices[0])
    if dist is not None and dist.get_backend() == "gloo":
        return torch.device("cpu")
    dev = resolve_device(None)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    cuda = admitted_devices([torch.device("cuda", i) for i in range(count)])
    if dist is None and len(cuda) == count:
        return dev
    return cuda[rank % len(cuda)]


def admitted_devices(devices: Sequence) -> List:
    """``devices`` minus those the sentinel's active quarantine names (by
    device index, or as a quarantined rank's device), in order; all of
    them, loudly, when every one is quarantined."""
    from .. import sentinel as _sentinel
    from .. import telemetry as _telemetry

    q = _sentinel.active_quarantine()
    devices = list(devices)
    if q is None:
        return devices
    kept = q.filter_devices(devices)
    if not kept:
        warnings.warn("every visible device is quarantined (entries: "
                      f"{q.entries()}); ignoring the quarantine list for "
                      "mesh resolution", stacklevel=2)
        return devices
    if len(kept) < len(devices):
        excluded = [d.index or 0 for d in devices if d not in kept]
        _telemetry.event("corruption", "spmd.quarantine_excluded",
                         devices=excluded)
    return kept


def admitted_ranks() -> List[int]:
    """The world's ranks minus those the sentinel's active quarantine names,
    in order; every rank, loudly, when all of them are quarantined (and
    ``[0]`` without a world). Meshes are made over these ranks."""
    from .. import sentinel as _sentinel

    ranks = list(range(world_size()))
    q = _sentinel.active_quarantine()
    if q is None or _dist() is None:
        return ranks
    out = set(q.ranks())
    kept = [r for r in ranks if r not in out]
    if not kept:
        warnings.warn("every rank is quarantined (entries: "
                      f"{q.entries()}); ignoring the quarantine list for "
                      "mesh resolution", stacklevel=2)
        return ranks
    return kept


class Mesh:
    """Named axes over ranks. ``shape`` maps each axis to its size;
    ``device`` is this rank's device; ``device_mesh`` the
    ``torch.distributed`` ``DeviceMesh`` (None for the one device without a
    world). ``with mesh:`` makes it the ambient mesh of
    ``sharding.constraint``, as the reference's ``with mesh:``."""

    def __init__(self, axis_names: Sequence[str], device: torch.device,
                 shape: Optional[Dict[str, int]] = None, device_mesh=None,
                 world_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape) if shape is not None else \
            {a: 1 for a in self.axis_names}
        self.device = device
        self.device_mesh = device_mesh
        # the process group of every rank of the mesh: None where that is
        # the whole world (the default group)
        self.world_group = world_group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values()) if self.shape else 1

    @property
    def ranks(self) -> tuple:
        """The world ranks in mesh order (``(0,)`` without a world)."""
        if self.device_mesh is None:
            return (0,)
        return tuple(int(r) for r in self.device_mesh.mesh.flatten())

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None for the
        one device without a world)."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def __enter__(self):
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc):
        if _AMBIENT and _AMBIENT[-1] is self:
            _AMBIENT.pop()
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis: size}``, axes in ``AXIS_NAMES``' order, then
    unknown names as given. Under an initialized ``torch.distributed``
    world the sizes must multiply to its size, and the mesh is a
    ``DeviceMesh`` over every rank; without one they must multiply to 1,
    and the mesh is ``devices[0]`` (``cuda`` when None; raises without
    CUDA unless given the CPU). Another size raises ``ValueError`` naming
    the devices it needs, as the reference's (:36-57)."""
    sizes = {a: int(s) for a, s in dict(axes).items()}
    order = [a for a in AXIS_NAMES if a in sizes] + \
        [a for a in sizes if a not in AXIS_NAMES]
    shape = [sizes[a] for a in order]
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh {sizes}: every axis needs size >= 1")
    n = math.prod(shape) if shape else 1
    ranks = admitted_ranks()
    if n != len(ranks):
        less = "" if len(ranks) == world_size() else " less the quarantined"
        raise ValueError(
            f"mesh {sizes} needs {n} devices, {len(ranks)} available (the "
            "ranks of the torch.distributed world"
            + ("; none is initialized)" if _dist() is None else f"{less})"))
    device = world_device(devices)
    if _dist() is None:
        return Mesh(order, device)
    shape_t, names = tuple(shape) or (1,), tuple(order) or ("dp",)
    if len(ranks) == world_size():
        return Mesh(order, device, shape={a: sizes[a] for a in order},
                    device_mesh=_device_mesh(device.type, shape_t, names))
    return _admitted_mesh(order, device, sizes, ranks, shape_t, names)


def _admitted_mesh(order, device, sizes, ranks, shape, names) -> Mesh:
    """The mesh over the admitted ``ranks`` of a world with quarantined
    ones: every rank of the world makes the groups (a collective), then a
    quarantined rank raises."""
    from torch.distributed.device_mesh import DeviceMesh

    from .. import sentinel as _sentinel
    from .. import telemetry as _telemetry
    from ..base import MXNetError

    dist = _dist()
    _telemetry.event("corruption", "spmd.quarantine_excluded",
                     ranks=[r for r in range(world_size()) if r not in ranks])
    dm = DeviceMesh(device.type, torch.tensor(ranks).reshape(shape),
                    mesh_dim_names=names)
    group = dist.new_group(ranks)
    rank = dist.get_rank()
    if rank not in ranks:
        q = _sentinel.active_quarantine()
        raise MXNetError(
            f"rank {rank} is quarantined ({q.entries() if q else []}); the "
            f"mesh {sizes} runs on the admitted ranks {ranks}")
    return Mesh(order, device, shape={a: sizes[a] for a in order},
                device_mesh=dm, world_group=group)


# DeviceMeshes of the current world by (device type, shape, names): making
# one makes a process group per axis, a collective every rank must enter; a
# mesh made again on the same world reuses them. The world's group object
# is kept beside them, so that a world made after this one was destroyed
# starts afresh (an id could be reused; the object cannot)
_DEVICE_MESHES: Dict[tuple, object] = {}
_MESH_WORLD: List[object] = [None]


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    world = _dist().group.WORLD
    if _MESH_WORLD[0] is not world:
        _DEVICE_MESHES.clear()
        _MESH_WORLD[0] = world
    key = (device_type, shape, names)
    dm = _DEVICE_MESHES.get(key)
    if dm is None:
        dm = _DEVICE_MESHES[key] = init_device_mesh(
            device_type, shape, mesh_dim_names=names)
    return dm


def auto_mesh(n_devices: Optional[int] = None, *, dp: Optional[int] = None,
              tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1,
              fsdp: int = 1) -> Mesh:
    """A mesh over ``n_devices`` (the world's admitted ranks when None)
    with ``dp`` filling the rest (reference :60-81)."""
    if n_devices is None:
        n_devices = len(admitted_ranks())
    fixed = tp * sp * ep * pp * fsdp
    if dp is None:
        if n_devices % fixed:
            raise ValueError(f"{n_devices} devices not divisible by {fixed}")
        dp = n_devices // fixed
    elif dp * fixed != n_devices:
        raise ValueError(
            f"dp={dp} * (tp*sp*ep*pp*fsdp={fixed}) != n_devices={n_devices}; "
            f"would strand {n_devices - dp * fixed} devices")
    axes = {}
    for name, size in (("pp", pp), ("dp", dp), ("fsdp", fsdp), ("ep", ep),
                       ("sp", sp), ("tp", tp)):
        if size > 1 or name == "dp":
            axes[name] = size
    return make_mesh(axes)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[0]


def set_mesh(mesh: Optional[Mesh]) -> None:
    _CURRENT[0] = mesh


class mesh_scope:
    """``with mesh_scope(mesh): ...`` sets the current mesh and enters the
    mesh (reference :94-109)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None

    def __enter__(self):
        self._prev = _CURRENT[0]
        _CURRENT[0] = self.mesh
        self.mesh.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        self.mesh.__exit__(*exc)
        _CURRENT[0] = self._prev
        return False
