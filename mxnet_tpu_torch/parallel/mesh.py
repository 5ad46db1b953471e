"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py:36-57``).

The reference expresses every kind of parallelism as a sharding of one
program over a named ``jax.sharding.Mesh``. The port runs on one device so
far: :func:`make_mesh` takes the reference's axis names, and every axis
must have size 1. A larger axis (data, fully-sharded, tensor, sequence,
expert or pipeline parallel across devices) is ROADMAP A6 and raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..context import resolve_device

__all__ = ["AXIS_NAMES", "Mesh", "make_mesh"]

AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


class Mesh:
    """A one-device mesh: named axes, each of size 1, over ``device``.
    ``with mesh:`` is accepted, as for the reference's mesh, and does
    nothing."""

    def __init__(self, axis_names: Sequence[str], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = {a: 1 for a in self.axis_names}
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis: size}``, axes in ``AXIS_NAMES``' order, then
    unknown names as given, over ``devices[0]`` (``cuda`` when None;
    raises without CUDA unless given the CPU). Every size must be 1."""
    sizes = dict(axes)
    big = {a: s for a, s in sizes.items() if int(s) != 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: meshes over more than one device are not "
            "ported to mxnet_tpu_torch yet (ROADMAP Queue A, A6); every "
            "axis must have size 1")
    order = [a for a in AXIS_NAMES if a in sizes] + \
        [a for a in sizes if a not in AXIS_NAMES]
    device = resolve_device(devices[0] if devices else None)
    return Mesh(order, device)
