"""Parallel training (counterpart of ``mxnet_tpu/parallel``): the mesh and
``ShardedTrainer`` on one device so far; the mesh axes across devices are
ROADMAP A6."""
from .mesh import AXIS_NAMES, Mesh, make_mesh
from .train import ShardedTrainer, functional_call

__all__ = ["AXIS_NAMES", "Mesh", "ShardedTrainer", "functional_call",
           "make_mesh"]
