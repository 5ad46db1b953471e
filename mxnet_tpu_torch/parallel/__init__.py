"""Parallel training (counterpart of ``mxnet_tpu/parallel``): the mesh and
``ShardedTrainer`` on one device, and the mixture-of-experts layer
(:mod:`moe`) on one device; the mesh axes across devices, and the experts
placed over ``ep``, are ROADMAP A6b."""
from . import moe
from .mesh import AXIS_NAMES, Mesh, make_mesh
from .moe import aux_scope, moe_layer, record_aux, top_k_gating
from .train import ShardedTrainer, functional_call

__all__ = ["AXIS_NAMES", "Mesh", "MoEBlock", "ShardedTrainer",
           "aux_scope", "functional_call", "make_mesh", "moe", "moe_layer",
           "record_aux", "top_k_gating"]


def __getattr__(name):
    if name == "MoEBlock":
        return moe.MoEBlock
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
