"""Parallel training (counterpart of ``mxnet_tpu/parallel``): the mesh over
the ranks of a ``torch.distributed`` world (:mod:`mesh`), sharding plans
and ``constraint`` (:mod:`sharding`), named collectives and
``run_sharded`` (:mod:`collectives`), the ``kvstore='tpu'``/``'nccl'``
placement rules of the compiled step (:mod:`spmd`), ``ShardedTrainer``
with plans and batch specs (:mod:`train`), and the mixture-of-experts
layer on one device (:mod:`moe`). The axes ``dp``, ``fsdp`` and ``tp``
run; ``sp``, ``ep`` (the experts placed over it) and ``pp`` are ROADMAP
A6b-2 and A6b-3."""
from . import collectives, moe, sharding, spmd
from .collectives import (all_gather, all_reduce, all_to_all, axis_index,
                          axis_size, broadcast_from, pmean, ppermute,
                          reduce_scatter, ring_shift, run_sharded, shard_map)
from .mesh import (AXIS_NAMES, Mesh, auto_mesh, current_mesh, make_mesh,
                   mesh_scope, set_mesh)
from .moe import aux_scope, moe_layer, record_aux, top_k_gating
from .sharding import (NamedSharding, PartitionSpec, ShardingPlan,
                       constraint, expert_parallel_plan, fsdp_plan,
                       replicated_plan, shard_array, tensor_parallel_plan)
from .train import ShardedTrainer, functional_call

__all__ = ["AXIS_NAMES", "Mesh", "MoEBlock", "NamedSharding",
           "PartitionSpec", "ShardedTrainer", "ShardingPlan", "all_gather",
           "all_reduce", "all_to_all", "auto_mesh", "aux_scope",
           "axis_index", "axis_size", "broadcast_from", "collectives",
           "constraint", "current_mesh", "expert_parallel_plan",
           "fsdp_plan", "functional_call", "make_mesh", "mesh_scope", "moe",
           "moe_layer", "pmean", "ppermute", "record_aux", "reduce_scatter",
           "replicated_plan", "ring_shift", "run_sharded", "set_mesh",
           "shard_array", "shard_map", "sharding", "spmd",
           "tensor_parallel_plan", "top_k_gating"]


def __getattr__(name):
    if name == "MoEBlock":
        return moe.MoEBlock
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
