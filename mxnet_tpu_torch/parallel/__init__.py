"""Parallel training (counterpart of ``mxnet_tpu/parallel``): the mesh over
the ranks of a ``torch.distributed`` world (:mod:`mesh`), sharding plans
and ``constraint`` (:mod:`sharding`), named collectives and
``run_sharded`` (:mod:`collectives`), the ``kvstore='tpu'``/``'nccl'``
placement rules of the compiled step (:mod:`spmd`), ``ShardedTrainer``
with plans and batch specs (:mod:`train`), ring attention over ``sp``
(:mod:`ring_attention`), the mixture-of-experts layer with its experts
over ``ep`` (:mod:`moe`), and the GPipe pipeline over ``pp``
(:mod:`pipeline`). Every axis ``dp``, ``fsdp``, ``tp``, ``sp``, ``ep``
and ``pp`` runs. The elastic layer (:mod:`elastic`: checkpoints,
heartbeats, ``run_elastic``) checkpoints placed blocks and restores them
onto another mesh."""
from . import (collectives, elastic, moe, pipeline, ring_attention, sharding,
               spmd)
from .elastic import (AnomalyDetected, CheckpointManager, DigestMismatch,
                      HeartbeatMonitor, nonfinite_anomaly, run_elastic)
from .collectives import (all_gather, all_reduce, all_to_all, axis_index,
                          axis_size, broadcast_from, pmean, ppermute,
                          reduce_scatter, ring_shift, run_sharded, shard_map)
from .mesh import (AXIS_NAMES, Mesh, auto_mesh, current_mesh, make_mesh,
                   mesh_scope, set_mesh)
from .moe import aux_scope, moe_layer, record_aux, top_k_gating
from .pipeline import (HeteroPipeline, bubble_fraction, pipeline_apply,
                       pipelined, stack_stage_params)
from .ring_attention import ring_attention, ring_attention_sharded
from .sharding import (NamedSharding, PartitionSpec, ShardingPlan,
                       constraint, expert_parallel_plan, fsdp_plan,
                       replicated_plan, shard_array, tensor_parallel_plan)
from .train import ShardedTrainer, functional_call

__all__ = ["AXIS_NAMES", "AnomalyDetected", "CheckpointManager",
           "DigestMismatch", "HeartbeatMonitor", "HeteroPipeline", "Mesh",
           "MoEBlock",
           "NamedSharding", "PartitionSpec", "PipelineBlock",
           "ShardedTrainer", "ShardingPlan", "all_gather", "all_reduce",
           "all_to_all", "auto_mesh", "aux_scope", "axis_index", "axis_size",
           "broadcast_from", "bubble_fraction", "collectives", "constraint",
           "current_mesh", "elastic", "expert_parallel_plan", "fsdp_plan",
           "functional_call", "make_mesh", "mesh_scope", "moe", "moe_layer",
           "nonfinite_anomaly", "run_elastic",
           "pipeline", "pipeline_apply", "pipelined", "pmean", "ppermute",
           "record_aux", "reduce_scatter", "replicated_plan", "ring_attention",
           "ring_attention_sharded", "ring_shift", "run_sharded", "set_mesh",
           "shard_array", "shard_map", "sharding", "spmd",
           "stack_stage_params", "tensor_parallel_plan", "top_k_gating"]


def __getattr__(name):
    if name == "MoEBlock":
        return moe.MoEBlock
    if name == "PipelineBlock":
        return pipeline.PipelineBlock
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
