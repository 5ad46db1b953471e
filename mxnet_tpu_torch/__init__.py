"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or anything of ``mxnet_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit device they raise.

Ported so far: the flagship transformer LM forward, loss and single-device
train step (``models``), with flash attention's forward and backward as
hand-written Hopper kernels (``ops/csrc/flash_attention_{fwd,bwd}.cu``); and
the Gluon ResNet v1 train path (``gluon``, ``optimizer``, ``autograd``,
``initializer``), whose fused 1x1-conv / batch-norm epilogue runs two more
hand-written kernels (``ops/csrc/conv_bn_epilogue.cu``), and whose conv +
batch-norm pairs take their statistics in two more (``conv_bn_epilogue.cu``,
``convkxk_bn_stats.cu``); and the op level of int8 quantization
(``contrib.quantization``), whose s8 products and convolutions are exact in
plain PyTorch, beside the int8 matmul kernel (``ops/csrc/int8_matmul.cu``);
and the compiled steps and forwards as CUDA graphs (``program_store``,
``cached_step``, ``parallel.ShardedTrainer`` on one device, a hybridized
block's forward and its recorded tape node, shape buckets in
``serving``); and the imperative substrate: the op registry
(``ops.registry``) and its op modules, ``NDArray`` and ``invoke``
(``ndarray``, ``mx.nd``), ``random``, and autograd on NDArrays, through
which the Gluon layers dispatch; and serving: ``serving.ServingEngine``
(micro-batched, shape-bucketed captured inference) and
``serving_decode.GenerativeEngine`` (continuous batching over a paged KV
cache with a prefix cache and seeded sampling), on the runtime pieces
``faults``, ``telemetry``, ``preemption`` and ``engine``; and the runtime
around the train step: device prefetch (``engine.prefetch``), metrics
accumulated on the device (``metric``), ``profiler`` with its
``StepTimeline``, ``runtime`` features, the flight recorder
(``telemetry.flush`` / ``merge``), the integrity sentinel (``sentinel``)
and checkpoints with elastic restore (``parallel.elastic``); and mixed
precision (``amp``: the cast policy, the dynamic loss scaler and the
deferred all-finite gate of the compiled step), with fp16 forms of the
conv + batch-norm kernels.
"""
from . import (amp, autograd, base, config, contrib, engine, faults, gluon,
               initializer, metric, models, ndarray, optimizer, preemption,
               profiler, random, runtime, sentinel, serving, serving_decode,
               telemetry)
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from .ndarray import NDArray

nd = ndarray
init = initializer

__all__ = ["Context", "MXNetError", "NDArray", "amp", "autograd", "base",
           "config", "contrib", "cpu", "current_context", "engine", "faults", "gluon",
           "gpu", "init", "initializer", "metric", "models", "nd", "ndarray",
           "num_gpus", "optimizer", "preemption", "profiler", "random",
           "runtime", "sentinel", "serving", "serving_decode", "telemetry"]
