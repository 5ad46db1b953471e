"""mxnet_tpu_torch.models: the flagship transformer LM in PyTorch.

Counterpart of ``mxnet_tpu/models``: the forward, masked-LM loss and train
step of :mod:`.transformer_lm` on one device or a mesh, its sharding plan,
and its pipeline stages.
"""
from . import transformer_lm
from .transformer_lm import (TransformerLMConfig, flash_fallback_count,
                             forward, init_opt_state, init_params, loss_fn,
                             make_pp_pipeline, make_pp_train_step,
                             make_train_step, param_shapes, pp_loss_fn,
                             pp_pad_batch, pp_stages, sharding_plan)

__all__ = ["transformer_lm", "TransformerLMConfig", "forward", "init_params",
           "loss_fn", "param_shapes", "sharding_plan", "init_opt_state",
           "make_train_step", "pp_stages", "make_pp_pipeline", "pp_loss_fn",
           "pp_pad_batch", "make_pp_train_step", "flash_fallback_count"]
