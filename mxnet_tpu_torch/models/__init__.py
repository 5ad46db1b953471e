"""mxnet_tpu_torch.models: the flagship transformer LM in PyTorch.

Counterpart of ``mxnet_tpu/models``; so far the single-device forward,
masked-LM loss and train step of :mod:`.transformer_lm`.
"""
from . import transformer_lm
from .transformer_lm import (TransformerLMConfig, flash_fallback_count,
                             forward, init_opt_state, init_params, loss_fn,
                             make_train_step, param_shapes)

__all__ = ["transformer_lm", "TransformerLMConfig", "forward", "init_params",
           "loss_fn", "param_shapes", "init_opt_state", "make_train_step",
           "flash_fallback_count"]
