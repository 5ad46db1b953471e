"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters, layers,
losses, the Trainer and the model zoo, on ``torch.Tensor``s."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss",
           "model_zoo", "nn"]
