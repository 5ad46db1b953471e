"""Optimizers (counterpart of ``mxnet_tpu/optimizer``; SGD so far)."""
from .optimizer import Optimizer, create, register
from .sgd import SGD

__all__ = ["Optimizer", "SGD", "create", "register"]
