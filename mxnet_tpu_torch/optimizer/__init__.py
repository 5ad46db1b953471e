"""Optimizers (counterpart of ``mxnet_tpu/optimizer``; SGD and Adam so
far)."""
from . import fused
from .adam import Adam
from .optimizer import Optimizer, create, register
from .sgd import SGD

__all__ = ["Adam", "Optimizer", "SGD", "create", "fused", "register"]
