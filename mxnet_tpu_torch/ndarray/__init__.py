"""``mx.nd``: the imperative NDArray namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py:1-160``. Every operator
registered in the ``nd`` namespace is a function here (made by
:func:`.register.make_op_func`), beside the creation helpers with MXNet's
calling conventions (``zeros``, ``ones``, ``full``, ``empty``, ``arange``),
``waitall``, ``concatenate``, ``moveaxis``, and ``nd.random`` with
``nd.random.seed``. A name of the reference's ``nd`` namespace that the
port has not ported yet (:mod:`._unported`) raises ``NotImplementedError``
naming the ROADMAP item it waits for; any other unknown name is an
``AttributeError``.
"""
from __future__ import annotations

import sys as _sys
import types as _types

import torch as _torch

from .. import random as _random
from ..context import Context, cpu, current_context
from ..ops import elemwise as _elemwise  # noqa: F401  (registers the ops)
from ..ops import init as _init_ops  # noqa: F401
from ..ops import nn as _nn_ops  # noqa: F401
from ..ops import optimizer as _optimizer_ops  # noqa: F401
from ..ops import random as _random_ops  # noqa: F401
from ..ops import reduce as _reduce_ops  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _tensor_ops  # noqa: F401
from ._unported import UNPORTED
from .ndarray import (NDArray, array, host_sync_count, invoke,
                      invoke_count)
from .register import make_op_func

_this = _sys.modules[__name__]

for _name, _schema in list(_registry._OPS.items()):
    if "nd" in _schema.namespaces and not hasattr(_this, _name):
        setattr(_this, _name, make_op_func(_schema))

op = _this


def __getattr__(name):
    schema = _registry.find_op(name)
    if schema is not None and "nd" in schema.namespaces:
        fn = make_op_func(schema)
        setattr(_this, name, fn)
        return fn
    if name in UNPORTED:
        raise NotImplementedError(
            f"mx.nd.{name} is not ported yet: it waits for ROADMAP A9 (the "
            "rest of the surface)")
    raise AttributeError(f"module '{__name__}' has no attribute '{name}'")


# -- creation helpers with MXNet's calling conventions ------------------------

def _create(fn, shape, ctx, dtype, *args):
    with ctx or current_context():
        return invoke(fn, [], {"shape": shape, **dict(args),
                               "dtype": dtype})


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return _create("zeros", shape, ctx, dtype)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return _create("ones", shape, ctx, dtype)


def full(shape, val, ctx=None, dtype="float32", **kwargs):
    return _create("full", shape, ctx, dtype, ("value", val))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    with ctx or current_context():
        return invoke("arange", [], {"start": start, "stop": stop,
                                     "step": step, "repeat": repeat,
                                     "dtype": dtype})


def waitall():
    """Wait for all work on the current CUDA device (reference
    ``MXNDArrayWaitAll``)."""
    if _torch.cuda.is_available():
        _torch.cuda.synchronize()


def concatenate(arrays, axis=0, always_copy=True):
    return invoke("concat", list(arrays), {"dim": axis})


def moveaxis(data, source, destination):
    axes = list(range(data.ndim))
    src = [source] if isinstance(source, int) else list(source)
    dst = [destination] if isinstance(destination, int) else list(destination)
    for s, d in sorted(zip(src, dst), key=lambda x: x[1]):
        axes.remove(s)
        axes.insert(d, s)
    return invoke("transpose", [data], {"axes": tuple(axes)})


# -- nd.random ----------------------------------------------------------------
random = _types.ModuleType(__name__ + ".random")
_sys.modules[random.__name__] = random
random.gamma = make_op_func(_registry.get_op("random_gamma"))
for _rn in ("uniform", "normal", "exponential", "poisson",
            "negative_binomial", "randint", "randn", "multinomial",
            "shuffle", "bernoulli"):
    setattr(random, _rn, make_op_func(_registry.get_op(_rn)))
random.seed = _random.seed

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall", "concatenate", "moveaxis", "random", "invoke",
           "invoke_count", "host_sync_count", "cpu", "current_context",
           "Context"]
