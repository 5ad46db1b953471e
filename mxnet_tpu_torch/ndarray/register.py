"""Python functions for the registered operators.

Counterpart of ``mxnet_tpu/ndarray/register.py``: the registered function's
signature says which leading parameters are arrays (``num_inputs``) and
which are attrs, and attrs may be passed by position, the MXNet way
(``nd.reshape(x, (2, 3))``). Array arguments that are not NDArrays are
made into NDArrays on the first NDArray argument's context; an op without
array inputs runs in the context given by ``ctx=`` (else the current one).
"""
from __future__ import annotations

import inspect
from typing import Callable

from ..context import current_context
from ..ops.registry import OpSchema
from .ndarray import NDArray, array, invoke

__all__ = ["make_op_func"]

_DROP = ("name", "ctx", "dtype_hint")


def _attrs(names, rest, kwargs) -> dict:
    attrs = dict(zip(names, rest))
    attrs.update({k: v for k, v in kwargs.items() if k not in _DROP})
    return {k: (v._data if isinstance(v, NDArray) else v)
            for k, v in attrs.items()}


def make_op_func(schema: OpSchema) -> Callable:
    params = list(inspect.signature(schema.fn).parameters)

    if schema.num_inputs == -1:
        attr_names = params[1:]

        def fn(*args, out=None, **kwargs):
            arrays, rest = [], []
            for a in args:
                if isinstance(a, NDArray):
                    arrays.append(a)
                elif not arrays and not rest and isinstance(
                        a, (list, tuple)) and a and isinstance(a[0], NDArray):
                    arrays.extend(a)
                else:
                    rest.append(a)
            return invoke(schema, arrays, _attrs(attr_names, rest, kwargs),
                          out=out)

    elif schema.num_inputs == 0:
        attr_names = params

        def fn(*args, out=None, ctx=None, **kwargs):
            with ctx or current_context():
                return invoke(schema, [], _attrs(attr_names, args, kwargs),
                              out=out)

    else:
        n_in = schema.num_inputs
        attr_names = params[n_in:]

        def fn(*args, out=None, **kwargs):
            n_take = n_in
            # rng-input ops (Dropout): a value in the key slot that is not
            # an array is an MXNet positional attr (nd.Dropout(x, 0.5))
            if schema.rng_input and len(args) >= n_in and not isinstance(
                    args[n_in - 1], NDArray):
                n_take = n_in - 1
            arrays = list(args[:n_take])
            ctx = next((a._ctx for a in arrays if isinstance(a, NDArray)),
                       None)
            arrays = [a if a is None or isinstance(a, NDArray)
                      else array(a, ctx=ctx) for a in arrays]
            while arrays and arrays[-1] is None:
                arrays.pop()
            if schema.rng_input and len(arrays) == n_in - 1:
                kwargs.pop("key", None)
                arrays.append(None)
            return invoke(schema, arrays,
                          _attrs(attr_names, args[n_take:], kwargs), out=out)

    fn.__name__ = schema.name
    fn.__doc__ = schema.doc
    return fn
