"""The operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``. Each operator is registered
once, by name, with:

- ``fn``: a pure torch function ``fn(*tensors, **attrs) -> tensor | tuple``.
  Tensor arguments are ``torch.Tensor``s, attrs are plain Python values;
  ``fn`` returns new tensors and mutates none of its inputs.
- ``num_inputs``: the number of leading tensor arguments (-1: variadic, the
  tensors passed as one list argument).
- ``num_outputs``: 1, or -1 where ``fn`` returns a tuple.
- ``differentiable``: whether ``invoke`` records the op under
  ``autograd.record()``; gradients are torch's own.
- ``rng_input`` / ``draws_key``: the reference's two random-number
  conventions, kept as declared fields (the reference's ``Dropout`` takes
  its key as an input, the samplers draw one when given none). In the port
  the ops draw from the generator of their device (``random.generator``),
  so neither field changes a call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["OpSchema", "register", "get_op", "find_op", "list_ops", "alias"]


@dataclass
class OpSchema:
    name: str
    fn: Callable
    num_inputs: int = 1
    num_outputs: int = 1
    differentiable: bool = True
    aliases: List[str] = field(default_factory=list)
    namespaces: List[str] = field(default_factory=lambda: ["nd"])
    doc: Optional[str] = None
    rng_input: bool = False
    draws_key: bool = False

    def __post_init__(self):
        if self.doc is None:
            self.doc = self.fn.__doc__


_OPS: Dict[str, OpSchema] = {}


def register(name: str, num_inputs: int = 1, num_outputs: int = 1,
             differentiable: bool = True, aliases: Sequence[str] = (),
             namespaces: Sequence[str] = ("nd",), rng_input: bool = False,
             draws_key: bool = False):
    """Decorator: register a pure torch function as an operator."""

    def deco(fn: Callable) -> Callable:
        schema = OpSchema(name=name, fn=fn, num_inputs=num_inputs,
                          num_outputs=num_outputs,
                          differentiable=differentiable,
                          aliases=list(aliases), namespaces=list(namespaces),
                          rng_input=rng_input, draws_key=draws_key)
        if name in _OPS:
            raise ValueError(f"operator '{name}' registered twice")
        _OPS[name] = schema
        for a in schema.aliases:
            if a in _OPS:
                raise ValueError(f"operator alias '{a}' registered twice")
            _OPS[a] = schema
        return fn

    return deco


def alias(existing: str, *names: str):
    schema = get_op(existing)
    for n in names:
        if n in _OPS:
            raise ValueError(f"operator alias '{n}' registered twice")
        _OPS[n] = schema
        schema.aliases.append(n)


def get_op(name: str) -> OpSchema:
    if name not in _OPS:
        raise KeyError(f"operator '{name}' not registered")
    return _OPS[name]


def find_op(name: str) -> Optional[OpSchema]:
    return _OPS.get(name)


def list_ops(namespace: Optional[str] = None) -> List[str]:
    if namespace is None:
        return sorted(set(s.name for s in _OPS.values()))
    return sorted(set(s.name for s in _OPS.values()
                      if namespace in s.namespaces))
