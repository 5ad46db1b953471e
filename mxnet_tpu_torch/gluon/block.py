"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``. ``Block`` keeps the
reference's contract: assigning a Block or Parameter attribute registers
it, ``collect_params`` walks the tree with the reference's structural names
(``features.4.0.body.0.weight``), a parameter of unknown shape is completed
by the layer's ``infer_shape`` on the first call, and ``cast``,
``load_dict`` and ``zero_grad`` act on every parameter. Blocks take and
return ``torch.Tensor``s.

A hybridized block called outside ``autograd.record()`` runs its forward
as a captured program (``program_store``, namespace ``hybrid_forward``):
the counterpart of the reference's cached forward (``block.py:621-700``).
Its key: the inputs' shapes, dtypes and device, ``autograd.is_training()``,
the route knobs and math flags, and which tensors hold the parameters
(``cast`` replaces them and so re-captures). It returns clones of the
program's outputs, as the reference returns fresh arrays; batch-norm
running statistics that a training-mode forward updates are updated in
place by every replay. Under ``record()`` a hybridized block runs eagerly:
its training counterpart is ``Trainer.compile_step``. (The reference
records a hybridized forward as one tape node; that is not ported yet.)

While the outermost hybridized block runs (its parameters initialized),
:func:`in_hybridized_call` is true. The fused ResNet epilogue reads it
where the reference asks whether it is being traced, so eager calls never
take the fused sites, as in the reference.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from .. import autograd, initializer
from .. import program_store as _pstore
from ..context import resolve_device
from .parameter import DeferredInitializationError, Parameter

__all__ = ["Block", "HybridBlock", "in_hybridized_call", "hybridized_flags"]


class _Hybrid(threading.local):
    def __init__(self):
        super().__init__()
        self.depth = 0


_HYBRID = _Hybrid()


def in_hybridized_call() -> bool:
    """True while a hybridized block (with its parameters initialized)
    runs its forward: the port's stand-in for the reference's trace."""
    return _HYBRID.depth > 0


def hybridized_flags(block: "Block") -> tuple:
    """Which blocks of ``block``'s tree are hybridized, in tree order: what
    :func:`in_hybridized_call` reads while the tree runs (part of a
    captured step's key)."""
    out = []

    def walk(b):
        out.append(getattr(b, "_active", False))
        for child in b._children.values():
            walk(child)

    walk(block)
    return tuple(out)


class Block:
    """Base class of layers and models."""

    _default_ctx = None      # the device ``initialize`` uses when given none

    def __init__(self):
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.__dict__.get("_children", {})[name] = value
        elif isinstance(value, Parameter):
            if "_reg_params" not in self.__dict__:
                raise RuntimeError("Block.__init__() must be called before "
                                   "assigning Parameters")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block: "Block") -> None:
        """Register ``block`` as the next numbered child ("0", "1", ...)."""
        self._children[str(len(self._children))] = block

    # -- params ----------------------------------------------------------
    def collect_params(self) -> "OrderedDict[str, Parameter]":
        """Structural name -> Parameter over the whole tree: a block's own
        parameters first, then its children's under ``<child name>.``."""
        out: "OrderedDict[str, Parameter]" = OrderedDict()

        def walk(block: "Block", prefix: str):
            for name, p in block._reg_params.items():
                out[prefix + name] = p
            for cname, child in block._children.items():
                walk(child, prefix + cname + ".")

        walk(self, "")
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        """Initialize every parameter on ``ctx`` (the block's default
        device, else ``cuda``; raises without CUDA unless given the CPU),
        filled by ``init`` (default ``Uniform()``) where the parameter has
        no initializer of its own."""
        device = resolve_device(ctx if ctx is not None
                                else self._default_ctx)
        init = initializer.create(init)
        for p in self.collect_params().values():
            p.initialize(None, device, default_init=init,
                         force_reinit=force_reinit)

    def load_dict(self, param_dict) -> None:
        """Set every parameter by structural name from tensors or arrays;
        raises ``KeyError`` on a missing or extra name."""
        params = self.collect_params()
        missing = sorted(set(params) - set(param_dict))
        extra = sorted(set(param_dict) - set(params))
        if missing or extra:
            raise KeyError(f"param names differ from the block's: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for k, v in param_dict.items():
            params[k].set_data(v)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self) -> None:
        for p in self.collect_params().values():
            p.zero_grad()

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def infer_shape(self, *args):
        raise ValueError(
            f"{type(self).__name__} has parameters with unknown shape. You "
            "must implement infer_shape(self, *args) for deferred "
            "initialization, or specify input sizes explicitly.")

    def _deferred_infer_shape(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init:
                p._finish_deferred_init()

    # -- execution -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        try:
            return self.forward(*args, **kwargs)
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """A block that can be hybridized (see the module docstring). As in the
    reference, only the outermost block's flag counts, since ``hybridize``
    clears the children's, and each ``hybridize`` call drops the block's
    programs."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._programs = None

    def hybridize(self, active: bool = True, **kwargs) -> None:
        self._active = bool(active)
        self._programs = None
        super().hybridize(False, **kwargs)

    def __call__(self, *args, **kwargs):
        if not self._active:
            return super().__call__(*args, **kwargs)
        params = self.collect_params()
        if any(p._data is None for p in params.values()):
            # a first call that completes deferred initialization runs
            # eagerly, as in the reference
            return super().__call__(*args, **kwargs)
        _HYBRID.depth += 1
        try:
            if kwargs or autograd.is_recording() or _pstore.in_program() \
                    or not args or not all(isinstance(a, torch.Tensor)
                                           for a in args):
                return super().__call__(*args, **kwargs)
            return self._call_cached(args, params)
        finally:
            _HYBRID.depth -= 1

    def _call_cached(self, args, params):
        """The forward as a program of this block's ``hybrid_forward``
        scope, run with torch's grad mode off."""
        if self._programs is None:
            self._programs = _pstore.scope("hybrid_forward")
        held = [p._data for p in params.values()]
        key = (_pstore.tensor_key(args), autograd.is_training(),
               _pstore.knob_key(), _pstore.storage_key(held))

        def body(*inputs):
            with torch.no_grad():
                return Block.__call__(self, *inputs)

        return _pstore.run(self._programs, key, lambda: body, args,
                           keep=held)
