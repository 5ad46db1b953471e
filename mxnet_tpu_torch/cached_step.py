"""Compiled whole train step: forward, backward and the optimizer update as
one captured program.

Counterpart of ``mxnet_tpu/cached_step.py`` ``TrainStep`` (one device).
The reference traces the loss function's forward, its ``jax.vjp`` backward
and the fused optimizer update into ONE ``jax.jit`` program with donated
parameter and optimizer-state buffers, cached by input shapes and the
optimizer's signature; the per-step values (lr, wd, rescale_grad) ride in
as traced arguments, so a new learning rate or batch size never retraces.
Here the program is a CUDA graph (``program_store.Program``) captured over
static input buffers, and the per-step values are the optimizer's device
scalars (``Optimizer.scalars``), written before a replay when they change.
Parameters and optimizer states are updated in place at fixed addresses,
which is what the graph bakes in.

``step(*args, batch_size=None)`` is the compiled equivalent of::

    with autograd.record():
        loss = loss_fn(net, *args)
    autograd.backward(loss)          # ones over every loss element
    trainer.step(batch_size)

and returns the loss (a clone: the next replay overwrites the program's
own). Gradients are taken with ``torch.autograd.grad`` into the program's
buffers; parameter ``.grad``s are not touched on the compiled path, as the
reference does not materialize them there. The eager tape writes them as
usual.

Program key: the inputs' shapes, dtypes and device, the route knobs and
math flags (``program_store.knob_key``), which blocks of the net are
hybridized (the fused sites run only inside a hybridized call), the
optimizer's type and fixed hyper-parameters (momentum), and which tensors
hold every parameter and optimizer state (``Parameter.cast`` replaces
them and so re-captures, and the programs over the old tensors are
dropped; ``Parameter.set_data`` writes in place, which the next replay
reads).

Setups the reference also runs eagerly (``_eligibility``,
``cached_step.py:431-460``) take the eager tape and name their reason in
``last_fallback_reason``: ``MXNET_COMPILED_STEP=0``, a parameter with
``grad_req='add'``, a pending deferred initialization (the first call then
runs eagerly, as with ``hybridize``). One divergence by design: where the
reference falls back to the eager tape for good when tracing fails
(``cached_step.py:325-337``), a failed capture here raises, so that a
capture bug never hides behind a slower step. ``bucket=True`` and
``accum_steps > 1`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import autograd
from . import config as _config
from . import program_store as _pstore
from .gluon.block import hybridized_flags

__all__ = ["TrainStep", "enabled", "trace_count", "dispatch_count",
           "cache_stats", "reset_counters"]

_NS = _pstore.namespace("train_step")


def trace_count() -> int:
    """Captures of compiled train steps (the reference's traces)."""
    return _NS.traces


def dispatch_count() -> int:
    """Calls of compiled train-step programs."""
    return _NS.dispatches


def cache_stats() -> Dict[str, int]:
    return {"hits": _NS.hits, "misses": _NS.misses,
            "evictions": _NS.evictions}


def reset_counters() -> None:
    _NS.reset()


def enabled() -> bool:
    """Compiled-step knob on (MXNET_COMPILED_STEP, default 1)."""
    return bool(_config.get("MXNET_COMPILED_STEP"))


def _heads(loss) -> list:
    return list(loss) if isinstance(loss, (list, tuple)) else [loss]


class TrainStep:
    """One training step as one captured program
    (``Trainer.compile_step``); see the module docstring."""

    def __init__(self, net, loss_fn: Callable, trainer, bucket: bool = False,
                 accum_steps: int = 1):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if bucket:
            raise NotImplementedError(
                "compile_step(bucket=True) (shape-bucketed steps) is not "
                "ported to mxnet_tpu_torch yet (ROADMAP Queue A, A2)")
        if int(accum_steps) > 1:
            raise NotImplementedError(
                "compile_step(accum_steps > 1) (gradient-accumulation "
                "windows) is not ported to mxnet_tpu_torch yet (ROADMAP "
                "Queue A, A2)")
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._programs = _pstore.scope("train_step")
        # the reference's sticky reason after a failed trace; a failed
        # capture raises here instead, so this stays None
        self.fallback_reason: Optional[str] = None
        # why the LAST call ran the eager tape (None when it ran compiled)
        self.last_fallback_reason: Optional[str] = None

    @property
    def last_step_compiled(self) -> bool:
        return self.last_fallback_reason is None

    def __call__(self, *args, batch_size: Optional[int] = None):
        if batch_size is None:
            batch_size = int(args[0].shape[0]) \
                if args and getattr(args[0], "shape", ()) else 1
        reason = self._eligibility()
        self.last_fallback_reason = reason
        if reason is not None:
            return self._eager_step(args, batch_size)
        return self._compiled_step(args, batch_size)

    def _eligibility(self) -> Optional[str]:
        if not enabled():
            return "MXNET_COMPILED_STEP=0"
        for p in self._trainer._params:
            if p.grad_req == "add":
                return f"parameter '{p.name}' has grad_req='add'"
        for p in self._net.collect_params().values():
            if p._data is None:
                return ("deferred parameter init pending (first call runs "
                        "eagerly, like hybridize)")
        return None

    def _eager_step(self, args, batch_size):
        """The eager tape: record, backward with ones, ``trainer.step``."""
        with autograd.record():
            loss = self._loss_fn(self._net, *args)
        autograd.backward(_heads(loss))
        self._trainer.step(batch_size)
        return loss

    def _compiled_step(self, args, batch_size):
        tr = self._trainer
        opt = tr._optimizer
        states = tr._init_states()
        trainable = tr._params
        opt.rescale_grad = tr._scale / batch_size
        # the tensors the body reads and updates in place, by identity
        held = [p._data for p in self._net.collect_params().values()]
        held += [p._data for p in trainable]
        held += [s for s in states if isinstance(s, torch.Tensor)]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        others = tuple((i, a) for i, a in enumerate(args)
                       if not isinstance(a, torch.Tensor))
        key = (_pstore.tensor_key(tensors), others, _pstore.knob_key(),
               hybridized_flags(self._net),
               type(opt).__name__, opt.fixed_signature(),
               tuple(map(id, trainable)), _pstore.storage_key(held))
        return _pstore.run(
            self._programs, key, lambda: self._body(args, states), tensors,
            device=held[0].device, keep=held)

    def _body(self, args, states):
        """The program's body over its static inputs: the eager tape's
        forward and backward, with each trainable parameter read through a
        fresh leaf that shares its storage (so ``.grad`` and the
        parameters' hooks stay untouched), then the optimizer's update of
        the parameters themselves."""
        net, loss_fn = self._net, self._loss_fn
        opt, trainable = self._trainer._optimizer, self._trainer._params
        slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        consts = [None if i in slots else a for i, a in enumerate(args)]

        def body(*inputs):
            call_args = list(consts)
            for i, t in zip(slots, inputs):
                call_args[i] = t
            weights = [p._data for p in trainable]
            leaves = [w.detach().requires_grad_() for w in weights]
            try:
                for p, leaf in zip(trainable, leaves):
                    p._data = leaf
                with autograd.record():
                    loss = loss_fn(net, *call_args)
                heads = _heads(loss)
                grads = torch.autograd.grad(
                    heads, leaves, [torch.ones_like(h) for h in heads],
                    allow_unused=True)
            finally:
                for p, w in zip(trainable, weights):
                    p._data = w
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, weights)]
            opt.step(weights, grads, states)
            if isinstance(loss, (list, tuple)):
                return type(loss)(h.detach() for h in loss)
            return loss.detach()

        return body
