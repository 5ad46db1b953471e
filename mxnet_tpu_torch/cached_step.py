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

The body runs as the port's trace (``gluon.block.traced_call``), so the
fused ResNet sites run in every compiled step, as the reference fuses them
wherever it traces: whether the net or any of its blocks is hybridized
changes nothing inside a step (a hybridized block called inside a program
runs its forward eagerly there), and so it is not part of the key.

Program key: the inputs' shapes, dtypes and device, the route knobs and
math flags (``program_store.knob_key``), the optimizer's type and fixed
hyper-parameters (momentum), and which tensors hold every parameter and
optimizer state (``Parameter.cast`` replaces them and so re-captures, and
the programs over the old tensors are dropped; ``Parameter.set_data``
writes in place, which the next replay reads).

``accum_steps=N`` (reference ``cached_step.py:1015-1211``): a grad program
a micro-batch adds its gradients into accumulators at fixed addresses, and
the window's last micro-batch also runs one update program from the sums,
with ``batch_size x N`` as the divisor: N + 1 dispatches and one optimizer
update a window. A setup that takes the eager tape raises ``MXNetError``
instead, since the tape cannot keep a window.

``bucket=True`` (reference ``cached_step.py:349-428``): every tensor
argument's batch axis is padded up to its bucket (``serving.BucketPolicy``,
``MXNET_SHAPE_BUCKETS``), so a stream of batch sizes shares one program a
bucket. The first call of each bucketed signature checks the padded loss
against the unpadded one bitwise, with the parameters and running
statistics restored after; a mismatch refuses bucketing for good
(``bucket_refused``). ``padded_steps`` counts the padded calls.

Setups the reference also runs eagerly (``_eligibility``,
``cached_step.py:431-460``) take the eager tape and name their reason in
``last_fallback_reason``: ``MXNET_COMPILED_STEP=0``, a parameter with
``grad_req='add'``, a pending deferred initialization (the first call then
runs eagerly, as with ``hybridize``). One divergence by design: where the
reference falls back to the eager tape for good when tracing fails
(``cached_step.py:325-337``), a failed capture here raises, so that a
capture bug never hides behind a slower step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import autograd
from . import config as _config
from . import program_store as _pstore
from . import serving as _serving
from .base import MXNetError
from .gluon.block import traced_call

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
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._programs = _pstore.scope("train_step")
        # gradient accumulation: the window's update program keeps its own
        # scope, so that a grad program's capture never drops it
        self._accum_steps = int(accum_steps)
        self._update_programs = _pstore.scope("train_step")
        self._accum_bufs: Optional[list] = None
        self._accum_key = None
        self._accum_i = 0
        # shape bucketing (serving.BucketPolicy), verified once per bucket
        self._bucket = bool(bucket)
        self.bucket_refused: Optional[str] = None
        self._bucket_verified: set = set()
        self.padded_steps = 0
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
        pargs = self._maybe_pad(args)
        if self._accum_steps > 1:
            return self._accum_step(pargs, batch_size)
        return self._compiled_step(pargs, batch_size)

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
        """The eager tape: record, backward with ones, ``trainer.step``.
        An accumulation window refuses it: the tape applies one update a
        call, which would turn a window of N calls into N steps."""
        if self._accum_steps > 1:
            raise MXNetError(
                f"accum_steps={self._accum_steps} requires the compiled "
                "step (one update a window); the eager tape cannot honor "
                f"the window, fallback reason: {self.last_fallback_reason}")
        with autograd.record():
            loss = self._loss_fn(self._net, *args)
        autograd.backward(_heads(loss))
        self._trainer.step(batch_size)
        return loss

    # -- shape bucketing --------------------------------------------------
    def _maybe_pad(self, args):
        """The batch axis of every tensor argument padded up to its bucket
        (``serving.BucketPolicy``) with ``bucket=True``, so that a stream
        of batch sizes shares one program a bucket. The first call of each
        bucketed signature checks the padded loss against the unpadded one
        bitwise (``MXNET_SERVE_VERIFY``): a loss that is not pad-safe
        refuses bucketing for good, before any padded gradient is
        applied."""
        if not self._bucket or self.bucket_refused is not None:
            return args
        policy = _serving.BucketPolicy()
        leaves = [a for a in args if isinstance(a, torch.Tensor)]
        if not policy.enabled or not leaves or \
                any(a.dim() < 1 for a in leaves):
            return args
        n = int(leaves[0].shape[0])
        b = policy.bucket(n)
        if b is None or b == n:
            return args
        pargs = tuple(_serving.pad_axis0(a, b)
                      if isinstance(a, torch.Tensor) and int(a.shape[0]) == n
                      else a for a in args)
        key = (b, _pstore.tensor_key(leaves))
        ns = _pstore.namespace("serving")
        if key in self._bucket_verified:
            ns.bump("hits")
        else:
            ns.bump("misses")
            if _config.get("MXNET_SERVE_VERIFY"):
                reason = self._verify_pad(args, pargs)
                if reason is not None:
                    self.bucket_refused = reason
                    return args
            self._bucket_verified.add(key)
        self.padded_steps += 1
        return pargs

    def _verify_pad(self, args, pargs) -> Optional[str]:
        """The loss of the true and of the padded batch, recording off and
        in training mode, with every parameter (batch-norm running
        statistics too) restored after; None when they are bitwise equal,
        else the reason to refuse."""
        held = [p._data for p in self._net.collect_params().values()
                if p._data is not None]
        snap = [t.detach().clone() for t in held]
        try:
            with autograd.pause(train_mode=True):
                lt = _heads(self._loss_fn(self._net, *args))
                lp = _heads(self._loss_fn(self._net, *pargs))
        finally:
            with torch.no_grad():
                for t, v in zip(held, snap):
                    t.copy_(v)
        if len(lt) != len(lp) or not all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(lt, lp)):
            return ("padded loss differs from unpadded: the loss is not "
                    "pad-safe (mask the pad rows, with a sum-style masked "
                    "reduction)")
        return None

    # -- the compiled step ------------------------------------------------
    def _call_parts(self, args):
        """(the tensor arguments, the others by position)."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        others = tuple((i, a) for i, a in enumerate(args)
                       if not isinstance(a, torch.Tensor))
        return tensors, others

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
        tensors, others = self._call_parts(args)
        key = (_pstore.tensor_key(tensors), others, _pstore.knob_key(),
               type(opt).__name__, opt.fixed_signature(),
               tuple(map(id, trainable)), _pstore.storage_key(held))

        def build():
            fb = self._forward_backward(args)

            def body(*inputs):
                loss, weights, grads = fb(*inputs)
                opt.step(weights, grads, states)
                return loss
            return body

        return _pstore.run(self._programs, key, build, tensors,
                           device=held[0].device, keep=held)

    def _forward_backward(self, args):
        """The body's forward and backward over its static inputs: the
        eager tape's, inside the port's trace (``traced_call``), with each
        trainable parameter read through a fresh leaf that shares its
        storage (so ``.grad`` and the parameters' hooks stay untouched).
        Returns fb(*inputs) -> (detached loss, the parameters' tensors,
        their gradients)."""
        net, loss_fn = self._net, self._loss_fn
        trainable = self._trainer._params
        slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        consts = [None if i in slots else a for i, a in enumerate(args)]

        def fb(*inputs):
            call_args = list(consts)
            for i, t in zip(slots, inputs):
                call_args[i] = t
            weights = [p._data for p in trainable]
            leaves = [w.detach().requires_grad_() for w in weights]
            try:
                for p, leaf in zip(trainable, leaves):
                    p._data = leaf
                with traced_call():
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
            if isinstance(loss, (list, tuple)):
                loss = type(loss)(h.detach() for h in loss)
            else:
                loss = loss.detach()
            return loss, weights, grads

        return fb

    # -- gradient accumulation (compile_step(accum_steps=N)) --------------
    def _accum_step(self, args, batch_size):
        """One micro-batch of a window: the grad program adds this
        micro-batch's gradients into accumulators at fixed addresses; the
        window's last micro-batch also runs the update program, one
        optimizer update from the sums with ``rescale_grad = scale /
        (batch_size x accum_steps)``, which zeroes the accumulators. N + 1
        dispatches and one update a window (reference
        ``cached_step.py:1015-1211``). Returns the micro-batch's loss."""
        tr = self._trainer
        opt = tr._optimizer
        trainable = tr._params
        weights = [p._data for p in trainable]
        wkey = _pstore.storage_key(weights)
        if self._accum_key != wkey:
            with torch.no_grad():
                self._accum_bufs = [torch.zeros_like(w) for w in weights]
            self._accum_key = wkey
            self._accum_i = 0
        accs = self._accum_bufs
        held = [p._data for p in self._net.collect_params().values()]
        held += weights + accs
        tensors, others = self._call_parts(args)
        key = ("accum_grad", _pstore.tensor_key(tensors), others,
               _pstore.knob_key(), tuple(map(id, trainable)),
               _pstore.storage_key(held))

        def build_grad():
            fb = self._forward_backward(args)

            def body(*inputs):
                loss, _weights, grads = fb(*inputs)
                with torch.no_grad():
                    torch._foreach_add_(accs, grads)
                return loss
            return body

        loss = _pstore.run(self._programs, key, build_grad, tensors,
                           device=held[0].device, keep=held)
        self._accum_i += 1
        if self._accum_i < self._accum_steps:
            return loss
        self._accum_i = 0
        states = tr._init_states()
        opt.rescale_grad = tr._scale / (batch_size * self._accum_steps)
        uheld = weights + accs + [s for s in states
                                  if isinstance(s, torch.Tensor)]
        ukey = ("accum_update", type(opt).__name__, opt.fixed_signature(),
                _pstore.storage_key(uheld))

        def update():
            opt.step(weights, accs, states)
            with torch.no_grad():
                torch._foreach_zero_(accs)
            return ()

        _pstore.run(self._update_programs, ukey, lambda: update, [],
                    device=weights[0].device, keep=uheld)
        return loss
