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
own). The forward runs inside ``parallel.moe.aux_scope``: the load-balance
aux losses that ``MoEBlock``s record there are summed, weighted by
``MXNET_MOE_AUX_WEIGHT`` and differentiated as one more head, on the
compiled path and on the eager tape alike (reference ``cached_step.py:
503-512, :1249``), while the returned loss stays the user's. Gradients
are taken with ``torch.autograd.grad`` into the program's buffers;
parameter ``.grad``s are not touched on the compiled path, as the
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

Under a mesh (``Trainer(kvstore='tpu' | 'nccl')``, the mesh of
``parallel.spmd.mesh_for_store``; reference ``cached_step.py:244-264,
:486-488, :581-638, :662-679, :819-831, :928-933, :1025-1034,
:1114-1116``) the step is still one program a call on each rank of the
world, keyed on ``spmd.mesh_key``, with the collectives inside it by
``parallel.spmd``'s rules. The call takes the global batch. The net that
``loss_fn`` is handed runs on this rank's rows of the batch over ``dp``
(tensor arguments of the net call with the batch's rows; an indivisible
batch stays whole on every rank, loudly) and returns the outputs gathered
over ``dp``, so ``loss_fn`` sees the global outputs beside the global
labels and every rank computes the global loss, seeded ``1/dp``. Batch
norm inside that call takes the global batch's moments. At the first call
on the mesh, parameters and optimizer state are placed once as this
rank's block of ``spmd.param_spec`` (the ``fsdp`` rule; ``p.data()`` is
then the block, :meth:`TrainStep.full_params` gathers them); the program
gathers the blocks before the forward and reduces the gradients to the
blocks (``spmd.reduce_grad``). ``spmd.reshard_count`` counts the
placements and stays flat after it. With ``MXNET_COMPILED_STEP=0`` the
same body runs without a program. A ``tp`` axis above 1 reaches the model
through ``sharding.constraint``. The packed pipeline stage buffer
(``pp_stages``) is placed over ``pp`` and expert weights over ``ep`` by
``spmd.param_spec``'s name rules. The MoE aux losses recorded on a batch
split over ``dp`` are folded as the whole batch's (the members' mean, its
gradient summed over them). Bucketing's pad check runs the net on the
whole batch with the split parameters gathered whole. A net's
``compiled_grad_transform`` (``PipelineBlock``'s tied gradients) is
applied to the whole gradients after the backward, each rank keeping its
block. Under a mesh ``grad_req='add'`` raises. On a mesh of more than one rank no call takes
the eager tape, which would update each rank's own values over the whole
batch: a pending deferred initialization is finished by a forward that
records nothing, and the first step then places the first rank's values.

``attach_sentinel(sentinel)`` (reference ``cached_step.py:209-221,
:937-970``): the step keeps a second form of its program, the digest form,
which runs the same forward, backward and update and also emits
``sentinel.program_digest`` of the post-update parameters and optimizer
state and of the gradients. Both forms are captured at the step's first
compiled call (the digest form through ``Program.prepare``, with every
tensor it updates put back after its eager run), so that a sentinel step
is one dispatch of the digest form with no capture and no host read: the
counterpart of the reference's ``lax.cond`` on a traced flag. The digest
goes to ``sentinel.offer`` unread. The plain form is the program it was.
Accumulation windows (``accum_steps`` above 1) take no digest.

AMP (reference ``cached_step.py:101-130, :270-300, :460-530, :875-1010,
:1090-1210``): with a loss scaler on the trainer (``amp.init_trainer``)
the program multiplies the heads by the loss scale inside the recorded
region, computes the all-finite flag of the gradients on the device
(all-reduced, AND, over a mesh) and updates with ``where(ok, new, old)``
(``Optimizer.step(ok=, rescale=)``), so that an overflowed step leaves
every weight and state bitwise as it was. The scale and the divisor ride
in static device scalars, so a new scale never captures anew. Under
``MXNET_AMP_LAG=1`` (``engine.amp_lag``) the gate is deferred: while step
N-1's flag is unread, step N carries both candidates of
``LossScaler.branch_scales`` and the program picks by that flag, which the
program itself left in a device scalar; its copy to pinned host memory is
read (``deferred_read_count``) after step N is launched, and moves the
host's scaler. The result is bitwise the synchronous gate's
(``MXNET_AMP_LAG=0``: the flag read after its own step). :meth:`TrainStep.
drain` reads a pending flag; ``engine.waitall``, the eager tape and the
lag window's close call it. An accumulation window holds one pair of
candidates throughout, and its update program takes the flag of the
summed gradients. An overflow emits the telemetry event
``amp_overflow``.

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

import contextlib
from typing import Callable, Dict, Optional

import torch

from . import autograd
from . import config as _config
from . import engine as _engine
from . import program_store as _pstore
from . import serving as _serving
from . import telemetry as _telemetry
from .base import MXNetError
from .gluon.block import traced_call
from .ndarray import ndarray as _ndmod
from .ndarray.ndarray import NDArray, _wrap
from .optimizer import fused as _fused
from .optimizer.optimizer import state_leaves as _state_leaves
from .parallel import moe as _moe

__all__ = ["TrainStep", "enabled", "trace_count", "dispatch_count",
           "cache_stats", "deferred_read_count", "reset_counters"]

_NS = _pstore.namespace("train_step")
_DEFERRED_READ = _telemetry.counter(
    "cached_step.deferred_read",
    "host reads of a lagged all-finite flag (the deferred AMP gate, "
    "MXNET_AMP_LAG): each reads step N-1's flag after step N is launched")


def deferred_read_count() -> int:
    """Host reads of a lagged all-finite flag (the deferred AMP gate)."""
    return int(_DEFERRED_READ.value)


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


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _fold_aux(auxes, heads) -> list:
    """The recorded MoE aux losses folded into the differentiated heads as
    ONE more head, ``MXNET_MOE_AUX_WEIGHT * sum`` in fp32, seeded with a
    unit cotangent like every head, so that its gradient reaches the
    optimizer while the loss the caller sees stays untouched."""
    if not auxes:
        return heads
    aux_w = float(_config.get("MXNET_MOE_AUX_WEIGHT"))
    at = auxes[0]
    for a in auxes[1:]:
        at = at + a
    return list(heads) + [(at * aux_w).float()]


class _AmpGate:
    """The AMP gate's device state of one step on one device: ``vals``,
    fp32 (scale, scale if the previous step overflowed, divisor, divisor if
    it overflowed), written when they change; ``prev_ok``, the flag the
    last program left (the next one picks its candidates by it); and the
    pinned host copies of flags still to be read."""

    def __init__(self, device):
        self.vals = torch.ones(4, dtype=torch.float32, device=device)
        self.prev_ok = torch.ones((), dtype=torch.bool, device=device)
        self.host = None
        self.lag = 0
        self._written = (1.0, 1.0, 1.0, 1.0)
        self._flip = 0
        if device.type == "cuda":
            self.host = [torch.ones((), dtype=torch.bool, pin_memory=True)
                         for _ in range(2)]

    def write(self, values) -> None:
        values = tuple(float(v) for v in values)
        for i, (v, w) in enumerate(zip(values, self._written)):
            if v != w:
                self.vals[i].fill_(v)       # a fill kernel: no host sync
        self._written = values

    def effective(self):
        """(scale, divisor) as the device picks them: the first pair after
        a clean (or no) previous step, else the second."""
        pick = torch.where(self.prev_ok, self.vals[0::2], self.vals[1::2])
        return pick[0], pick[1]

    def leave(self, ok) -> None:
        """Inside the program: the flag this step leaves for the next."""
        self.prev_ok.copy_(ok)

    def pending(self):
        """The flag the last program left, to be read later without waiting
        on programs launched after it: on a CUDA device a copy to pinned
        memory and an event behind it; elsewhere a copy."""
        if self.host is None:
            return self.prev_ok.clone(), None
        buf = self.host[self._flip]
        self._flip ^= 1
        buf.copy_(self.prev_ok, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev


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
        # the positions of the call's NDArray arguments and their contexts:
        # the compiled path runs on their tensors and hands loss_fn NDArrays
        self._nd: Dict[int, object] = {}
        # the mesh of the trainer's kvstore (resolved at the first call),
        # each parameter's spec on it once placed, and this call's batch
        # axes and rows
        self._mesh_resolved = False
        self._mesh = None
        self._specs: Optional[Dict[int, tuple]] = None
        self._batch_axes: tuple = ()
        self._rows: Optional[int] = None
        # the training-integrity sentinel (sentinel.Sentinel), if attached
        self._sentinel = None
        # the AMP gate's device state by device, and the flag of the last
        # program not read yet on the host (the deferred gate)
        self._amp: Dict[torch.device, _AmpGate] = {}
        self._pending_ok = None
        _engine.register_drainable(self)

    def attach_sentinel(self, sentinel):
        """Attach a ``sentinel.Sentinel``: it picks the dispatches that run
        the digest form (``want_digest``) and takes their digests
        (``offer``)."""
        if self._accum_steps > 1:
            raise MXNetError("a sentinel takes its digests from the step "
                             "program; accumulation windows take none")
        self._sentinel = sentinel
        return sentinel

    def digest_leaves(self) -> list:
        """The live tensors the digest form folds, in its order: every
        trainable parameter, then every optimizer state leaf (what
        ``sentinel.tree_digest`` of the same state takes)."""
        tr = self._trainer
        states = tr._init_states()
        return [p._data for p in tr._params] + _state_leaves(states)

    @property
    def mesh(self):
        """The mesh this step runs over (None: one device)."""
        return self._resolve_mesh()

    def _resolve_mesh(self):
        if not self._mesh_resolved:
            from .parallel import spmd as _spmd

            self._mesh = _spmd.mesh_for_store(
                getattr(self._trainer, "_kv_type", None))
            self._mesh_resolved = True
        return self._mesh

    @property
    def last_step_compiled(self) -> bool:
        return self.last_fallback_reason is None

    # -- the AMP gate -------------------------------------------------------
    def _scaler(self):
        return getattr(self._trainer, "_amp_loss_scaler", None)

    def drain(self) -> None:
        """Read the pending all-finite flag, if any, and apply the loss
        scale policy, so that the host's scaler catches up with the device
        (``engine.waitall``, the eager tape and the lag window's close call
        it); after it the scaler is the synchronous gate's, bitwise."""
        prev, self._pending_ok = self._pending_ok, None
        if prev is not None:
            self._read_flag(prev, "drain", deferred=True)

    def _read_flag(self, pending, where: str, deferred: bool) -> None:
        """The one host read of a step's flag, and the scale policy."""
        buf, ev = pending
        if ev is not None:
            ev.synchronize()
        _ndmod._HOST_SYNC.inc()
        if deferred:
            _DEFERRED_READ.inc()
        overflow = not bool(buf)
        if overflow:
            _telemetry.event("amp_overflow", "cached_step", where=where)
        scaler = self._scaler()
        if scaler is not None:
            scaler.update_scale(overflow)

    def _gate(self, device, batch_size, accum: int = 1):
        """The gate of this dispatch, or None without a scaler: the lag
        (a closed window first drains), the scale candidates written to
        the device, and the gate's state."""
        scaler = self._scaler()
        if scaler is None:
            return None
        lag = _engine.amp_lag()
        if not lag:
            self.drain()
        if lag and self._pending_ok is not None:
            s_clean, s_over = scaler.branch_scales()
        else:
            s_clean = s_over = scaler.loss_scale
        tr = self._trainer
        tr._amp_original_scale = getattr(tr, "_amp_original_scale",
                                         tr._scale)
        base = tr._amp_original_scale
        gate = self._amp.get(device)
        if gate is None:
            gate = self._amp[device] = _AmpGate(device)
        gate.write((s_clean, s_over, base / (s_clean * batch_size * accum),
                    base / (s_over * batch_size * accum)))
        gate.lag = lag
        return gate

    def _after_update(self, gate) -> None:
        """After an update program's launch: hold its flag (lag 1), reading
        the previous one now, or read its own (lag 0)."""
        if gate is None:
            return
        pending = gate.pending()
        if gate.lag:
            prev, self._pending_ok = self._pending_ok, pending
            if prev is not None:
                self._read_flag(prev, "deferred", deferred=True)
        else:
            self._read_flag(pending, "sync", deferred=False)

    def __call__(self, *args, batch_size: Optional[int] = None):
        if batch_size is None:
            batch_size = int(args[0].shape[0]) \
                if args and getattr(args[0], "shape", ()) else 1
        mesh = self._resolve_mesh()
        if mesh is not None and mesh.size > 1 and self._specs is None:
            self._finish_init(args)
        reason = self._eligibility()
        self.last_fallback_reason = reason
        if reason is not None and (mesh is None or self._specs is None
                                   and reason != "MXNET_COMPILED_STEP=0"):
            return self._eager_step(args, batch_size)
        # NDArray arguments (the reference's tests feed mx.nd.array): the
        # program takes their tensors, loss_fn gets them rewrapped, and the
        # loss comes back as an NDArray on the first one's context
        self._nd = {i: a.ctx for i, a in enumerate(args)
                    if isinstance(a, NDArray)}
        args = tuple(map(_tensor, args))
        if mesh is not None:
            self._place(mesh)
        pargs = self._maybe_pad(args)
        if mesh is not None:
            # the rows the step splits are the padded batch's
            self._split_batch(mesh, pargs)
        if self._accum_steps > 1:
            loss = self._accum_step(pargs, batch_size)
        else:
            loss = self._compiled_step(pargs, batch_size)
        if self._nd:
            ctx = next(iter(self._nd.values()))
            loss = type(loss)(_wrap(h, ctx) for h in loss) \
                if isinstance(loss, (list, tuple)) else _wrap(loss, ctx)
        return loss

    def _user_args(self, args, nd=None) -> tuple:
        """``args`` as loss_fn takes them: the NDArray positions rewrapped
        (``nd``, else the call's)."""
        nd = self._nd if nd is None else nd
        return tuple(_wrap(a, nd[i]) if i in nd else a
                     for i, a in enumerate(args))

    def _eligibility(self) -> Optional[str]:
        if not enabled():
            return "MXNET_COMPILED_STEP=0"
        for p in self._trainer._params:
            if p.grad_req == "add":
                if self._resolve_mesh() is not None:
                    raise MXNetError(
                        f"parameter '{p.name}' has grad_req='add', which "
                        "the step on a mesh does not take")
                return f"parameter '{p.name}' has grad_req='add'"
        for p in self._net.collect_params().values():
            if p._data is None:
                return ("deferred parameter init pending (first call runs "
                        "eagerly, like hybridize)")
        return None

    def _finish_init(self, args) -> None:
        """On a mesh of more than one rank, parameters still to be inferred
        are made by a forward that records nothing, so that the first
        step places the first rank's values on every rank: the eager
        tape's first step would update each rank's own values over the
        whole batch, with no reduction."""
        params = self._net.collect_params().values()
        if all(p._data is not None for p in params):
            return
        with autograd.pause(), _moe.aux_scope():
            self._loss_fn(self._net, *args)
        for p in params:
            if p._data is None:
                raise MXNetError(
                    f"parameter '{p.name}' is still uninitialized after a "
                    "forward; the step on a mesh of more than one rank "
                    "takes no eager first step")

    def _eager_step(self, args, batch_size):
        """The eager tape: record, backward with ones, ``trainer.step``.
        An accumulation window refuses it: the tape applies one update a
        call, which would turn a window of N calls into N steps."""
        if self._accum_steps > 1:
            raise MXNetError(
                f"accum_steps={self._accum_steps} requires the compiled "
                "step (one update a window); the eager tape cannot honor "
                f"the window, fallback reason: {self.last_fallback_reason}")
        # a pending flag lands first: this step reads the host's scale
        self.drain()
        scaler = self._scaler()
        with autograd.record():
            with _moe.aux_scope() as auxes:
                loss = self._loss_fn(self._net, *args)
            heads = _fold_aux(auxes, _heads(loss))
            if scaler is not None and scaler.loss_scale != 1.0:
                heads = [h * scaler.loss_scale for h in heads]
        autograd.backward(heads)
        hook = getattr(self._net, "compiled_grad_transform", None)
        if hook is not None:
            params = self._net.collect_params()
            named = {n: p._data.grad for n, p in params.items()
                     if p.grad_req != "null" and p._data.grad is not None}
            for n, g in hook(dict(named)).items():
                if named.get(n) is not g:
                    params[n]._data.grad = g
        tr = self._trainer
        if scaler is not None:
            base = getattr(tr, "_amp_original_scale", tr._scale)
            tr._amp_original_scale = base
            tr._scale = base / scaler.loss_scale
        tr.step(batch_size)
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
        else the reason to refuse. On a mesh that splits parameters, every
        rank runs both on the whole batch with the parameters gathered
        whole, put back after."""
        swapped = []
        if self._specs:
            from .parallel import spmd as _spmd

            for p in self._net.collect_params().values():
                spec = self._specs.get(id(p))
                if spec and p._data is not None:
                    swapped.append((p, p._data))
                    p._data = _spmd.gather_full(p._data.detach(), spec,
                                                self._mesh)
        held = [p._data for p in self._net.collect_params().values()
                if p._data is not None]
        snap = [t.detach().clone() for t in held]
        try:
            with autograd.pause(train_mode=True):
                lt = [_tensor(h) for h in _heads(
                    self._loss_fn(self._net, *self._user_args(args)))]
                lp = [_tensor(h) for h in _heads(
                    self._loss_fn(self._net, *self._user_args(pargs)))]
        finally:
            with torch.no_grad():
                for t, v in zip(held, snap):
                    t.copy_(v)
            for p, d in swapped:
                p._data = d
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

    def _gated_update(self, gate, opt, weights, grads, states) -> None:
        """Inside a program: the update, gated by the all-finite flag with
        a scaler (AND over the mesh), which it leaves for the next."""
        if gate is None:
            opt.step(weights, grads, states)
            return
        ok = _fused.all_finite(grads, device=gate.prev_ok.device)
        if self._mesh is not None and self._mesh.size > 1:
            from .parallel import collectives as _coll

            ok = _coll.all_reduce(ok.to(torch.float32),
                                  tuple(self._mesh.axis_names), op="min",
                                  mesh=self._mesh) > 0
        opt.step(weights, grads, states, ok=ok,
                 rescale=gate.effective()[1])
        gate.leave(ok)

    def _compiled_step(self, args, batch_size):
        tr = self._trainer
        opt = tr._optimizer
        states = tr._init_states()
        trainable = tr._params
        opt.rescale_grad = tr._scale / batch_size
        # the tensors the body reads and updates in place, by identity
        held = [p._data for p in self._net.collect_params().values()]
        held += [p._data for p in trainable]
        held += _state_leaves(states)
        gate = self._gate(held[0].device, batch_size)
        if gate is not None:
            held += [gate.vals, gate.prev_ok]
        tensors, others = self._call_parts(args)
        key = (_pstore.tensor_key(tensors), others, tuple(self._nd),
               _pstore.knob_key(), type(opt).__name__, opt.fixed_signature(),
               tuple(map(id, trainable)), _pstore.storage_key(held),
               self._mesh_key(), gate is not None)

        def build(digest=False):
            fb = self._forward_backward(args, gate)

            def body(*inputs):
                loss, weights, grads = fb(*inputs)
                self._gated_update(gate, opt, weights, grads, states)
                if not digest:
                    return loss
                from . import sentinel as _sentinel

                heads = _heads(loss)
                return tuple(heads) + _sentinel.program_digest(
                    weights, _state_leaves(states), grads)
            return body

        loss = self._dispatch_step(key, build, tensors, held, states, opt)
        self._after_update(gate)
        return loss

    def _dispatch_step(self, key, build, tensors, held, states, opt):
        snt = self._sentinel
        if self._mesh is not None and not enabled():
            if snt is not None and snt.want_digest():
                return self._offer(snt, build(True)(*tensors))
            return build()(*tensors)       # the mesh body, no program
        if snt is None or snt.every <= 0:
            return _pstore.run(self._programs, key, build, tensors,
                               device=held[0].device, keep=held)
        if self._specs:
            snt.vote = not any(self._specs.values())
        dkey = key + ("digest",)
        if dkey not in self._programs:
            self._prepare_restored(dkey, lambda: build(True), tensors,
                                   held, states, opt)
        if not snt.want_digest():
            return _pstore.run(self._programs, key, build, tensors,
                               device=held[0].device, keep=held)
        return self._offer(snt, _pstore.run(
            self._programs, dkey, lambda: build(True), tensors,
            device=held[0].device, keep=held))

    @staticmethod
    def _offer(snt, out):
        """Split a digest form's outputs into the loss and the digest,
        handed to the sentinel unread."""
        *heads, fold, psum, gnorm = out
        snt.offer(fold, psum, gnorm)
        return heads[0] if len(heads) == 1 else tuple(heads)

    def _prepare_restored(self, key, build, tensors, held, states,
                          opt) -> None:
        """Capture a program for ``key`` without a dispatch
        (``Program.prepare``), putting back every tensor its eager first
        run updates: the parameters, every optimizer state leaf (a tuple
        state's too) and the optimizer's device scalars, made first where
        the update would make them."""
        for d in {t.device for t in held}:
            opt.scalars(d)
        keep = list(held) + [
            t for sc in opt._scalars.values() for t in sc.values()]
        with torch.no_grad():
            saved = [t.detach().clone() for t in keep]
        prog = _pstore.Program(self._programs.namespace, build(), tensors,
                               held[0].device, keep=held)
        prog.prepare(*tensors)
        with torch.no_grad():
            for t, v in zip(keep, saved):
                t.copy_(v)
        self._programs.insert(key, prog)

    # -- the step on a mesh -------------------------------------------------
    def _mesh_key(self):
        if self._mesh is None:
            return None
        from .parallel import spmd as _spmd

        return (_spmd.mesh_key(self._mesh), self._batch_axes, self._rows)

    def _place(self, mesh) -> None:
        """Place every parameter and optimizer state once as this rank's
        block of its ``spmd.param_spec`` (replicated leaves stay as they
        are), after the first rank's values are broadcast to every rank,
        and record the layout's bytes."""
        if self._specs is not None:
            return
        from .parallel import spmd as _spmd
        from .parallel.sharding import NamedSharding

        split = _spmd.model_axes_active(mesh)
        params = self._net.collect_params()
        for p in self._trainer._params:
            if all(p is not q for q in params.values()):
                params[p.name] = p
        states = self._trainer._states
        index = {id(p): i for i, p in enumerate(self._trainer._params)}
        # the first rank's values everywhere, as the KVStore's init
        _spmd.broadcast_([p._check() for p in params.values()] + [
            t for s in states.values()
            for t in (s if isinstance(s, (list, tuple)) else [s])], mesh)
        specs = {}
        for name, p in params.items():
            w = p._check()
            shape = tuple(w.shape)
            spec = tuple(_spmd.param_spec(shape, mesh, name=name)) \
                if split else ()
            specs[id(p)] = spec
            if not spec:
                continue
            sh = NamedSharding(mesh, spec)
            p._set_leaf(_spmd.ensure_placed(w.detach(), sh))
            i = index.get(id(p))
            if i is not None and i in states:
                states[i] = self._place_state(states[i], shape, sh)
        self._specs = specs
        st = self._trainer._init_states()
        _spmd.record_layout(
            [p._data for p in params.values()],
            [t for s in st for t in (s if isinstance(s, (list, tuple))
                                     else [s])])

    @staticmethod
    def _place_state(state, wshape, sharding):
        """An optimizer state made before placement: the leaves shaped like
        their weight take its block (the ZeRO part of FSDP)."""
        from .parallel import spmd as _spmd

        if isinstance(state, torch.Tensor):
            if tuple(state.shape) == tuple(wshape):
                return _spmd.ensure_placed(state, sharding)
            return state
        if isinstance(state, (list, tuple)):
            return type(state)(TrainStep._place_state(s, wshape, sharding)
                               for s in state)
        return state

    def _split_batch(self, mesh, args) -> None:
        """This call's batch axes: ``dp`` where its size divides the rows of
        every batch leaf, none where one does not (replicated loudly, as
        ``spmd.put_batch`` counts it)."""
        from .parallel import spmd as _spmd

        leaves = [a for a in args if isinstance(a, torch.Tensor)
                  and a.dim() >= 1]
        self._rows = int(leaves[0].shape[0]) if leaves else None
        specs = [_spmd.batch_spec_for(tuple(a.shape), mesh) for a in leaves]
        self._batch_axes = ("dp",) if specs and all(
            tuple(s) == ("dp",) for s in specs) else ()

    def full_params(self) -> Dict[str, torch.Tensor]:
        """A copy of every parameter whole, by name (gathered from the
        ranks' blocks on a mesh that splits them: a collective each rank
        calls)."""
        from .parallel import spmd as _spmd

        specs = self._specs or {}
        return {name: _spmd.gather_full(p._check().detach(),
                                        specs.get(id(p), ()),
                                        self._mesh).clone()
                for name, p in self._net.collect_params().items()}

    def full_state(self, param) -> list:
        """Copies of the optimizer state leaves of ``param`` whole
        (gathered like the parameter where they are shaped like its
        block)."""
        from .parallel import spmd as _spmd

        tr = self._trainer
        i = next(j for j, q in enumerate(tr._params) if q is param)
        st = tr._states[i]
        leaves = st if isinstance(st, (list, tuple)) else [st]
        spec = (self._specs or {}).get(id(param), ())
        w = param._check()
        return [(_spmd.gather_full(t.detach(), spec, self._mesh)
                 if spec and t.shape == w.shape else t.detach()).clone()
                for t in leaves if isinstance(t, torch.Tensor)]

    def _forward_backward(self, args, gate=None):
        """The body's forward and backward over its static inputs: the
        eager tape's, inside the port's trace (``traced_call``), with each
        trainable parameter read through a fresh leaf that shares its
        storage (so ``.grad`` and the parameters' hooks stay untouched);
        with an AMP ``gate`` the heads are multiplied by its loss scale
        inside the recorded region. Returns fb(*inputs) -> (detached loss,
        the parameters' tensors, their gradients)."""
        net, loss_fn = self._net, self._loss_fn
        trainable = self._trainer._params
        slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        consts = [None if i in slots else a for i, a in enumerate(args)]
        nd = dict(self._nd)
        mesh, specs = self._mesh, self._specs or {}
        axes, rows = self._batch_axes, self._rows
        grad_hook = getattr(net, "compiled_grad_transform", None)
        if mesh is not None:
            from .parallel import collectives as _coll
            from .parallel import spmd as _spmd

            seed = _spmd.cotangent_scale(mesh, axes)
            call_net = _MeshNet(net, mesh, axes, rows)
            frozen = [p for p in net.collect_params().values()
                      if specs.get(id(p)) and
                      all(p is not q for q in trainable)]
        else:
            call_net, frozen = net, []

        def fb(*inputs):
            call_args = list(consts)
            for i, t in zip(slots, inputs):
                call_args[i] = t
            call_args = self._user_args(call_args, nd)
            weights = [p._data for p in trainable]
            held = [p._data for p in frozen]
            if mesh is None:
                leaves = [w.detach().requires_grad_() for w in weights]
            else:
                # the blocks gathered whole for the forward; frozen ones
                # (running statistics) as copies, written back after
                leaves = [_spmd.gather_full(w.detach(), specs.get(id(p), ()),
                                            mesh).requires_grad_()
                          for p, w in zip(trainable, weights)]
                for p, h in zip(frozen, held):
                    p._data = _spmd.gather_full(h, specs[id(p)], mesh)
            try:
                for p, leaf in zip(trainable, leaves):
                    p._data = leaf
                with traced_call(), _tensor_ops(mesh):
                    with autograd.record():
                        with _moe.aux_scope() as auxes:
                            loss = loss_fn(call_net, *call_args)
                        if auxes and axes:
                            # the aux of the whole batch: the mean of the
                            # members' (over equal rows), through a sum
                            # whose backward sums the cotangents
                            auxes = [_coll.all_reduce_sum(
                                sum(auxes[1:], auxes[0]), mesh, axes)
                                * seed]
                        heads = _fold_aux(auxes, [_tensor(h) for h in
                                                  _heads(loss)])
                        if gate is not None:
                            scale = gate.effective()[0]
                            heads = [h * scale for h in heads]
                    grads = torch.autograd.grad(
                        heads, leaves,
                        [torch.ones_like(h) if mesh is None
                         else torch.full_like(h, seed) for h in heads],
                        allow_unused=True)
            finally:
                for p, w in zip(trainable, weights):
                    p._data = w
                for p, h in zip(frozen, held):
                    full, p._data = p._data, h
                    if full is not h:
                        with torch.no_grad():
                            h.copy_(_coll.local_block(full, specs[id(p)],
                                                      mesh))
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, leaves)]
            if mesh is not None:
                grads = [_spmd.reduce_grad(_spmd.full_tensors(g),
                                           specs.get(id(p), ()), mesh, axes)
                         for g, p in zip(grads, trainable)]
            if grad_hook is not None:
                grads = self._apply_grad_transform(grad_hook, grads)
            if isinstance(loss, (list, tuple)):
                loss = type(loss)(_tensor(h).detach() for h in loss)
            else:
                loss = _tensor(loss).detach()
            return loss, weights, grads

        return fb

    def _apply_grad_transform(self, hook, grads):
        """The net's ``compiled_grad_transform(named_grads) -> named_grads``
        (``PipelineBlock`` summing its tied leaves' slices), applied after
        the backward on both the step and the accumulation programs, to the
        whole gradients: on a mesh they are gathered from the blocks, and
        each rank keeps its block of the result (reference
        ``cached_step.py:1213-1238``)."""
        from .parallel import collectives as _coll
        from .parallel import spmd as _spmd

        mesh, specs = self._mesh, self._specs or {}
        names = {id(p): n for n, p in self._net.collect_params().items()}
        trainable = self._trainer._params
        named = {names[id(p)]: (g if mesh is None else _spmd.gather_full(
            g, specs.get(id(p), ()), mesh))
            for p, g in zip(trainable, grads) if id(p) in names}
        out = hook(dict(named))
        new = []
        for p, g in zip(trainable, grads):
            n = names.get(id(p))
            if n is None or out.get(n) is named[n]:
                new.append(g)
            elif mesh is None:
                new.append(out[n])
            else:
                new.append(_coll.local_block(out[n], specs.get(id(p), ()),
                                             mesh).contiguous())
        return new

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
        # one pair of candidates for the whole window: the pending flag is
        # read only at the window's close
        gate = self._gate(weights[0].device, batch_size, self._accum_steps)
        if gate is not None:
            held += [gate.vals, gate.prev_ok]
        tensors, others = self._call_parts(args)
        key = ("accum_grad", _pstore.tensor_key(tensors), others,
               tuple(self._nd), _pstore.knob_key(), tuple(map(id, trainable)),
               _pstore.storage_key(held), self._mesh_key(), gate is not None)

        def build_grad():
            fb = self._forward_backward(args, gate)

            def body(*inputs):
                loss, _weights, grads = fb(*inputs)
                with torch.no_grad():
                    torch._foreach_add_(accs, grads)
                return loss
            return body

        if self._mesh is not None and not enabled():
            loss = build_grad()(*tensors)
        else:
            loss = _pstore.run(self._programs, key, build_grad, tensors,
                               device=held[0].device, keep=held)
        self._accum_i += 1
        if self._accum_i < self._accum_steps:
            return loss
        self._accum_i = 0
        states = tr._init_states()
        opt.rescale_grad = tr._scale / (batch_size * self._accum_steps)
        uheld = weights + accs + _state_leaves(states)
        if gate is not None:
            uheld += [gate.vals, gate.prev_ok]
        ukey = ("accum_update", type(opt).__name__, opt.fixed_signature(),
                _pstore.storage_key(uheld), _pstore.knob_key(),
                gate is not None)

        def update():
            # the flag of the summed gradients: an overflow in any
            # micro-batch survives the sum
            self._gated_update(gate, opt, weights, accs, states)
            with torch.no_grad():
                torch._foreach_zero_(accs)
            return ()

        if self._mesh is not None and not enabled():
            update()
        else:
            _pstore.run(self._update_programs, ukey, lambda: update, [],
                        device=weights[0].device, keep=uheld)
        self._after_update(gate)
        return loss


def _tensor_ops(mesh):
    if mesh is None:
        return contextlib.nullcontext()
    from .parallel import spmd as _spmd

    return _spmd.tensor_ops(mesh)


class _MeshNet:
    """The net as ``loss_fn`` sees it in a step on a mesh: a call runs the
    net on this rank's rows of the batch over ``axes`` (the tensor
    arguments with the batch's ``rows``), inside ``spmd.data_parallel``,
    and returns its outputs whole (a DTensor made by a constraint turned
    back into a local tensor) and gathered over ``axes``. Every other
    attribute is the net's."""

    def __init__(self, net, mesh, axes, rows):
        self.__dict__.update(_net=net, _mesh=mesh, _axes=axes, _rows=rows)

    def __getattr__(self, name):
        return getattr(self.__dict__["_net"], name)

    def _rows_of(self, a):
        from .parallel import spmd as _spmd

        t = _tensor(a)
        if not self._axes or not isinstance(t, torch.Tensor) or \
                t.dim() < 1 or int(t.shape[0]) != self._rows:
            return a
        local = _spmd.local_rows(t, self._mesh, self._axes)
        return _wrap(local, a.ctx) if isinstance(a, NDArray) else local

    def _whole(self, out):
        from .parallel import collectives as _coll
        from .parallel import spmd as _spmd

        if isinstance(out, (list, tuple)):
            return type(out)(self._whole(o) for o in out)
        t = _spmd.full_tensors(_tensor(out))
        if isinstance(t, torch.Tensor):
            t = _coll.gather_rows(t, self._mesh, self._axes)
        return _wrap(t, out.ctx) if isinstance(out, NDArray) else t

    def __call__(self, *args, **kwargs):
        from .parallel import spmd as _spmd

        args = [self._rows_of(a) for a in args]
        kwargs = {k: self._rows_of(v) for k, v in kwargs.items()}
        with _spmd.data_parallel(self._mesh, self._axes):
            out = self._net(*args, **kwargs)
        return self._whole(out)
