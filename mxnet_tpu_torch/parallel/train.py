"""The whole train step as one program: ``ShardedTrainer``.

Counterpart of ``mxnet_tpu/parallel/train.py`` (``functional_call``
:35-74, ``ShardedTrainer`` :81-359). The reference traces forward,
backward, the gradient all-reduce over the mesh's data axes and the
update into one donated ``jax.jit`` program. Here the step is one
captured program on each rank of the mesh (``program_store.Program``,
namespace ``sharded_step``) per signature of the data and the label, as
the reference keys ``_jitted`` on that signature (:335-339): one capture,
then one dispatch a step. The trainer owns its parameters (the masters)
and optimizer state at fixed addresses, updated in place;
``sync_to_block`` writes the masters back into the block, whole.

On a mesh (:89-160, :318-359): ``plan`` (a ``sharding.ShardingPlan``,
replicated by default) gives each parameter's spec, and the trainer keeps
this rank's block of every parameter and of its optimizer state.
``batch_spec`` (default: dim 0 over every data axis above 1, ``dp`` and
``fsdp``, as the reference's :151-155) says which axes split the batch,
legalized loudly against its shape. ``step`` takes the global batch; the
forward runs on this rank's rows, the outputs are gathered over those
axes and the loss is taken over the global batch on every rank (seeded
``1 / (their size)``); the labels stay whole (``label_spec`` is accepted
and legalized, and places nothing, since the loss reads every label).
The blocks are gathered whole before the forward and the gradients
reduced to the blocks by ``parallel.spmd``'s rules; batch norm takes the
global batch's moments. LAMB's trust ratio takes the norms of the whole
tensors. Axes of size 1 are elided, so a mesh of one is the plain step.

Mixed precision (``compute_dtype``, :103-107, :229-236, :302-316): the
masters and the optimizer state stay in the parameters' own dtype. Inside
the step, floating parameters and floating data are cast to the compute
dtype, the loss is ``mean(loss_fn(out, label))`` cast to fp32, and the
gradients flow back through the casts to the masters. Batch-norm running
statistics are computed in the compute dtype and stored in the masters'
dtype: the port's ``BatchNorm`` updates its running buffers in place, so
the step installs copies of every frozen parameter (cast copies under a
compute dtype, clones otherwise), finds those the forward updated by
their version counters, and writes them back cast
(:func:`functional_call`). The copies also keep a recomputed forward
(``remat``) from updating the statistics twice.

``grad_accum=N`` (:250-301) splits the batch into N micro-batches, chains
the running statistics from one to the next, sums the gradients and
scales the sum and the loss by 1/N before one update. ``remat`` (default
``MXNET_BACKWARD_DO_MIRROR``) recomputes the forward in the backward
(``torch.utils.checkpoint``) instead of keeping activations.

Optimizers: ``sgd`` (with and without momentum), ``adam``, ``adamw`` (both
with the bias-corrected lr) and ``lamb``, through ``ops.optimizer``. The
step count ``t`` that Adam's lr and LAMB's bias correction read lives on
the device and is advanced inside the program, so no step's value is baked
into the capture. No ported layer draws random numbers, so the step takes
no random state.

Under ``MXNET_COMPILED_STEP=0`` the same body runs eagerly, with no
program (the eager tape everywhere).

The step body runs as the port's trace (``gluon.block.traced_call``): the
fused ResNet sites run there whether or not the block is hybridized, as
the reference's traced step fuses them. A failed capture raises
(``program_store.Program``), as for ``cached_step.TrainStep``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd
from .. import config as _config
from .. import program_store as _pstore
from ..gluon.block import traced_call
from ..gluon.parameter import dtype_of
from ..ops import optimizer as opt_ops
from . import collectives as _coll
from . import spmd as _spmd
from .mesh import Mesh
from .sharding import PartitionSpec, ShardingPlan, _legalize, replicated_plan

__all__ = ["functional_call", "ShardedTrainer"]

_OPTIMIZERS = ("sgd", "adam", "adamw", "lamb")


@contextlib.contextmanager
def _installed(block, tensors: Dict[str, torch.Tensor]):
    """``tensors`` as the values of ``block``'s parameters by name for the
    scope, the old values restored after."""
    params = block.collect_params()
    old = {n: params[n]._data for n in tensors}
    try:
        for n, t in tensors.items():
            params[n]._data = t
        yield
    finally:
        for n, t in old.items():
            params[n]._data = t


def functional_call(block, param_tensors: Dict[str, torch.Tensor],
                    args: Sequence, *, training: bool = True):
    """Run ``block.forward`` on ``args`` with ``param_tensors`` installed as
    its parameters' values (by structural name), recording, so gradients
    reach the installed tensors. Returns ``(outputs, {name: tensor})``,
    the installed tensors that the forward updated in place (batch-norm
    running statistics), found by their version counters."""
    versions = {n: t._version for n, t in param_tensors.items()}
    with _installed(block, param_tensors), \
            autograd.record(train_mode=training):
        out = block.forward(*args)
    mutated = {n: t for n, t in param_tensors.items()
               if t._version != versions[n]}
    return out, mutated


def _bias_corrected_lr(lr, beta1, beta2, t):
    return lr * torch.sqrt(1.0 - torch.pow(beta2, t)) \
        / (1.0 - torch.pow(beta1, t))


class ShardedTrainer:
    """The whole train step of an initialized block as one program (see the
    module docstring). ``loss_fn(outputs, label)`` gives the loss, whose
    mean the step takes; ``step(data, label)`` runs one step."""

    def __init__(self, block, loss_fn: Callable, mesh: Mesh, plan=None,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict[str, Any]] = None,
                 batch_spec=None, label_spec=None, grad_accum: int = 1,
                 compute_dtype=None,
                 remat: Optional[bool] = None):
        if plan is not None and not isinstance(plan, ShardingPlan):
            raise TypeError(f"plan must be a sharding.ShardingPlan, got "
                            f"{type(plan).__name__}")
        self.plan = plan if plan is not None else replicated_plan()
        data_axes = tuple(a for a in ("dp", "fsdp")
                          if mesh.shape.get(a, 1) > 1)
        default_spec = PartitionSpec(data_axes if data_axes else None)
        self.batch_spec = PartitionSpec(*batch_spec) \
            if batch_spec is not None else default_spec
        self.label_spec = PartitionSpec(*label_spec) \
            if label_spec is not None else default_spec
        self.block = block
        self.loss_fn = loss_fn
        self.mesh = mesh
        if remat is None:
            remat = bool(_config.get("MXNET_BACKWARD_DO_MIRROR"))
        self.remat = bool(remat)
        self.compute_dtype = (dtype_of(compute_dtype)
                              if compute_dtype is not None else None)
        self.opt = optimizer.lower()
        if self.opt not in _OPTIMIZERS:
            raise ValueError(f"unsupported sharded optimizer {self.opt}")
        kw = dict(optimizer_params or {})
        self.lr = float(kw.pop("learning_rate", kw.pop("lr", 0.01)))
        self.momentum = float(kw.pop("momentum", 0.0))
        self.wd = float(kw.pop("wd", 0.0))
        self.beta1 = float(kw.pop("beta1", 0.9))
        self.beta2 = float(kw.pop("beta2", 0.999))
        self.epsilon = float(kw.pop("epsilon", 1e-8))
        if kw:
            raise ValueError(
                f"unsupported optimizer_params for ShardedTrainer: {list(kw)}")
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

        params = block.collect_params()
        uninit = [n for n, p in params.items() if p._data is None]
        if uninit:
            raise ValueError(
                f"initialize() the block before ShardedTrainer: {uninit[:3]}")
        self.names: List[str] = list(params)
        # grad_req 'add' is trainable here, as in the reference: the
        # in-step accumulation is grad_accum's
        self.grad_names = [n for n in self.names
                           if params[n].grad_req != "null"]
        self.frozen_names = [n for n in self.names
                             if n not in self.grad_names]
        device = mesh.device
        self.specs: Dict[str, PartitionSpec] = {
            n: self.plan.spec_for(n, tuple(params[n]._data.shape), mesh)
            for n in self.names}
        with torch.no_grad():
            full = {n: params[n]._data.detach().to(device).clone()
                    for n in self.names}
            # the first rank's values everywhere (the KVStore's init)
            _spmd.broadcast_(list(full.values()), mesh)
            self.params: Dict[str, torch.Tensor] = {
                n: _coll.local_block(full[n], self.specs[n], mesh).clone()
                for n in self.names}
        self.opt_state = self._init_opt_state()
        self._t = torch.zeros((), dtype=torch.float32, device=device)
        self._axes: tuple = ()
        self.step_count = 0
        self._programs = _pstore.scope("sharded_step")

    # -- optimizer -------------------------------------------------------
    def _init_opt_state(self) -> Dict[str, tuple]:
        n_state = {"sgd": 1 if self.momentum else 0}.get(self.opt, 2)
        return {n: tuple(torch.zeros_like(self.params[n])
                         for _ in range(n_state))
                for n in self.grad_names}

    def _norm(self, t, spec):
        """The norm of the whole tensor of which ``t`` is this rank's
        ``spec`` block."""
        axes = tuple(a for d in spec if d is not None
                     for a in (d if isinstance(d, tuple) else (d,))
                     if self.mesh.shape.get(a, 1) > 1)
        if not axes:
            return torch.linalg.vector_norm(t.float())
        sq = (t.float() * t.float()).sum()
        return torch.sqrt(_coll.all_reduce(sq, axes, mesh=self.mesh))

    def _apply_update(self, w, g, state, t, spec=()):
        """(new weight, new state) by the reference's update ops."""
        lr, wd = self.lr, self.wd
        if self.opt == "sgd":
            if self.momentum:
                new_w, new_m = opt_ops.sgd_mom_update(
                    w, g, state[0], lr=lr, momentum=self.momentum, wd=wd)
                return new_w, (new_m,)
            return opt_ops.sgd_update(w, g, lr=lr, wd=wd), ()
        if self.opt in ("adam", "adamw"):
            lr_t = _bias_corrected_lr(lr, self.beta1, self.beta2, t)
            if self.opt == "adam":
                new_w, m, v = opt_ops.adam_update(
                    w, g, state[0], state[1], lr=lr_t, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, wd=wd)
            else:
                new_w, m, v = opt_ops.adamw_update(
                    [w, g, state[0], state[1]], lr=lr_t, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, wd=wd)
            return new_w, (m, v)
        gdir, m, v = opt_ops.lamb_update_phase1(
            w, g, state[0], state[1], beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=t, wd=wd)
        r1 = self._norm(w, spec)
        r2 = self._norm(gdir, spec)
        new_w = opt_ops.lamb_update_phase2([w, gdir, r1, r2], lr=lr)
        return new_w, (m, v)

    # -- the step --------------------------------------------------------
    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is not None and t.is_floating_point():
            return t.to(cd)
        return t

    def _loss_of(self, data, label, *leaves):
        """The micro-batch's loss and the frozen parameters it updated, as
        one function of the trainable leaves (what ``remat`` recomputes).
        Frozen parameters enter as copies, so the forward's in-place
        updates land on them and never on the masters. ``data`` is this
        rank's rows; the outputs are gathered over the batch's axes before
        the loss."""
        cd = self.compute_dtype
        tensors = {n: self._cast(t) for n, t in zip(self.grad_names, leaves)}
        for n in self.frozen_names:
            p = _spmd.gather_full(self.params[n], self.specs[n], self.mesh)
            tensors[n] = p.to(cd) if cd is not None and \
                p.is_floating_point() and p.dtype != cd else p.clone()
        with _spmd.data_parallel(self.mesh, self._axes):
            out, mutated = functional_call(self.block, tensors,
                                           (self._cast(data),),
                                           training=True)
        out = _spmd.full_tensors(out)
        out = type(out)(_coll.gather_rows(o, self.mesh, self._axes)
                        for o in out) if isinstance(out, (list, tuple)) \
            else _coll.gather_rows(out, self.mesh, self._axes)
        with autograd.record():
            loss = self.loss_fn(out, label)
        loss = torch.mean(loss).to(torch.float32)
        names = [n for n in self.frozen_names if n in mutated]
        return (loss,) + tuple(mutated[n].detach() for n in names), names

    def _micro_step(self, data, label, leaves):
        """(loss, gradients) of one micro-batch; the frozen parameters it
        updated are written back into the masters, cast."""
        names_box = []

        def fn(d, lab, *ls):
            outs, names = self._loss_of(d, lab, *ls)
            names_box[:] = names
            return outs

        with torch.enable_grad(), _spmd.tensor_ops(self.mesh):
            if self.remat:
                outs = checkpoint(fn, data, label, *leaves,
                                  use_reentrant=False)
            else:
                outs = fn(data, label, *leaves)
            loss = outs[0]
            seed = _spmd.cotangent_scale(self.mesh, self._axes)
            grads = torch.autograd.grad(
                loss, leaves, None if seed == 1.0
                else torch.full_like(loss, seed), allow_unused=True)
        with torch.no_grad():
            for n, v in zip(names_box, outs[1:]):
                self.params[n].copy_(_coll.local_block(v, self.specs[n],
                                                       self.mesh))
        grads = [torch.zeros_like(w) if g is None else
                 _spmd.full_tensors(g) for g, w in zip(grads, leaves)]
        return loss.detach(), grads

    def _body(self, data, label):
        """The program's body over its static data and label."""
        accum = self.grad_accum
        with torch.no_grad():
            self._t.add_(1.0)
        leaves = [_spmd.gather_full(self.params[n].detach(), self.specs[n],
                                    self.mesh).requires_grad_()
                  for n in self.grad_names]
        with traced_call():
            if accum == 1:
                loss, grads = self._micro_step(self._rows_of(data), label,
                                               leaves)
            else:
                if data.shape[0] % accum or label.shape[0] % accum:
                    raise ValueError(
                        f"batch {data.shape[0]} does not split into "
                        f"grad_accum={accum} equal micro-batches")
                grads, loss = None, None
                for d_mb, l_mb in zip(data.chunk(accum), label.chunk(accum)):
                    l_i, g_i = self._micro_step(self._rows_of(d_mb), l_mb,
                                                leaves)
                    if grads is None:
                        grads, loss = g_i, l_i
                    else:
                        grads = [a + g for a, g in zip(grads, g_i)]
                        loss = loss + l_i
                inv = 1.0 / accum
                grads = [g * inv for g in grads]
                loss = loss * inv
        grads = [_spmd.reduce_grad(g, self.specs[n], self.mesh, self._axes)
                 for n, g in zip(self.grad_names, grads)]
        with torch.no_grad():
            for n, g in zip(self.grad_names, grads):
                w = self.params[n]
                new_w, st = self._apply_update(w, g, self.opt_state[n],
                                               self._t, self.specs[n])
                w.copy_(new_w)
                for s, new_s in zip(self.opt_state[n], st):
                    s.copy_(new_s)
        return loss

    def _rows_of(self, data):
        """This rank's rows of a (micro-)batch over the batch's axes."""
        return _spmd.local_rows(data, self.mesh, self._axes)

    def _split(self, data) -> tuple:
        """The axes above 1 that split a batch of ``data``'s shape: the
        batch spec's first dim, legalized loudly (an indivisible batch
        stays whole on every rank)."""
        rows = tuple(data.shape[:1]) + (1,) * (data.dim() - 1)
        per = rows[0] // self.grad_accum if rows and \
            rows[0] % self.grad_accum == 0 else (rows[0] if rows else 0)
        spec = _legalize(self.batch_spec[:1], (per,) + rows[1:], self.mesh,
                         loud=True)
        return _spmd.split_axes(self.mesh, spec)

    def _put(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.mesh.device)

    def _held(self) -> list:
        held = list(self.params.values()) + [self._t]
        held += [s for st in self.opt_state.values() for s in st]
        return held

    def step(self, data, label, sync: bool = True):
        """One step. ``sync=True`` returns the loss as a Python float (one
        host read a step); ``sync=False`` returns the device loss, so that
        steps queue back to back."""
        data, label = self._put(data), self._put(label)
        self._axes = self._split(data)
        if not _config.get("MXNET_COMPILED_STEP"):
            loss = self._body(data, label)
        else:
            key = (_pstore.tensor_key([data, label]), _pstore.knob_key(),
                   _spmd.mesh_key(self.mesh), self._axes)
            loss = _pstore.run(self._programs, key, lambda: self._body,
                               [data, label], device=self.mesh.device,
                               keep=self._held())
        self.step_count += 1
        return float(loss) if sync else loss

    def stage(self, data, label):
        """Place a batch on the mesh's device once, for reuse."""
        return self._put(data), self._put(label)

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Copies of the masters whole (gathered from the ranks' blocks
        where the plan splits them: a collective every rank calls)."""
        return {n: _spmd.gather_full(self.params[n], self.specs[n],
                                     self.mesh).clone() for n in self.names}

    def full_opt_state(self) -> Dict[str, tuple]:
        """Copies of the optimizer state whole, like :meth:`full_params`."""
        return {n: tuple(_spmd.gather_full(s, self.specs[n],
                                           self.mesh).clone() for s in st)
                for n, st in self.opt_state.items()}

    def sync_to_block(self):
        """Write the trained masters back into the block's parameters,
        whole."""
        params = self.block.collect_params()
        for n, t in self.full_params().items():
            params[n].set_data(t)
        return self
