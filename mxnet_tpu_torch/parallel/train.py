"""The whole train step as one program: ``ShardedTrainer`` on one device.

Counterpart of ``mxnet_tpu/parallel/train.py`` (``functional_call``
:35-74, ``ShardedTrainer`` :81-359). The reference traces forward,
backward, the gradient all-reduce over the mesh's data axes and the
update into one donated ``jax.jit`` program. Here the mesh has one device
(``parallel.mesh``; larger axes are ROADMAP A6), and the step is one
captured program (``program_store.Program``, namespace ``sharded_step``)
per signature of the data and the label, as the reference keys
``_jitted`` on that signature (:335-339): one capture, then one dispatch
a step. The trainer owns its parameters (the masters) and optimizer state
at fixed addresses, updated in place; ``sync_to_block`` writes the masters
back into the block.

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
from .mesh import Mesh

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
        if plan is not None or batch_spec is not None or \
                label_spec is not None:
            raise NotImplementedError(
                "sharding plans and batch specs place work across devices, "
                "which mxnet_tpu_torch does not do yet (ROADMAP Queue A, A6)")
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
        with torch.no_grad():
            self.params: Dict[str, torch.Tensor] = {
                n: params[n]._data.detach().to(device).clone()
                for n in self.names}
        self.opt_state = self._init_opt_state()
        self._t = torch.zeros((), dtype=torch.float32, device=device)
        self.step_count = 0
        self._programs = _pstore.scope("sharded_step")

    # -- optimizer -------------------------------------------------------
    def _init_opt_state(self) -> Dict[str, tuple]:
        n_state = {"sgd": 1 if self.momentum else 0}.get(self.opt, 2)
        return {n: tuple(torch.zeros_like(self.params[n])
                         for _ in range(n_state))
                for n in self.grad_names}

    def _apply_update(self, w, g, state, t):
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
        r1 = torch.linalg.vector_norm(w.float())
        r2 = torch.linalg.vector_norm(gdir.float())
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
        updates land on them and never on the masters."""
        cd = self.compute_dtype
        tensors = {n: self._cast(t) for n, t in zip(self.grad_names, leaves)}
        for n in self.frozen_names:
            p = self.params[n]
            tensors[n] = p.to(cd) if cd is not None and \
                p.is_floating_point() and p.dtype != cd else p.clone()
        out, mutated = functional_call(self.block, tensors,
                                       (self._cast(data),), training=True)
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

        with torch.enable_grad():
            if self.remat:
                outs = checkpoint(fn, data, label, *leaves,
                                  use_reentrant=False)
            else:
                outs = fn(data, label, *leaves)
            loss = outs[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            for n, v in zip(names_box, outs[1:]):
                self.params[n].copy_(v)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, leaves)]
        return loss.detach(), grads

    def _body(self, data, label):
        """The program's body over its static data and label."""
        accum = self.grad_accum
        with torch.no_grad():
            self._t.add_(1.0)
        leaves = [self.params[n].detach().requires_grad_()
                  for n in self.grad_names]
        with traced_call():
            if accum == 1:
                loss, grads = self._micro_step(data, label, leaves)
            else:
                if data.shape[0] % accum or label.shape[0] % accum:
                    raise ValueError(
                        f"batch {data.shape[0]} does not split into "
                        f"grad_accum={accum} equal micro-batches")
                grads, loss = None, None
                for d_mb, l_mb in zip(data.chunk(accum), label.chunk(accum)):
                    l_i, g_i = self._micro_step(d_mb, l_mb, leaves)
                    if grads is None:
                        grads, loss = g_i, l_i
                    else:
                        grads = [a + g for a, g in zip(grads, g_i)]
                        loss = loss + l_i
                inv = 1.0 / accum
                grads = [g * inv for g in grads]
                loss = loss * inv
        with torch.no_grad():
            for n, g in zip(self.grad_names, grads):
                w = self.params[n]
                new_w, st = self._apply_update(w, g, self.opt_state[n],
                                               self._t)
                w.copy_(new_w)
                for s, new_s in zip(self.opt_state[n], st):
                    s.copy_(new_s)
        return loss

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
        if not _config.get("MXNET_COMPILED_STEP"):
            loss = self._body(data, label)
        else:
            key = (_pstore.tensor_key([data, label]), _pstore.knob_key())
            loss = _pstore.run(self._programs, key, lambda: self._body,
                               [data, label], device=self.mesh.device,
                               keep=self._held())
        self.step_count += 1
        return float(loss) if sync else loss

    def stage(self, data, label):
        """Place a batch on the mesh's device once, for reuse."""
        return self._put(data), self._put(label)

    def sync_to_block(self):
        """Write the trained masters back into the block's parameters."""
        params = self.block.collect_params()
        for n in self.names:
            params[n].set_data(self.params[n])
        return self
