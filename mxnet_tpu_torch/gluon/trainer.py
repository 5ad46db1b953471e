"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

Applies an optimizer to a set of parameters: ``step(batch_size)`` sets
``rescale_grad = 1 / batch_size`` and updates every parameter that has a
gradient request, in place (``trainer.py:240-292``). A parameter that the
last backward did not reach updates with a zero gradient (weight decay and
momentum still act), as in the reference. ``compile_step`` returns the
compiled whole step (``cached_step.TrainStep``).

``kvstore`` (reference ``trainer.py:29``, ``:63-69``): ``'device'`` (the
default), ``'local'`` or None keep one device; ``'tpu'`` and ``'nccl'``
give ``compile_step`` the mesh of ``parallel.spmd.mesh_for_store``
(``MXNET_SPMD_MESH`` over the ranks of the ``torch.distributed`` world),
on which the step reduces the gradients inside its program. ``step()``,
the eager update, applies this rank's gradients as they are. The
``dist_*`` stores (parameter servers) are the port's ``kvstore/``, ROADMAP
A9, and raise. ``update_on_kvstore`` is kept for AMP's refusal: the port's
stores never update on the store side.

AMP (reference ``trainer.py:240-290``): after ``amp.init_trainer`` the
trainer holds a ``LossScaler``, and ``step`` skips an overflowed update.
With ``MXNET_FUSED_OPTIMIZER`` on (the default) one all-finite reduction
(``optimizer.fused.all_finite``) gives a device flag that gates the update
on the device (``where(ok, new, old)``), then one host read of it moves
the scale; with it off, the scalar path reads the overflow first and
skips the update on the host. A trainer with ``update_on_kvstore`` and a
scaler refuses the step before any reduction.

States (reference ``trainer.py:387-410``): :meth:`save_states` /
:meth:`load_states` write and read the optimizer's states (momentum, Adam's
moments and step count) as a pickle of host tensors; :meth:`state_tree` /
:meth:`load_state_tree` are the tree a checkpoint holds (the net's
parameters by name, batch-norm running statistics included, and the
optimizer's states; the reference's ``drills.py:201-240`` ``_capture`` /
``_restore_into``). Loading always copies into the live tensors in place,
so the captured steps that read them stay valid.
"""
from __future__ import annotations

import pickle
from typing import Dict, List

import torch

from .. import optimizer as opt
from ..context import resolve_device
from .parameter import Parameter

__all__ = ["Trainer"]


_LOCAL_STORES = (None, "device", "local")
_MESH_STORES = ("tpu", "nccl")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", update_on_kvstore=None):
        kv = kvstore.lower() if isinstance(kvstore, str) else kvstore
        if isinstance(kv, str) and kv.startswith("dist"):
            raise NotImplementedError(
                f"kvstore={kvstore!r}: the distributed stores are the "
                "port's kvstore/ module, not ported yet (ROADMAP A9)")
        if kv not in _LOCAL_STORES + _MESH_STORES:
            raise ValueError(f"unknown kvstore {kvstore!r}; the port takes "
                             f"{_LOCAL_STORES + _MESH_STORES}")
        self._kv_type = kv
        self._update_on_kvstore = update_on_kvstore
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        elif not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
            if p.grad_req != "null":
                # a parameter not initialized yet would be made on cuda
                resolve_device(p.device)
                self._params.append(p)
        self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, object] = {}

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_states(self) -> list:
        """The optimizer state of every parameter, made where missing (a
        compiled step makes them before its first capture); and the
        optimizer's device scalars on their devices."""
        for i, p in enumerate(self._params):
            if i not in self._states:
                w = p._check()
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(w)
                self._optimizer.scalars(w.device)
        return [self._states[i] for i in range(len(self._params))]

    def compile_step(self, net, loss_fn, bucket=False, accum_steps=1):
        """Forward, backward and the optimizer update as ONE captured
        program (``cached_step.TrainStep``), the counterpart of the
        reference's one donated XLA program a step. ``loss_fn(net, *args)``
        returns the loss; the returned step is called as ``step(*args,
        batch_size=...)`` and replaces the record / backward / ``step()``
        triple. Setups it cannot capture (``MXNET_COMPILED_STEP=0``,
        ``grad_req='add'``, a pending deferred initialization) run the
        eager tape and name their reason in ``last_fallback_reason``.
        ``bucket=True`` pads each batch to its shape bucket, once checked
        for a pad-safe loss; ``accum_steps=N`` makes a window of N calls
        one update (N grad programs and one update program)."""
        from ..cached_step import TrainStep

        return TrainStep(net, loss_fn, self, bucket=bucket,
                         accum_steps=accum_steps)

    def step(self, batch_size) -> None:
        """Normalize the gradients by ``batch_size`` and update (with an AMP
        loss scaler, skipping an overflowed update; see the module
        docstring)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and self._update_on_kvstore:
            from ..base import MXNetError

            raise MXNetError(
                "AMP loss scaling cannot skip server-side kvstore updates; "
                "recreate the Trainer with update_on_kvstore=False")
        states = self._init_states()
        weights, grads = [], []
        for p in self._params:
            w = p._check()
            weights.append(w)
            grads.append(w.grad if w.grad is not None
                         else torch.zeros_like(w))
        if scaler is None:
            self._optimizer.step(weights, grads, states)
            return
        from .. import config as _config
        from ..optimizer import fused as _fused

        if _config.get("MXNET_FUSED_OPTIMIZER"):
            ok = _fused.all_finite(grads)
            self._optimizer.step(weights, grads, states, ok=ok)
            scaler.update_scale(not bool(ok))
            return
        overflow = scaler.has_overflow(self._params)
        scaler.update_scale(overflow)
        if not overflow:
            self._optimizer.step(weights, grads, states)

    # -- states ----------------------------------------------------------
    def _state_scalars(self) -> Dict[str, torch.Tensor]:
        """The optimizer's device scalars that are state, not settings
        (Adam's step count ``t``), of its first device."""
        scal = self._optimizer._scalars
        if not scal:
            return {}
        first = next(iter(scal.values()))
        return {k: v for k, v in first.items() if k == "t"}

    def state_tree(self, net=None) -> dict:
        """The live tensors a checkpoint holds: ``{"params": {name: tensor}
        (the net's, else the trainer's own by name), "opt": {index: state},
        "scalars": {"t": ...}}``. Made missing states first."""
        params = net.collect_params() if net is not None else \
            {p.name: p for p in self._params}
        states = self._init_states()
        return {
            "params": {k: params[k]._check() for k in sorted(params)},
            "opt": {i: s for i, s in enumerate(states)},
            "scalars": self._state_scalars(),
        }

    @torch.no_grad()
    def load_state_tree(self, tree: dict, net=None) -> None:
        """Copy a restored :meth:`state_tree` (or the parts of one it
        holds) into the live tensors in place."""
        live = self.state_tree(net)

        def copy(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            elif isinstance(dst, (list, tuple)):
                for d, v in zip(dst, src):
                    copy(d, v)
        for k, t in live["params"].items():
            if k in tree.get("params", {}):
                copy(t, tree["params"][k])
        for i, s in live["opt"].items():
            if i in tree.get("opt", {}):
                copy(s, tree["opt"][i])
        for k, t in live["scalars"].items():
            if k in tree.get("scalars", {}):
                copy(t, tree["scalars"][k])

    def save_states(self, fname) -> None:
        """Save the optimizer's states (reference ``trainer.py:482``)."""
        tree = self.state_tree()

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, (list, tuple)):
                return type(x)(host(v) for v in x)
            return x
        with open(fname, "wb") as f:
            pickle.dump({"optimizer": type(self._optimizer).__name__,
                         "opt": host(tree["opt"]),
                         "scalars": host(tree["scalars"])}, f)

    def load_states(self, fname) -> None:
        """Load the optimizer's states saved by :meth:`save_states`
        (reference ``trainer.py:501``), in place."""
        with open(fname, "rb") as f:
            data = pickle.load(f)
        if data.get("optimizer") != type(self._optimizer).__name__:
            raise ValueError(
                f"states of a {data.get('optimizer')} optimizer cannot load "
                f"into {type(self._optimizer).__name__}")
        self.load_state_tree({"opt": data["opt"],
                              "scalars": data.get("scalars", {})})
