"""Recording and training scopes, backward, grad and custom functions.

Counterpart of ``mxnet_tpu/autograd.py``. The flags are thread-local, as in
the reference: ``is_recording`` says whether gradients are being recorded,
``is_training`` whether layers run in training mode (batch statistics, the
fused ResNet epilogue). Gradients come from torch's own autograd, so there
is no tape here: :func:`record` also enables torch's grad mode and
:func:`pause` disables it.

Two flavors of heads:

- ``torch.Tensor`` heads (Gluon fed tensors): :func:`backward` is
  ``torch.autograd.backward`` with the reference's default head gradient of
  ones, into every leaf that requires grad (the Gluon parameters, whose
  ``grad_req`` their own hooks keep).
- ``NDArray`` heads: the reference records every differentiable op under
  ``record()`` and writes only to the marked variables. ``invoke`` makes the
  floating ``NDArray`` inputs of a recorded op require grad, so that
  :func:`grad` can differentiate with respect to an input nobody marked
  (reference ``autograd.py:419-428``). An NDArray that no recorded op read
  and nobody marked was never tracked (Gluon reads its input untracked),
  so :func:`grad` with respect to it raises instead of answering zeros.
  :func:`backward` takes ``torch.autograd.grad`` over the marked leaves
  only (the variables of ``attach_grad`` / :func:`mark_variables`, and the
  Gluon parameters that take gradients) and writes each by its
  ``grad_req``, ``write`` or ``add``. No other tensor's ``.grad`` is
  touched.

A custom :class:`Function` runs as a ``torch.autograd.Function`` node.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional, Sequence, Union

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _AGState(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    return prev


def set_training(train_mode: bool) -> bool:
    prev = _STATE.training
    _STATE.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Scope flipping (recording, training), and torch's grad mode with
    recording; None leaves a flag as it is."""

    def __init__(self, is_record: Optional[bool],
                 train_mode: Optional[bool]):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev = None

    def __enter__(self):
        rec, train = self._enter_is_record, self._enter_train_mode
        self._prev = (None if rec is None else set_recording(rec),
                      None if train is None else set_training(train),
                      torch.is_grad_enabled())
        if rec is not None:
            torch.set_grad_enabled(rec)
        return self

    def __exit__(self, ptype, value, trace):
        prev_rec, prev_train, prev_grad = self._prev
        if prev_rec is not None:
            set_recording(prev_rec)
        if prev_train is not None:
            set_training(prev_train)
        torch.set_grad_enabled(prev_grad)


def record(train_mode: bool = True):
    """Scope that records gradients and, by default, runs in training
    mode."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope that records nothing (and by default predicts)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Scope of training mode that leaves recording as it is."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Scope of predict mode that leaves recording as it is."""
    return _RecordingStateScope(None, False)


# -- the marked leaves -------------------------------------------------------
#
# Owners of a leaf that takes gradients: NDArray variables (attach_grad,
# mark_variables) and Gluon parameters. Each has ``_ag_leaf()`` (its leaf
# tensor, or None when it takes no gradient now) and ``_ag_receive(g)``
# (write or add g by its grad_req).
# (by id: an NDArray is unhashable, as in the reference)
_MARKED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _track(owner) -> None:
    _MARKED[id(owner)] = owner


def mark_variables(variables, gradients, grad_reqs="write"):
    """Give each NDArray variable its gradient buffer and ``grad_req``
    (reference ``Imperative::MarkVariables``)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._mark_variable(g, req)


def _is_nd(x) -> bool:
    from .ndarray.ndarray import NDArray
    return isinstance(x, NDArray)


def _head_grads(heads, head_grads):
    out = []
    for h, g in zip(heads, head_grads):
        if g is None:
            out.append(torch.ones_like(h))
        elif isinstance(g, torch.Tensor):
            out.append(g)
        elif _is_nd(g):
            out.append(g._data)
        else:
            out.append(torch.as_tensor(g, dtype=h.dtype, device=h.device))
    return out


def backward(heads: Union[torch.Tensor, Sequence], head_grads=None,
             retain_graph: bool = False) -> None:
    """Gradients of ``heads``: into the Gluon parameters' grads for tensor
    heads, into the marked variables' and parameters' grads for NDArray
    heads (see the module docstring). A head without a head gradient gets
    ones, as in the reference, so a per-sample loss vector back-propagates
    its sum."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        head_grads = None if head_grads is None else [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    if not any(_is_nd(h) for h in heads):
        torch.autograd.backward(list(heads),
                                _head_grads(heads, head_grads),
                                retain_graph=retain_graph or None)
        return
    tensors = [h._data if _is_nd(h) else h for h in heads]
    keep = [(t, g) for t, g in zip(tensors, _head_grads(tensors, head_grads))
            if t.requires_grad]
    owners = [o for o in list(_MARKED.values())
              if o._ag_leaf() is not None]
    if not keep or not owners:
        return
    grads = torch.autograd.grad([t for t, _ in keep], [o._ag_leaf()
                                                      for o in owners],
                                [g for _, g in keep],
                                retain_graph=retain_graph, allow_unused=True)
    for o, g in zip(owners, grads):
        if g is not None:
            o._ag_receive(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False):
    """Gradients of ``heads`` with respect to ``variables`` (NDArrays),
    returned as NDArrays; no ``.grad`` is written (reference
    ``autograd.py:272``). A variable that was tracked (marked, or read by
    an op recorded through ``invoke``) but that the heads do not reach
    gets zeros. A variable that was never tracked raises
    :class:`MXNetError`: torch cannot differentiate after the fact with
    respect to a tensor that took no gradient when the ops ran (an NDArray
    fed to a Gluon block is read untracked), where the reference records
    every op and would return the true gradient.
    ``create_graph=True`` records the gradients' own graph, so they can be
    differentiated again. ``retain_graph`` defaults to keeping the graph,
    as in the reference."""
    from .ndarray.ndarray import _wrap

    heads_l = list(heads) if isinstance(heads, (list, tuple)) else [heads]
    single = not isinstance(variables, (list, tuple))
    vars_l = [variables] if single else list(variables)
    if head_grads is None:
        hg = [None] * len(heads_l)
    elif isinstance(head_grads, (list, tuple)):
        hg = list(head_grads)
    else:
        hg = [head_grads]
    tensors = [h._data for h in heads_l]
    keep = [(t, g) for t, g in zip(tensors, _head_grads(tensors, hg))
            if t.requires_grad]
    wrt = [v._data for v in vars_l]
    untracked = [i for i, t in enumerate(wrt) if not t.requires_grad]
    if untracked:
        raise MXNetError(
            f"autograd.grad: variables {untracked} were never tracked, so "
            "their gradient cannot be computed; call attach_grad() on them, "
            "or read them through recorded nd ops, before the forward")
    got = [None] * len(wrt)
    if keep:
        got = torch.autograd.grad(
            [t for t, _ in keep], wrt, [g for _, g in keep],
            retain_graph=True if retain_graph is None else retain_graph,
            create_graph=create_graph, allow_unused=True)
    out = [_wrap(torch.zeros_like(v._data) if g is None else g, v._ctx)
           for v, g in zip(vars_l, got)]
    return out[0] if single else out


class _FunctionNode(torch.autograd.Function):
    """A custom :class:`Function` as one torch autograd node: its forward
    and backward run the user's NDArray methods with recording paused."""

    @staticmethod
    def forward(ctx, fn, out_ctx, *tensors):
        from .ndarray.ndarray import _wrap

        with pause():
            outputs = fn.forward(*[_wrap(t, out_ctx) for t in tensors])
        single = not isinstance(outputs, (list, tuple))
        ctx.fn, ctx.out_ctx = fn, out_ctx
        fn._single_out = single
        ctx.n_in = len(tensors)
        outs = [outputs] if single else list(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        from .ndarray.ndarray import _wrap

        with pause():
            in_grads = ctx.fn.backward(*[_wrap(g, ctx.out_ctx)
                                         for g in gouts])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        grads = [None if g is None else g._data for g in in_grads]
        grads += [None] * (ctx.n_in - len(grads))
        return (None, None) + tuple(grads)


class Function:
    """A user-defined differentiable function (reference
    ``autograd.py:369-519``): subclass it with ``forward(self, *inputs)``
    and ``backward(self, *output_grads)`` on NDArrays. Recording is paused
    inside both; under ``record()`` the call is one node of torch's
    graph."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import _recorded_input, _wrap

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        tensors = [_recorded_input(i) for i in inputs]
        out_ctx = inputs[0]._ctx
        outs = _FunctionNode.apply(self, out_ctx, *tensors)
        wrapped = [_wrap(o, out_ctx) for o in outs]
        return wrapped[0] if self._single_out else wrapped
