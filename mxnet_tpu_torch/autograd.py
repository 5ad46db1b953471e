"""Recording and training scopes.

Counterpart of ``mxnet_tpu/autograd.py:44-110`` (and ``backward``). The
flags are thread-local, as in the reference: ``is_recording`` says whether
gradients are being recorded, ``is_training`` whether layers run in
training mode (batch statistics, the fused ResNet epilogue). Gradients
come from torch's own autograd, so there is no tape here: :func:`record`
also enables torch's grad mode and :func:`pause` disables it, and
:func:`backward` is ``torch.autograd.backward`` with the reference's
default head gradient of ones.
"""
from __future__ import annotations

import threading
from typing import Sequence, Union

import torch

__all__ = ["record", "pause", "is_recording", "is_training",
           "set_recording", "set_training", "backward"]


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
    recording."""

    def __init__(self, is_record: bool, train_mode: bool):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev = None

    def __enter__(self):
        self._prev = (set_recording(self._enter_is_record),
                      set_training(self._enter_train_mode),
                      torch.is_grad_enabled())
        torch.set_grad_enabled(self._enter_is_record)
        return self

    def __exit__(self, ptype, value, trace):
        prev_rec, prev_train, prev_grad = self._prev
        set_recording(prev_rec)
        set_training(prev_train)
        torch.set_grad_enabled(prev_grad)


def record(train_mode: bool = True):
    """Scope that records gradients and, by default, runs in training
    mode."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope that records nothing (and by default predicts)."""
    return _RecordingStateScope(False, train_mode)


def backward(heads: Union[torch.Tensor, Sequence[torch.Tensor]],
             head_grads=None) -> None:
    """Gradients of ``heads`` into the parameters' grads. A head without a
    head gradient gets ones, as in the reference, so a per-sample loss
    vector back-propagates its sum."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
        head_grads = None if head_grads is None else [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    torch.autograd.backward(list(heads), grads)
