"""``mx.amp``: automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (after the reference's
``python/mxnet/contrib/amp/amp.py:281-454``). ``init()`` installs a cast
policy per op at the dispatch layer (``ndarray.invoke`` and
``ndarray.tensor_op``, through which the Gluon layers dispatch): an op of
``lists.LOW_PRECISION_FUNCS`` casts its fp32 inputs down to the AMP dtype,
one of ``FP32_FUNCS`` casts them back up, one of ``WIDEST_TYPE_CASTS``
follows its widest input, the rest are left alone. The cast runs inside
the op, within what autograd records, so the backward hands each input its
cotangent in the input's own dtype. bfloat16 by default (fp32's exponent
range, no loss scaling); float16 with a dynamic ``LossScaler``.

``init`` and ``uninit`` bump ``ndarray._amp_generation``, which every
captured program's key holds (``program_store.knob_key``), so a hybridized
block, a compiled step or a serving engine captures anew under the new
policy instead of replaying the old casts.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "uninit", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "LossScaler", "lists"]

_LOW = frozenset(lists.LOW_PRECISION_FUNCS)
_F32 = frozenset(lists.FP32_FUNCS)
_WIDEST = frozenset(lists.WIDEST_TYPE_CASTS)

# the fused conv + batch-norm ops: the conv operands (x, w, bias, residual)
# follow Convolution's cast down, while the trailing gamma and beta are
# BatchNorm's parameters and stay fp32, as on the unfused path (BatchNorm
# is in FP32_FUNCS); the kernels accumulate in fp32 either way
_FUSED_CONV_BN = frozenset(("_fused_conv1x1_bn", "_fused_convkxk_bn",
                            "_fused_conv1x1_bn_act"))


class _AmpState:
    """The process-wide AMP state (the dispatch hook is global, so the
    policy is too)."""

    def __init__(self):
        self.target_dtype: Optional[torch.dtype] = None
        self.loss_scaler: Optional[LossScaler] = None


_STATE = _AmpState()


def _is(a, dtype) -> bool:
    return isinstance(a, torch.Tensor) and a.dtype == dtype


def _policy(op_name, arrays):
    """The op's inputs cast by the lists (called from the dispatch)."""
    target = _STATE.target_dtype
    if target is None:
        return arrays
    f32 = torch.float32
    if op_name in _FUSED_CONV_BN:
        head = [a.to(target) if _is(a, f32) else a for a in arrays[:-2]]
        return head + list(arrays[-2:])
    if op_name in _LOW:
        return [a.to(target) if _is(a, f32) else a for a in arrays]
    if op_name in _F32:
        return [a.to(f32) if _is(a, target) else a for a in arrays]
    if op_name in _WIDEST:
        dtypes = {a.dtype for a in arrays if isinstance(a, torch.Tensor)}
        if f32 in dtypes and target in dtypes:
            return [a.to(f32) if _is(a, target) else a for a in arrays]
    return arrays


def _target(target_dtype) -> torch.dtype:
    if target_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if target_dtype in ("float16", torch.float16):
        return torch.float16
    raise ValueError("target_dtype must be bfloat16 or float16")


def _set_policy(policy) -> None:
    from ..ndarray import ndarray as _ndmod

    _ndmod._amp_policy = policy
    _ndmod._amp_generation += 1


def init(target_dtype="bfloat16"):
    """Enable AMP for the process (reference ``amp.init``): bfloat16 (the
    default, no loss scaler) or float16 (a fresh ``LossScaler``). Bumps the
    AMP generation, so captured programs capture anew."""
    _STATE.target_dtype = _target(target_dtype)
    _STATE.loss_scaler = LossScaler() \
        if _STATE.target_dtype == torch.float16 else None
    _set_policy(_policy)


def uninit():
    """Disable AMP; bumps the generation as :func:`init` does."""
    _STATE.target_dtype = None
    _STATE.loss_scaler = None
    _set_policy(None)


def init_trainer(trainer):
    """Attach the loss scaler to a Trainer (reference ``amp.init_trainer``).
    A trainer that updates on its kvstore is refused: an overflowed update
    applied there could not be skipped."""
    if getattr(trainer, "_update_on_kvstore", None):
        raise MXNetError(
            "AMP does not support update_on_kvstore=True: overflowed "
            "updates applied server-side cannot be skipped; create the "
            "Trainer with update_on_kvstore=False")
    if _STATE.target_dtype == torch.float16 and _STATE.loss_scaler is None:
        _STATE.loss_scaler = LossScaler()
    trainer._amp_loss_scaler = _STATE.loss_scaler
    trainer._amp_original_scale = getattr(trainer, "_scale", 1.0)


class _ScaleLossCtx:
    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer

    def __enter__(self):
        scaler = getattr(self._trainer, "_amp_loss_scaler", None)
        scale = scaler.loss_scale if scaler is not None else 1.0
        if hasattr(self._trainer, "_scale"):
            # re-derived from the saved base each time, so the division
            # follows the current scale (1.0 after decay included)
            base = getattr(self._trainer, "_amp_original_scale",
                           self._trainer._scale)
            self._trainer._amp_original_scale = base
            self._trainer._scale = base / scale
        if isinstance(self._loss, (list, tuple)):
            return [l * scale for l in self._loss] if scale != 1.0 \
                else list(self._loss)
        return self._loss * scale if scale != 1.0 else self._loss

    def __exit__(self, *exc):
        return False


def scale_loss(loss, trainer):
    """Context manager: the loss times the current scale, with the trainer's
    rescale divided by it so that ``trainer.step`` unscales the gradients
    (reference ``amp.scale_loss``)."""
    return _ScaleLossCtx(loss, trainer)


def unscale(trainer):
    """Divide the gradients by the current scale now (before clipping them
    by hand, say) and reset the trainer's rescale so that the step does not
    divide again (reference ``amp.unscale``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req == "null" or p._data is None:
                continue
            g = p._data.grad
            if g is not None:
                g.mul_(inv)
    trainer._scale = getattr(trainer, "_amp_original_scale", trainer._scale)


_F32_LAYERS = ("BatchNorm", "SyncBatchNorm", "LayerNorm", "GroupNorm",
               "InstanceNorm")


def convert_hybrid_block(net, target_dtype="bfloat16", ctx=None):
    """Cast a block for low-precision inference or training (reference
    ``amp.convert_hybrid_block``): parameters to ``target_dtype``, except
    those of normalization layers, which stay fp32 (the op policy casts
    their inputs up), and the block's floating inputs cast on ``forward``,
    inside what a hybridized block captures. ``ctx`` also moves the
    parameters to that context's device."""
    dtype = _target(target_dtype)

    def walk(block):
        if type(block).__name__ in _F32_LAYERS:
            return
        for p in block._reg_params.values():
            if p._data is not None:
                p.cast(dtype)
            else:
                p.dtype = dtype
        for child in block._children.values():
            walk(child)

    walk(net)
    orig_forward = net.forward

    def cast_in(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(dtype)
        return a

    def cast_forward(*args, **kwargs):
        return orig_forward(*[cast_in(a) for a in args],
                            **{k: cast_in(v) for k, v in kwargs.items()})

    net.forward = cast_forward
    if getattr(net, "_programs", None) is not None:
        net._programs = None            # capture anew under the new dtypes
    if ctx is not None:
        from ..context import resolve_device

        device = resolve_device(ctx)
        for p in net.collect_params().values():
            if p._data is not None and p._data.device != device:
                p._set_leaf(p._data.detach().to(device))
    return net
