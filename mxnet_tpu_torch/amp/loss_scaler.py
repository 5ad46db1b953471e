"""Dynamic loss scaler (counterpart of ``mxnet_tpu/amp/loss_scaler.py``,
after the reference's ``python/mxnet/contrib/amp/loss_scaler.py``).

Needed for fp16, optional for bf16 (fp32's exponent range). The policy is
the reference's: the scale doubles after ``scale_window`` clean steps in a
row, halves on an overflow (never below 1.0), and the overflowed step is
skipped.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """True if any gradient of ``params`` (Parameters or tensors) is not
        finite: one device reduction (``optimizer.fused.all_finite``) and
        one host read."""
        from ..optimizer import fused as _fused

        grads = []
        for p in params:
            t = p if isinstance(p, torch.Tensor) else p._data
            g = t.grad if t is not None else None
            if g is not None:
                grads.append(g)
        if not grads:
            return False
        return not bool(_fused.all_finite(grads))

    def branch_scales(self):
        """``(scale_if_clean, scale_if_overflow)``: the scale the next step
        takes under each verdict of the still unread all-finite flag, by the
        policy of :meth:`update_scale`, without changing the state. The
        deferred gate (``cached_step.TrainStep``, ``MXNET_AMP_LAG``)
        dispatches with both and lets the device pick by that flag."""
        if self._unskipped + 1 >= self._scale_window:
            clean = self.loss_scale * self._scale_factor
        else:
            clean = self.loss_scale
        return clean, max(1.0, self.loss_scale / self._scale_factor)

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
