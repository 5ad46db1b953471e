"""Shape buckets: the part of the serving layer that bucketing needs.

Counterpart of the bucket grid of ``mxnet_tpu/serving.py``
(``BucketPolicy`` :113-170, ``pad_axis0`` :171, ``pad_to_shape`` :180,
``bucket_stats``, ``reset_counters``). A variable axis is padded up to a
bucket of a grid, so that a stream of lengths hits a bounded set of
programs; ``Trainer.compile_step(bucket=True)`` (``cached_step.py``) and
``HybridBlock.hybridize(bucket=True)`` (``gluon/block.py``) pad through
:class:`BucketPolicy` and check the padded result against the unpadded one
once per bucket (``MXNET_SERVE_VERIFY``) before they trust it.

:func:`bucket_stats` counts the padded calls of those two users in the
program store's ``serving`` namespace: a miss is the first call of a
bucketed signature (the one that is verified and captured), a hit every
later one. ``ServingEngine`` and the micro-batcher are not ported yet
(ROADMAP A5); they will count their programs there too.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import config as _config
from . import program_store as _pstore

__all__ = ["BucketPolicy", "pad_axis0", "pad_to_shape", "bucket_stats",
           "reset_counters"]

_NS = _pstore.namespace("serving")


def bucket_stats() -> Dict[str, int]:
    return {"hits": _NS.hits, "misses": _NS.misses}


def reset_counters() -> None:
    _NS.reset()


class BucketPolicy:
    """Maps a dynamic axis length to its padded bucket length.

    Spec (``MXNET_SHAPE_BUCKETS``):

    - ``"pow2"`` (default): round up to the next power of two;
    - ``"none"``: bucketing off (every shape stays exact);
    - ``"8,16,32,64"``: an ascending grid; a length above the largest
      bucket returns ``None`` (the caller keeps the exact shape).
    """

    def __init__(self, spec: Optional[str] = None):
        spec = (spec if spec is not None
                else _config.get("MXNET_SHAPE_BUCKETS")).strip().lower()
        self.spec = spec
        self._grid: Optional[Tuple[int, ...]] = None
        if spec not in ("pow2", "none"):
            try:
                grid = tuple(sorted({int(t) for t in spec.split(",") if t}))
            except ValueError:
                raise ValueError(
                    f"MXNET_SHAPE_BUCKETS={spec!r}: expected 'pow2', "
                    "'none', or a comma list of ints") from None
            if not grid or grid[0] < 1:
                raise ValueError(
                    f"MXNET_SHAPE_BUCKETS={spec!r}: buckets must be >= 1")
            self._grid = grid

    @property
    def enabled(self) -> bool:
        return self.spec != "none"

    def buckets(self) -> Optional[Tuple[int, ...]]:
        """The explicit grid, or None for pow2 and none."""
        return self._grid

    def bucket(self, n: int) -> Optional[int]:
        """Padded length for a true length ``n``; ``None`` when no bucket
        covers it (explicit grid only): the caller keeps the exact
        shape."""
        if not self.enabled:
            return n
        if self._grid is None:
            b = 1
            while b < n:
                b <<= 1
            return b
        for b in self._grid:
            if b >= n:
                return b
        return None

    def __repr__(self):
        return f"BucketPolicy({self.spec!r})"


def pad_axis0(data: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the leading axis up to ``target`` rows."""
    n = data.shape[0]
    if n == target:
        return data
    return torch.cat([data, data.new_zeros((target - n,) + data.shape[1:])])


def pad_to_shape(data: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Zero-pad every axis at its end up to ``shape``."""
    if tuple(data.shape) == tuple(shape):
        return data
    pads = []
    for s, t in reversed(list(zip(data.shape, shape))):
        pads += [0, int(t) - int(s)]
    return F.pad(data, pads)
