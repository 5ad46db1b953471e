"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the same registry, the same
name-pattern dispatch (``*weight`` by the initializer, ``*bias``/``*beta``/
``running_mean`` to 0, ``*gamma``/``running_var`` to 1) and the same
formulas, for the initializers the port needs so far: ``Zero``, ``One``,
``Uniform`` (the default) and ``Xavier``. Random fills draw on the CPU from
an explicit ``torch.Generator`` (``generator=``; torch's default generator
when none is given) and are then moved to the parameter's device, so a seed
gives the same weights on the CPU and on a GPU. The draws differ from the
reference's threefry keys: tests carry weights over as numpy instead.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Uniform", "Xavier"]

_INIT_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an initializer under its lowercased class name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs) -> "Initializer":
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    if isinstance(init, str):
        key = init.lower()
        if key not in _INIT_REGISTRY:
            raise ValueError(f"unknown initializer '{init}'; registered: "
                             f"{sorted(_INIT_REGISTRY)}")
        return _INIT_REGISTRY[key](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """The parameter's name, with attributes (``force_weight``: fill by the
    initializer whatever the name)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class Initializer:
    """Base class: fills a tensor in place by the parameter's name."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs):
        self._kwargs = kwargs
        self.generator = generator

    def __call__(self, desc, arr: torch.Tensor) -> None:
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.attrs.get("force_weight"):
            self._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            raise ValueError(
                f"Unknown initialization pattern for {desc}. Default "
                "initialization is limited to 'weight', 'bias', 'gamma', "
                "'beta', 'running_mean' and 'running_var'.")

    @staticmethod
    def _fill(arr: torch.Tensor, data: torch.Tensor) -> None:
        with torch.no_grad():
            arr.copy_(data.to(device=arr.device, dtype=arr.dtype))

    def _uniform(self, shape, low: float, high: float) -> torch.Tensor:
        """U(low, high) fp32 on the CPU from this initializer's generator."""
        return torch.empty(shape, dtype=torch.float32).uniform_(
            low, high, generator=self.generator)

    def _init_zero(self, _, arr):
        with torch.no_grad():
            arr.zero_()

    def _init_one(self, _, arr):
        with torch.no_grad():
            arr.fill_(1.0)

    def _init_weight(self, desc, arr):
        raise NotImplementedError("must override _init_weight")


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


_INIT_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference ``Uniform``, the default)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._fill(arr, self._uniform(arr.shape, -self.scale, self.scale))


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference ``initializer.py:262-300``): factor_type
    in/out/avg, rnd_type uniform/gaussian. The fans are the reference's,
    ``shape[1] * prod(shape[2:])`` and ``shape[0] * prod(shape[2:])``, also
    for OHWI conv weights."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier initializer cannot be applied to "
                             f"vector {desc}. It requires at least 2D.")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._fill(arr, self._uniform(shape, -scale, scale))
        elif self.rnd_type == "gaussian":
            self._fill(arr, scale * torch.randn(shape,
                                                generator=self.generator))
        else:
            raise ValueError("Unknown random type")
