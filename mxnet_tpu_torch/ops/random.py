"""Sampling operators (counterpart of ``mxnet_tpu/ops/random.py``).

Each op draws from the generator of the device it runs on
(``random.generator``): the current context's for the samplers without an
input, the input's for ``multinomial`` and ``shuffle``. The reference draws
from a threefry key instead, so the port's draws have the reference's
distribution, shape and dtype, but not its values (ROADMAP Queue C); the
same seed gives the same draws within the port. The ``key`` attribute of
the reference's signature is accepted and ignored.
"""
from __future__ import annotations

import math

import torch

from .. import random as _rng
from ..base import MXNetError, op_dtype
from ..context import resolve_device
from .registry import register


def _dt(dtype):
    return torch.float32 if dtype in (None, "None") else op_dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dev_gen(device=None):
    device = resolve_device(None) if device is None else device
    return device, _rng.generator(device)


def _standard_gamma(alpha: float, shape, device, gen) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's method, every normal
    and uniform from ``gen`` (fp32)."""
    alpha = float(alpha)
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=gen, device=device)
        u = torch.rand(m, generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(n, generator=gen, device=device)
        out = out * u ** (1.0 / alpha)
    return out.reshape(shape)


@register("uniform", num_inputs=0, differentiable=False,
          aliases=["random_uniform", "_sample_uniform"], draws_key=True)
def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    u = torch.rand(_shape(shape), generator=gen, device=device,
                   dtype=_dt(dtype))
    return u * (high - low) + low


@register("normal", num_inputs=0, differentiable=False,
          aliases=["random_normal", "_sample_normal"], draws_key=True)
def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, key=None):
    if isinstance(scale, (int, float)) and float(scale) < 0:
        raise MXNetError(f"normal: scale must be non-negative, got {scale}")
    device, gen = _dev_gen()
    return loc + scale * torch.randn(_shape(shape), generator=gen,
                                     device=device, dtype=_dt(dtype))


@register("random_gamma", num_inputs=0, differentiable=False,
          aliases=["_sample_gamma"], draws_key=True)
def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    g = _standard_gamma(alpha, _shape(shape), device, gen)
    return (g * beta).to(_dt(dtype))


@register("exponential", num_inputs=0, differentiable=False,
          aliases=["random_exponential"], draws_key=True)
def exponential(lam=1.0, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    e = torch.empty(_shape(shape), device=device,
                    dtype=_dt(dtype)).exponential_(generator=gen)
    return e / lam


@register("poisson", num_inputs=0, differentiable=False,
          aliases=["random_poisson"], draws_key=True)
def poisson(lam=1.0, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    rate = torch.full(_shape(shape), float(lam), device=device)
    return torch.poisson(rate, generator=gen).to(_dt(dtype))


@register("negative_binomial", num_inputs=0, differentiable=False,
          aliases=["random_negative_binomial"], draws_key=True)
def negative_binomial(k=1, p=1.0, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    lam = _standard_gamma(k, _shape(shape), device, gen) * ((1 - p) / p)
    return torch.poisson(lam, generator=gen).to(_dt(dtype))


@register("randint", num_inputs=0, differentiable=False,
          aliases=["random_randint"], draws_key=True)
def randint(low=0, high=1, shape=(1,), dtype="int32", key=None):
    device, gen = _dev_gen()
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=device, dtype=_dt(dtype))


@register("randn", num_inputs=0, differentiable=False, draws_key=True)
def randn(shape=(1,), loc=0.0, scale=1.0, dtype=None, key=None):
    device, gen = _dev_gen()
    return loc + scale * torch.randn(_shape(shape), generator=gen,
                                     device=device, dtype=_dt(dtype))


@register("multinomial", num_inputs=1, differentiable=False,
          aliases=["sample_multinomial"], draws_key=True)
def multinomial(data, shape=1, get_prob=False, dtype="int32", key=None):
    """``shape`` draws of each row's category, by the row's probabilities
    (``get_prob`` is accepted and ignored, as in the reference)."""
    gen = _rng.generator(data.device)
    n = shape if isinstance(shape, int) else math.prod(shape)
    probs = torch.clamp_min(data.float(), 1e-30)
    if data.dim() == 1:
        out = torch.multinomial(probs, n, replacement=True, generator=gen)
    else:
        out = torch.multinomial(probs, n, replacement=True, generator=gen)
        if n == 1 and isinstance(shape, int) and shape == 1:
            out = out[:, 0]
    return out.to(_dt(dtype))


@register("shuffle", num_inputs=1, differentiable=False,
          aliases=["_shuffle"], draws_key=True)
def shuffle(data, key=None):
    gen = _rng.generator(data.device)
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]


@register("bernoulli", num_inputs=0, differentiable=False, draws_key=True)
def bernoulli(prob=0.5, shape=(1,), dtype=None, key=None):
    device, gen = _dev_gen()
    u = torch.rand(_shape(shape), generator=gen, device=device)
    return (u < prob).to(_dt(dtype))
