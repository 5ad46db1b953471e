"""Functional optimizer updates (counterpart of the update ops of
``mxnet_tpu/ops/optimizer.py``, which run as device-side ops in the
reference, ``src/operator/optimizer_op.cc``).

Each function returns new tensors and leaves its inputs alone, as the
reference's registry functions are pure; the caller writes the results
back (``parallel.train.ShardedTrainer`` copies them into its fixed
buffers). Every expression keeps the reference's order of operations, so
in fp32 each intermediate rounds as the reference's does:
``g = grad * rescale_grad`` (clipped where ``clip_gradient >= 0``), then
``g + wd * weight``, and so on. Hyper-parameters may be Python numbers or
0-dim fp32 tensors (the step count ``t`` of a captured step lives on the
device); an fp32 value multiplies the same either way.

Ported: ``sgd_update`` (:36), ``sgd_mom_update`` (:46), ``adam_update``
(:69), ``adamw_update`` (:80), ``lamb_update_phase1`` (:180) and
``lamb_update_phase2`` (:198), without the row-sparse ``lazy_update``.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "adamw_update",
           "lamb_update_phase1", "lamb_update_phase2"]


def _rescaled(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _rescaled(grad, rescale_grad, clip_gradient) + wd * weight


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``weight - lr * (grad * rescale_grad + wd * weight)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``mom' = momentum * mom - lr * g``, ``weight' = weight + mom'``;
    returns ``(weight', mom')``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam with L2 weight decay folded into the gradient; returns
    ``(weight', mean', var')``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    out = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return out, new_mean, new_var


def adamw_update(arrays, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 wd=0.0, eta=1.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdamW, decoupled decay: ``arrays = [weight, grad, mean, var]``;
    returns ``(weight', mean', var')``."""
    weight, grad, mean, var = arrays[:4]
    g = _rescaled(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    out = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                          + wd * weight)
    return out, new_mean, new_var


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's direction: ``(update, mean', var')`` with
    ``update = m̂ / (sqrt(v̂) + epsilon) + wd * weight``."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / (1 - torch.pow(beta1, t))
        v = v / (1 - torch.pow(beta2, t))
    update = m / (torch.sqrt(v) + epsilon) + wd * weight
    return update, new_mean, new_var


def lamb_update_phase2(arrays, lr=0.01, lower_bound=-1.0, upper_bound=-1.0):
    """LAMB's step: ``arrays = [weight, update, r1, r2]`` (r1 = |weight|,
    r2 = |update|); ``weight - lr * (r1 / r2) * update``, a zero norm read
    as 1."""
    weight, g_update, r1, r2 = arrays
    r1 = torch.where(r1 > 0, r1, torch.ones_like(r1))
    r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
    ratio = r1 / r2
    if lower_bound is not None and lower_bound > 0:
        ratio = torch.clamp_min(ratio, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        ratio = torch.clamp_max(ratio, upper_bound)
    return weight - lr * ratio * g_update
