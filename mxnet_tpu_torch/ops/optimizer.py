"""Optimizer update operators (counterpart of ``mxnet_tpu/ops/optimizer.py``,
which runs them as device-side ops as the reference does,
``src/operator/optimizer_op.cc``).

Each function returns new tensors and leaves its inputs alone, as the
reference's registry functions are pure; the caller writes the results
back (``out=`` through ``invoke``; ``parallel.train.ShardedTrainer`` copies
them into its fixed buffers). Every expression keeps the reference's order
of operations, so in fp32 each intermediate rounds as the reference's does:
``g = grad * rescale_grad`` (clipped where ``clip_gradient >= 0``), then
``g + wd * weight``, and so on. Hyper-parameters may be Python numbers or
0-dim fp32 tensors (the step count ``t`` of a captured step lives on the
device); an fp32 value multiplies the same either way.

The multi-tensor ops take the reference's interleaved inputs (``w0, g0,
(states0,) w1, g1, ...``) and return their outputs blocked by kind (every
new weight, then every new state of each kind).
"""
from __future__ import annotations

import torch

from .registry import register


def _rescaled(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _rescaled(grad, rescale_grad, clip_gradient) + wd * weight


def _present_rows(grad, weight):
    """lazy_update's rows: those the gradient touches (all-zero rows are
    the dense form of rows a row-sparse gradient lacks)."""
    present = torch.any(grad != 0, dim=tuple(range(1, grad.dim()))) \
        if grad.dim() > 1 else grad != 0
    return present.reshape((-1,) + (1,) * (weight.dim() - 1))


def _norm(x):
    return torch.linalg.vector_norm(x)


@register("sgd_update", num_inputs=2, num_outputs=1, differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False):
    """``weight - lr * (grad * rescale_grad + wd * weight)``; with
    ``lazy_update`` rows the gradient does not touch keep their weights
    exactly."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_w = weight - lr * g
    if lazy_update and grad.dim() >= 1:
        return torch.where(_present_rows(grad, weight), new_w, weight)
    return new_w


@register("sgd_mom_update", num_inputs=3, num_outputs=-1,
          differentiable=False)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    """``mom' = momentum * mom - lr * g``, ``weight' = weight + mom'``;
    returns ``(weight', mom')``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    if lazy_update and grad.dim() >= 1:
        p = _present_rows(grad, weight)
        new_mom = torch.where(p, new_mom, mom)
        return torch.where(p, weight + new_mom, weight), new_mom
    return weight + new_mom, new_mom


@register("nag_mom_update", num_inputs=3, num_outputs=-1,
          differentiable=False)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("adam_update", num_inputs=4, num_outputs=-1, differentiable=False)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):
    """Adam with L2 weight decay folded into the gradient; returns
    ``(weight', mean', var')``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    out = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return out, new_mean, new_var


@register("adamw_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
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


@register("rmsprop_update", num_inputs=3, num_outputs=-1,
          differentiable=False)
def rmsprop_update(weight, grad, n, lr=0.001, rho=0.9, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = rho * n + (1 - rho) * torch.square(g)
    out = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        out = torch.clamp(out, -clip_weights, clip_weights)
    return out, new_n


@register("rmspropalex_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def rmspropalex_update(arrays, lr=0.001, rho=0.95, momentum=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    weight, grad, n, g_acc, delta = arrays
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = rho * n + (1 - rho) * torch.square(g)
    new_g = rho * g_acc + (1 - rho) * g
    new_delta = momentum * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    out = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        out = torch.clamp(out, -clip_weights, clip_weights)
    return out, new_n, new_g, new_delta


@register("ftrl_update", num_inputs=-1, num_outputs=-1, differentiable=False)
def ftrl_update(arrays, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    weight, grad, z, n = arrays
    g = _rescaled(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    out = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return out, new_z, new_n


@register("signsgd_update", num_inputs=2, differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_inputs=3, num_outputs=-1,
          differentiable=False)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    out = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom) \
        - lr * wd * weight
    return out, new_mom


@register("adagrad_update", num_inputs=3, num_outputs=-1,
          differentiable=False, aliases=["_sparse_adagrad_update"])
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


@register("adadelta_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def adadelta_update(arrays, rho=0.9, epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    weight, grad, acc_g, acc_delta = arrays
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(new_acc_g
                                                         + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


@register("lamb_update_phase1", num_inputs=4, num_outputs=-1,
          differentiable=False)
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
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    update = m / (torch.sqrt(v) + epsilon) + wd * weight
    return update, new_mean, new_var


@register("lamb_update_phase2", num_inputs=-1, differentiable=False)
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


# -- multi-tensor updates --------------------------------------------------------

def _interleaved(arrays, kinds, num_weights=0, trailing=0):
    """Split the reference's interleaved multi-tensor inputs into per-kind
    tuples; ``trailing`` arrays (lrs, wds) follow the body."""
    body_len = len(arrays) - trailing
    n = num_weights or body_len // kinds
    if body_len != n * kinds:
        raise ValueError(
            f"multi-tensor op expects {kinds} interleaved arrays per weight"
            f" (+{trailing} trailing); got {len(arrays)} arrays for"
            f" num_weights={n}")
    groups = tuple(tuple(arrays[i * kinds + k] for i in range(n))
                   for k in range(kinds))
    return n, groups, tuple(arrays[body_len:])


@register("multi_sgd_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_sgd_update(arrays, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=0):
    _, (ws, gs), _ = _interleaved(arrays, 2, num_weights)
    return tuple(w - lr * _apply_wd(g, w, wd, rescale_grad, clip_gradient)
                 for w, g, lr, wd in zip(ws, gs, lrs, wds))


@register("multi_sgd_mom_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_sgd_mom_update(arrays, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=0):
    _, (ws, gs, ms), _ = _interleaved(arrays, 3, num_weights)
    new_w, new_m = [], []
    for w, g, m, lr, wd in zip(ws, gs, ms, lrs, wds):
        nm = momentum * m - lr * _apply_wd(g, w, wd, rescale_grad,
                                           clip_gradient)
        new_w.append(w + nm)
        new_m.append(nm)
    return tuple(new_w) + tuple(new_m)


@register("multi_sum_sq", num_inputs=-1, num_outputs=1,
          differentiable=False)
def multi_sum_sq(arrays, num_arrays=0):
    return torch.stack([torch.sum(torch.square(a.float())) for a in arrays])


def _clip_norm(r, lower_bound, upper_bound):
    if lower_bound is not None and lower_bound > 0:
        r = torch.clamp_min(r, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r = torch.clamp_max(r, upper_bound)
    return r


def _ratio(r1, r2):
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@register("multi_lamb_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_lamb_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                      beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                      bias_correction=True, step_count=(), num_tensors=0):
    """Fused multi-tensor LAMB: ``[w0, g0, m0, v0, w1, ...]`` ->
    ``(w..., m..., v...)``."""
    _, (ws, gs, ms, vs), _ = _interleaved(arrays, 4, num_tensors)
    new_w, new_m, new_v = [], [], []
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        t = step_count[i] if i < len(step_count) else 1
        g = _rescaled(g.float(), rescale_grad, clip_gradient)
        m_n = beta1 * m + (1 - beta1) * g
        v_n = beta2 * v + (1 - beta2) * torch.square(g)
        mh, vh = m_n, v_n
        if bias_correction:
            mh = m_n / (1 - beta1 ** t)
            vh = v_n / (1 - beta2 ** t)
        wf = w.float()
        upd = mh / (torch.sqrt(vh) + epsilon) + wds[i] * wf
        r1 = _clip_norm(_norm(wf), lower_bound, upper_bound)
        ratio = _ratio(r1, _norm(upd))
        new_w.append((wf - learning_rates[i] * ratio * upd).to(w.dtype))
        new_m.append(m_n)
        new_v.append(v_n)
    return tuple(new_w) + tuple(new_m) + tuple(new_v)


@register("multi_lans_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_lans_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                      beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                      step_count=(), num_tensors=0):
    """Fused multi-tensor LANS (reference ``contrib/multi_lans.cc``): the
    gradient L2-normalised before the moments, the update a blend of a
    momentum and a gradient direction, each with its own trust ratio."""
    _, (ws, gs, ms, vs), _ = _interleaved(arrays, 4, num_tensors)
    new_w, new_m, new_v = [], [], []
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        t = step_count[i] if i < len(step_count) else 1
        gf = g.float() * rescale_grad
        sg = gf / torch.clamp_min(_norm(gf), 1e-12)
        if clip_gradient is not None and clip_gradient >= 0:
            sg = torch.clamp(sg, -clip_gradient, clip_gradient)
        m_n = beta1 * m + (1 - beta1) * sg
        v_n = beta2 * v + (1 - beta2) * torch.square(sg)
        mh = m_n / (1 - beta1 ** t)
        vh = torch.sqrt(v_n / (1 - beta2 ** t)) + epsilon
        wf = w.float()
        d_m = mh / vh + wds[i] * wf
        d_g = sg / vh + wds[i] * wf
        r1 = _clip_norm(_norm(wf), lower_bound, upper_bound)
        upd = beta1 * _ratio(r1, _norm(d_m)) * d_m \
            + (1 - beta1) * _ratio(r1, _norm(d_g)) * d_g
        new_w.append((wf - learning_rates[i] * upd).to(w.dtype))
        new_m.append(m_n)
        new_v.append(v_n)
    return tuple(new_w) + tuple(new_m) + tuple(new_v)


# -- mixed precision: fp16/bf16 weights with an fp32 master ---------------------

def _mp(update_fn, weight, weight32, *states, **kw):
    out = update_fn(weight32, *states, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    return (outs[0].to(weight.dtype), outs[0]) + outs[1:]


@register("mp_sgd_update", num_inputs=3, num_outputs=-1,
          differentiable=False)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False):
    """SGD on the fp32 master weight; returns ``(weight_cast, weight32)``."""
    return _mp(sgd_update, weight, weight32, grad.float(), lr=lr, wd=wd,
               rescale_grad=rescale_grad, clip_gradient=clip_gradient)


@register("mp_sgd_mom_update", num_inputs=4, num_outputs=-1,
          differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False):
    new_w32, new_mom = sgd_mom_update(
        weight32, grad.float(), mom, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("mp_nag_mom_update", num_inputs=4, num_outputs=-1,
          differentiable=False)
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    new_w32, new_mom = nag_mom_update(
        weight32, grad.float(), mom, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("mp_lamb_update_phase1", num_inputs=5, num_outputs=-1,
          differentiable=False)
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                          bias_correction=True, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """LAMB phase 1 against the fp32 master weight."""
    w = weight32 if weight32 is not None else weight.float()
    return lamb_update_phase1(
        w, grad.float(), mean, var, beta1=beta1, beta2=beta2,
        epsilon=epsilon, t=t, wd=wd, bias_correction=bias_correction,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)


@register("mp_lamb_update_phase2", num_inputs=-1, num_outputs=1,
          differentiable=False)
def mp_lamb_update_phase2(arrays, lr=0.01, lower_bound=-1.0,
                          upper_bound=-1.0):
    """``(weight, g_update, r1, r2, weight32)`` -> the narrow weight."""
    weight, g_update, r1, r2, weight32 = arrays
    new_w32 = lamb_update_phase2([weight32, g_update, r1, r2], lr=lr,
                                 lower_bound=lower_bound,
                                 upper_bound=upper_bound)
    return new_w32.to(weight.dtype)


@register("ftml_update", num_inputs=5, num_outputs=-1, differentiable=False)
def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """FTML (reference ``optimizer_op-inl.h`` FTMLKernel): returns
    ``(weight, d, v, z)``."""
    g = _rescaled(grad, rescale_grad, clip_grad) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    new_z = beta1 * z + (1 - beta1) * g - (d_t - beta1 * d) * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("multi_lars", num_inputs=4, num_outputs=1, differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """LARS coefficients from per-tensor squared norms."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq)
    valid = (w_norm > 0) & (grads_sum_sq > 0)
    scaled = lrs * eta * w_norm / (g_norm * rescale_grad + wds * w_norm
                                   + eps)
    return torch.where(valid, scaled, lrs)


@register("group_adagrad_update", num_inputs=3, num_outputs=-1,
          differentiable=False, aliases=("_contrib_group_adagrad_update",))
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Per-row AdaGrad: history accumulates each row's mean squared
    gradient; returns ``(weight, history)``."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    new_hist = history + torch.mean(torch.square(g),
                                    dim=tuple(range(1, g.dim())))
    denom = torch.sqrt(new_hist) + epsilon
    return (weight - lr * g / denom.reshape((-1,) + (1,) * (g.dim() - 1)),
            new_hist)


# -- preloaded multi-tensor SGD: lrs and wds as tensors ---------------------------

@register("preloaded_multi_sgd_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def preloaded_multi_sgd_update(arrays, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=0):
    """``[w0, g0, w1, g1, ..., lrs, wds]``."""
    _, (ws, gs), (lrs, wds) = _interleaved(arrays, 2, num_weights,
                                           trailing=2)
    return tuple(w - lrs[i] * _apply_wd(g, w, wds[i], rescale_grad,
                                        clip_gradient)
                 for i, (w, g) in enumerate(zip(ws, gs)))


@register("preloaded_multi_sgd_mom_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def preloaded_multi_sgd_mom_update(arrays, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, m0, w1, ..., lrs, wds]``."""
    _, (ws, gs, ms), (lrs, wds) = _interleaved(arrays, 3, num_weights,
                                               trailing=2)
    new_w, new_m = [], []
    for i, (w, g, m) in enumerate(zip(ws, gs, ms)):
        nm = momentum * m - lrs[i] * _apply_wd(g, w, wds[i], rescale_grad,
                                               clip_gradient)
        new_w.append(w + nm)
        new_m.append(nm)
    return tuple(new_w) + tuple(new_m)


@register("preloaded_multi_mp_sgd_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def preloaded_multi_mp_sgd_update(arrays, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, w32_0, w1, ..., lrs, wds]`` -> ``(w..., w32...)``."""
    _, (ws, gs, w32s), (lrs, wds) = _interleaved(arrays, 3, num_weights,
                                                 trailing=2)
    new_w, new_w32 = [], []
    for i, (w, g, w32) in enumerate(zip(ws, gs, w32s)):
        nw32 = w32 - lrs[i] * _apply_wd(g.float(), w32, wds[i],
                                        rescale_grad, clip_gradient)
        new_w.append(nw32.to(w.dtype))
        new_w32.append(nw32)
    return tuple(new_w) + tuple(new_w32)


@register("preloaded_multi_mp_sgd_mom_update", num_inputs=-1,
          num_outputs=-1, differentiable=False)
def preloaded_multi_mp_sgd_mom_update(arrays, momentum=0.0, rescale_grad=1.0,
                                      clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, m0, w32_0, w1, ..., lrs, wds]``."""
    _, (ws, gs, ms, w32s), (lrs, wds) = _interleaved(arrays, 4, num_weights,
                                                     trailing=2)
    new_w, new_m, new_w32 = [], [], []
    for i, (w, g, m, w32) in enumerate(zip(ws, gs, ms, w32s)):
        nm = momentum * m - lrs[i] * _apply_wd(g.float(), w32, wds[i],
                                               rescale_grad, clip_gradient)
        nw32 = w32 + nm
        new_w.append(nw32.to(w.dtype))
        new_m.append(nm)
        new_w32.append(nw32)
    return tuple(new_w) + tuple(new_m) + tuple(new_w32)


@register("multi_mp_sgd_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_mp_sgd_update(arrays, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, w32_0, w1, ...]`` -> ``(w..., w32...)``."""
    _, (ws, gs, w32s), _ = _interleaved(arrays, 3, num_weights)
    new_w, new_w32 = [], []
    for w, g, w32, lr, wd in zip(ws, gs, w32s, lrs, wds):
        nw32 = w32 - lr * _apply_wd(g.float(), w32, wd, rescale_grad,
                                    clip_gradient)
        new_w.append(nw32.to(w.dtype))
        new_w32.append(nw32)
    return tuple(new_w) + tuple(new_w32)


@register("multi_mp_sgd_mom_update", num_inputs=-1, num_outputs=-1,
          differentiable=False)
def multi_mp_sgd_mom_update(arrays, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=0):
    """``[w0, g0, m0, w32_0, w1, ...]`` -> ``(w..., m..., w32...)``."""
    _, (ws, gs, ms, w32s), _ = _interleaved(arrays, 4, num_weights)
    new_w, new_m, new_w32 = [], [], []
    for w, g, m, w32, lr, wd in zip(ws, gs, ms, w32s, lrs, wds):
        nm = momentum * m - lr * _apply_wd(g.float(), w32, wd, rescale_grad,
                                           clip_gradient)
        nw32 = w32 + nm
        new_w.append(nw32.to(w.dtype))
        new_m.append(nm)
        new_w32.append(nw32)
    return tuple(new_w) + tuple(new_m) + tuple(new_w32)


@register("mp_adamw_update", num_inputs=-1, num_outputs=-1,
          differentiable=False, aliases=("_mp_adamw_update",))
def mp_adamw_update(arrays, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, eta=1.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``[weight, grad, mean, var, weight32]`` -> ``(weight_cast, mean,
    var, weight32)``."""
    weight, grad, mean, var, weight32 = arrays[:5]
    new_w32, new_mean, new_var = adamw_update(
        [weight32, grad.float(), mean, var], lr=lr, beta1=beta1, beta2=beta2,
        epsilon=epsilon, wd=wd, eta=eta, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


def _adamw_trailing(arrays, kinds, num_weights):
    """1 where the arrays end in the reference's one trailing rescale_grad
    tensor, else 0."""
    return 1 if (len(arrays) - (num_weights or 0) * kinds == 1
                 or (not num_weights and len(arrays) % kinds == 1)) else 0


@register("multi_adamw_update", num_inputs=-1, num_outputs=-1,
          differentiable=False, aliases=("_multi_adamw_update",))
def multi_adamw_update(arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                       beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                       clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, m0, v0, w1, ...]`` (and optionally one trailing
    rescale_grad tensor) -> ``(w..., m..., v...)``."""
    _, (ws, gs, ms, vs), rest = _interleaved(
        arrays, 4, num_weights, trailing=_adamw_trailing(arrays, 4,
                                                         num_weights))
    if rest:
        rescale_grad = rest[0]
    new_w, new_m, new_v = [], [], []
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        nw, nm, nv = adamw_update(
            [w, g, m, v], lr=lrs[i] if i < len(lrs) else 0.001,
            beta1=beta1, beta2=beta2, epsilon=epsilon,
            wd=wds[i] if i < len(wds) else 0.0,
            eta=etas[i] if i < len(etas) else 1.0,
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        new_w.append(nw)
        new_m.append(nm)
        new_v.append(nv)
    return tuple(new_w) + tuple(new_m) + tuple(new_v)


@register("multi_mp_adamw_update", num_inputs=-1, num_outputs=-1,
          differentiable=False, aliases=("_multi_mp_adamw_update",))
def multi_mp_adamw_update(arrays, lrs=(), wds=(), etas=(), beta1=0.9,
                          beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0, num_weights=0):
    """``[w0, g0, m0, v0, w32_0, w1, ...]`` (and optionally one trailing
    rescale_grad tensor) -> ``(w..., m..., v..., w32...)``."""
    _, (ws, gs, ms, vs, w32s), rest = _interleaved(
        arrays, 5, num_weights, trailing=_adamw_trailing(arrays, 5,
                                                         num_weights))
    if rest:
        rescale_grad = rest[0]
    new_w, new_m, new_v, new_w32 = [], [], [], []
    for i, (w, g, m, v, w32) in enumerate(zip(ws, gs, ms, vs, w32s)):
        nw32, nm, nv = adamw_update(
            [w32, g.float(), m, v], lr=lrs[i] if i < len(lrs) else 0.001,
            beta1=beta1, beta2=beta2, epsilon=epsilon,
            wd=wds[i] if i < len(wds) else 0.0,
            eta=etas[i] if i < len(etas) else 1.0,
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        new_w.append(nw32.to(w.dtype))
        new_m.append(nm)
        new_v.append(nv)
        new_w32.append(nw32)
    return tuple(new_w) + tuple(new_m) + tuple(new_v) + tuple(new_w32)


def _multi_mp(inner_fn, arrays, num_tensors, **kw):
    """A master-weight multi-tensor op through its fp32 form: ``[w0, g0,
    m0, v0, w32_0, w1, ...]`` -> ``(w..., m..., v..., w32...)``."""
    n, (ws, gs, ms, vs, w32s), _ = _interleaved(arrays, 5, num_tensors)
    inner = []
    for w32, g, m, v in zip(w32s, gs, ms, vs):
        inner += [w32, g.float(), m, v]
    packed = inner_fn(inner, num_tensors=n, **kw)
    nw32, nm, nv = packed[:n], packed[n:2 * n], packed[2 * n:3 * n]
    casts = tuple(w32.to(w.dtype) for w, w32 in zip(ws, nw32))
    return casts + tuple(nm) + tuple(nv) + tuple(nw32)


@register("multi_mp_lamb_update", num_inputs=-1, num_outputs=-1,
          differentiable=False, aliases=("_multi_mp_lamb_update",))
def multi_mp_lamb_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                         beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                         lower_bound=-1.0, upper_bound=-1.0,
                         clip_gradient=-1.0, bias_correction=True,
                         step_count=(), num_tensors=0):
    return _multi_mp(multi_lamb_update, arrays, num_tensors,
                     learning_rates=learning_rates, wds=wds, beta1=beta1,
                     beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
                     lower_bound=lower_bound, upper_bound=upper_bound,
                     clip_gradient=clip_gradient,
                     bias_correction=bias_correction, step_count=step_count)


@register("multi_mp_lans_update", num_inputs=-1, num_outputs=-1,
          differentiable=False, aliases=("_multi_mp_lans_update",))
def multi_mp_lans_update(arrays, learning_rates=(), wds=(), beta1=0.9,
                         beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                         lower_bound=-1.0, upper_bound=-1.0,
                         clip_gradient=-1.0, step_count=(), num_tensors=0):
    return _multi_mp(multi_lans_update, arrays, num_tensors,
                     learning_rates=learning_rates, wds=wds, beta1=beta1,
                     beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
                     lower_bound=lower_bound, upper_bound=upper_bound,
                     clip_gradient=clip_gradient, step_count=step_count)
