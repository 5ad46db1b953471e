"""Neural-network operators on tensors.

Counterpart of ``mxnet_tpu/ops/nn.py``: activations, the softmax family,
dense and convolution (and its transpose), pooling, the normalizations,
dropout, the losses as ops, upsampling, ``moments``, and the fused conv +
batch-norm training ops whose kernels are the port's (``cuda_kernels``).
Each is a plain function on ``torch.Tensor``s and each is registered under
the reference's name, signature and attrs (the array inputs of a variadic
op as one list), so ``invoke`` and ``mx.nd`` reach it. The per-op functions
with the port's own signatures (:func:`convolution`, :func:`batch_norm`,
...) are the single implementation; the registered ops unpack the
reference's arguments into them. Plain torch throughout, as the reference
leaves these ops to XLA; the fused ops launch their kernels on CUDA tensors
and run the kernels' plain versions only on CPU tensors.

Conventions are the reference's: ``layout="NHWC"`` tensors are (N, H, W, C)
and their conv weights OHWI (O, kh, kw, I); channel-first layouts (NCW,
NCHW, NCDHW) are the default. Channel-last convolutions and pools run
through torch's channel-first functions on permuted views of the same
memory (``channels_last`` for 2-D), so nothing is copied on the way in.

The reference's MXU channel-padding pass (``MXNET_PAD_CHANNELS``,
``ops/nn.py:184-224``) is a TPU tiling pass that changes no result; it is
not ported.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import config as _config
from .. import random as _rng
from . import cuda_kernels
from .registry import get_op, register


def _global_moments(mean, var, count):
    # parallel imports the ops, so the step's scope is looked up late
    from ..parallel.spmd import global_moments

    return global_moments(mean, var, count)

__all__ = ["activation", "fully_connected", "convolution", "deconvolution",
           "pooling", "batch_norm", "log_softmax", "fused_conv1x1_bn_act",
           "fused_conv1x1_bn", "fused_convkxk_bn"]


# -- activations --------------------------------------------------------------

@register("relu")
def relu(data):
    return torch.relu(data)


@register("sigmoid")
def sigmoid(data):
    return torch.sigmoid(data)


@register("log_sigmoid")
def log_sigmoid(data):
    return F.logsigmoid(data)


@register("softrelu")
def softrelu(data):
    return F.softplus(data)


@register("softsign")
def softsign(data):
    return F.softsign(data)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


@register("mish")
def mish(data):
    return _mish(data)


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "log_sigmoid": F.logsigmoid, "tanh": torch.tanh,
                "softrelu": F.softplus, "softsign": F.softsign,
                "mish": _mish}


@register("Activation")
def activation(data, act_type: str = "relu"):
    """Reference ``Activation``: relu, sigmoid, log_sigmoid, tanh,
    softrelu, softsign or mish."""
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type!r}; one of "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU", num_inputs=-1)
def leaky_relu(arrays, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    data = arrays[0]
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "prelu":
        gamma = arrays[1]
        if gamma.dim() == 1 and data.dim() > 1:
            shape = [1] * data.dim()
            shape[1] = gamma.shape[0]
            gamma = gamma.reshape(shape)
        return torch.where(data >= 0, data, gamma * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError(f"unknown act_type {act_type}")


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    x = data / temperature if temperature else data
    if length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        x = torch.where(steps < length.long()[..., None], x,
                        torch.full((), -math.inf, dtype=x.dtype,
                                   device=x.device))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis: int = -1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("softmin")
def softmin(data, axis=-1, temperature=None):
    x = -data / temperature if temperature else -data
    return torch.softmax(x, dim=axis)


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


# -- dense and convolution ----------------------------------------------------

def fully_connected(data, weight, bias=None, flatten: bool = True):
    """data (N, ...), weight (num_hidden, in_units): ``x @ wᵀ + b``."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


@register("FullyConnected", num_inputs=-1, aliases=["fully_connected"])
def _fully_connected_op(arrays, num_hidden=0, no_bias=False, flatten=True,
                        fused_relu=False):
    out = fully_connected(arrays[0], arrays[1],
                          None if no_bias else arrays[2], flatten)
    return torch.relu(out) if fused_relu else out


def _tup(v, n) -> Tuple[int, ...]:
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(a) for a in v)


def _pair(v) -> Tuple[int, int]:
    return _tup(v, 2)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _default_layout(nsp: int) -> str:
    return {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nsp]


def _channel_last(layout: str) -> bool:
    if layout in ("NCW", "NCHW", "NCDHW"):
        return False
    if layout in ("NWC", "NHWC", "NDHWC"):
        return True
    raise NotImplementedError(f"layout {layout!r} is not ported")


def _to_nchw(x, layout: str):
    """A channel-first view of x: channel-last tensors become permuted
    views (``channels_last`` for 2-D)."""
    if not _channel_last(layout):
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _from_nchw(y, layout: str):
    if not _channel_last(layout):
        return y
    return y.permute(0, *range(2, y.dim()), 1).contiguous()


def _w_first(weight, layout: str):
    """A channel-last layout's weight (O, *k, I) as (O, I, *k)."""
    if not _channel_last(layout):
        return weight
    return weight.permute(0, weight.dim() - 1, *range(1, weight.dim() - 1))


def convolution(data, weight, bias=None, kernel: Sequence[int] = (1, 1),
                stride=(1, 1), dilate=(1, 1), pad=(0, 0), num_group: int = 1,
                layout: str = "NCHW"):
    """1-, 2- or 3-D convolution (reference ``Convolution``). A
    channel-last layout takes its weight with the channels last (OHWI for
    NHWC); both are passed to ``F.convNd`` as permuted views."""
    nsp = len(kernel)
    ksize = tuple(weight.shape[1:1 + nsp] if _channel_last(layout)
                  else weight.shape[2:])
    if ksize != _tup(kernel, nsp):
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"kernel {tuple(kernel)} in layout {layout}")
    out = _CONV[nsp](_to_nchw(data, layout), _w_first(weight, layout), bias,
                     stride=_tup(stride, nsp), padding=_tup(pad, nsp),
                     dilation=_tup(dilate, nsp), groups=num_group)
    return _from_nchw(out, layout)


@register("Convolution", num_inputs=-1, aliases=["conv"])
def _convolution_op(arrays, kernel=None, stride=None, dilate=None, pad=None,
                    num_filter=0, num_group=1, no_bias=False, layout=None,
                    workspace=None, cudnn_tune=None, cudnn_off=None,
                    fused_relu=False):
    """Reference ``Convolution`` (``workspace`` and ``cudnn_*`` accepted for
    parity and ignored)."""
    nsp = len(kernel)
    out = convolution(arrays[0], arrays[1], None if no_bias else arrays[2],
                      kernel=kernel, stride=stride or (1,) * nsp,
                      dilate=dilate or (1,) * nsp, pad=_tup(pad, nsp),
                      num_group=num_group,
                      layout=layout or _default_layout(nsp))
    return torch.relu(out) if fused_relu else out


def deconvolution(data, weight, bias=None, kernel=(1, 1), stride=None,
                  dilate=None, pad=None, adj=None, num_group=1,
                  layout="NCHW"):
    """Transposed convolution (reference ``Deconvolution``): weight (in_c,
    out_c / groups, *kernel) channel-first, (in_c, *kernel, out_c / groups)
    channel-last."""
    nsp = len(kernel)
    w = _w_first(weight, layout)
    out = _CONV_T[nsp](_to_nchw(data, layout), w, bias,
                       stride=_tup(stride or 1, nsp),
                       padding=_tup(pad, nsp),
                       output_padding=_tup(adj, nsp), groups=num_group,
                       dilation=_tup(dilate or 1, nsp))
    return _from_nchw(out, layout)


@register("Deconvolution", num_inputs=-1)
def _deconvolution_op(arrays, kernel=None, stride=None, dilate=None,
                      pad=None, adj=None, target_shape=None, num_filter=0,
                      num_group=1, no_bias=True, layout=None, workspace=None,
                      cudnn_tune=None, cudnn_off=None):
    nsp = len(kernel)
    return deconvolution(arrays[0], arrays[1],
                         None if no_bias else arrays[2], kernel=kernel,
                         stride=stride, dilate=dilate, pad=pad, adj=adj,
                         num_group=num_group,
                         layout=layout or _default_layout(nsp))


# -- pooling --------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pooling(data, kernel=(1, 1), pool_type: str = "max",
            global_pool: bool = False, stride=None, pad=(0, 0),
            pooling_convention: str = "valid", count_include_pad=True,
            layout: str = "NCHW", p_value=2):
    """Reference ``Pooling``: max, avg, sum and lp pooling over 1-3 spatial
    dims, the ``valid`` and ``full`` (ceil) conventions, and global
    pooling. Windows run over the input padded by ``pad`` (and, under
    ``full``, enough more on the right for the last window), padding
    counting as -inf for max and 0 otherwise; ``avg`` divides by the
    kernel's size, or with ``count_include_pad=False`` by the window's
    input elements."""
    nsp = data.dim() - 2
    if global_pool:
        dims = tuple(range(1, 1 + nsp)) if _channel_last(layout) \
            else tuple(range(2, 2 + nsp))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        return data.mean(dim=dims, keepdim=True)
    x = _to_nchw(data, layout)
    kernel, pad = _tup(kernel, nsp), _tup(pad, nsp)
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    extra = [0] * nsp
    if pooling_convention == "full":
        for i in range(nsp):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = stride[i] - rem if rem else 0
    if pool_type == "max" and not any(extra) and all(
            2 * p <= k for p, k in zip(pad, kernel)):
        out = _MAX_POOL[nsp](x, kernel, stride, pad)
        return _from_nchw(out, layout)
    flat = [v for i in reversed(range(nsp)) for v in (pad[i],
                                                       pad[i] + extra[i])]
    if pool_type == "max":
        xp = F.pad(x, flat, value=-math.inf)
        return _from_nchw(_MAX_POOL[nsp](xp, kernel, stride), layout)
    if pool_type == "lp":
        xp = F.pad(torch.abs(x) ** p_value, flat)
        s = _AVG_POOL[nsp](xp, kernel, stride) * math.prod(kernel)
        return _from_nchw(s ** (1.0 / p_value), layout)
    xp = F.pad(x, flat)
    mean = _AVG_POOL[nsp](xp, kernel, stride)
    if pool_type == "sum":
        return _from_nchw(mean * math.prod(kernel), layout)
    if pool_type != "avg":
        raise ValueError(f"unknown pool_type {pool_type}")
    if count_include_pad:
        return _from_nchw(mean, layout)
    ones = F.pad(torch.ones_like(x[:1, :1]), flat)
    count = _AVG_POOL[nsp](ones, kernel, stride)
    return _from_nchw(mean / count, layout)


@register("Pooling")
def _pooling_op(data, kernel=None, pool_type="max", global_pool=False,
                stride=None, pad=None, pooling_convention="valid",
                count_include_pad=True, layout=None, cudnn_off=None,
                p_value=2):
    nsp = data.dim() - 2
    return pooling(data, kernel=kernel, pool_type=pool_type,
                   global_pool=global_pool, stride=stride, pad=pad,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad,
                   layout=layout or _default_layout(nsp), p_value=p_value)


# -- normalization ------------------------------------------------------------

def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=False):
    """Reference ``BatchNorm`` (``ops/nn.py:393-442``). Training: single-pass
    fp32 batch statistics ``E[x]`` and ``max(E[x²] - E[x]², 0)`` (two-pass
    under ``MXNET_BN_TWO_PASS_VAR``); inside a data-parallel step the
    moments of the global batch (``parallel.spmd.global_moments``, as XLA's
    partitioner reduces them in the reference); the affine is folded into
    per-channel fp32 scale and shift, applied in data's dtype. Returns
    ``(out,)``, or ``(out, mean, var)`` in the running stats' dtype when
    training."""
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    batch_stats = training and not use_global_stats
    if batch_stats:
        x32 = data.float()
        mean = x32.mean(dim=red)
        if _config.get("MXNET_BN_TWO_PASS_VAR"):
            var = x32.var(dim=red, unbiased=False)
        else:
            var = torch.clamp_min((x32 * x32).mean(dim=red) - mean * mean,
                                  0.0)
        # inside a data-parallel step, the moments of the global batch
        mean, var, _n = _global_moments(mean, var,
                                             data.numel() // mean.numel())
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var.float() + eps)
    sc = inv if fix_gamma else inv * gamma.float()
    bi = beta.float() - mean.float() * sc
    out = data * sc.reshape(shape).to(data.dtype) \
        + bi.reshape(shape).to(data.dtype)
    if batch_stats:
        return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return (out,)


@register("BatchNorm", num_inputs=-1, num_outputs=-1)
def _batch_norm_op(arrays, eps=1e-3, momentum=0.9, fix_gamma=True,
                   use_global_stats=False, output_mean_var=False, axis=1,
                   cudnn_off=None, training=False):
    """``[data, gamma, beta, moving_mean, moving_var]``; ``(out,)``, or
    ``(out, batch_mean, batch_var)`` in training (the layer folds them into
    the running statistics)."""
    return batch_norm(*arrays, eps=eps, momentum=momentum,
                      fix_gamma=fix_gamma, use_global_stats=use_global_stats,
                      axis=axis, training=training)


def fused_conv1x1_bn_act(x, w, bias, residual, gamma, beta, stride=(1, 1),
                         eps=1e-5, fix_gamma=False, relu=True):
    """The fused-epilogue training op (reference
    ``_fused_conv1x1_bn_act``, ``ops/nn.py:516-556``): 1x1 NHWC conv +
    train-mode batch norm + optional residual + optional ReLU through
    :func:`cuda_kernels.conv1x1_bn_act_train`. A strided 1x1 conv slices
    its input ``x[:, ::sh, ::sw, :]`` (exact: a 1x1 kernel never straddles
    the stride), copied to a contiguous tensor for the kernels. A conv bias
    shifts z and the batch mean equally, so the output does not depend on
    it: it is added to the returned mean only, so the running statistics
    see the biased conv. Returns ``(out, batch_mean, batch_var)``."""
    sh, sw = _pair(stride)
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    return cuda_kernels.conv1x1_bn_act_train(
        x.contiguous(), w, gamma, beta,
        residual=None if residual is None else residual.contiguous(),
        eps=eps, relu=relu, fix_gamma=fix_gamma, bias=bias)


def _fused_bn_epilogue(z, mean, var, gamma, beta, bias, eps, fix_gamma):
    """The normalisation shared by the fused conv + batch-norm ops
    (reference ``ops/nn.py:445-461``), in plain torch, from the kernels'
    moments (of the global batch inside a data-parallel step, combined by
    ``parallel.spmd.global_moments`` between the kernel and here):
    ``z · sc + bi`` in
    z's dtype, with ``sc = rsqrt(var + eps) · gamma`` and ``bi = beta -
    mean · sc`` per channel in fp32. z and mean are the bias-free conv's
    (the bias cancels in (z + b) - (mean + b), and the statistics of the
    unshifted z lose less to cancellation); the bias is then added to the
    returned mean only, so the running statistics see the biased conv.
    Returns ``(out, mean, var)``."""
    inv = torch.rsqrt(var + eps)
    sc = inv if fix_gamma else inv * gamma.float()
    bi = beta.float() - mean * sc
    out = z * sc.to(z.dtype) + bi.to(z.dtype)
    if bias is not None:
        mean = mean + bias.float()
    return out, mean, var


def fused_conv1x1_bn(x, w, bias, gamma, beta, stride=(1, 1), eps=1e-5,
                     fix_gamma=False):
    """Training-mode 1x1 NHWC conv + batch norm with the batch statistics
    taken in the conv's own kernel (reference ``_fused_conv1x1_bn``,
    ``ops/nn.py:464-490``), through
    :func:`cuda_kernels.conv1x1_bn_stats_train`. A strided 1x1 conv slices
    its input ``x[:, ::sh, ::sw, :]`` (exact: a 1x1 kernel never straddles
    the stride), copied to a contiguous tensor for the kernel. Returns
    ``(out, batch_mean, batch_var)``, the mean with the conv bias."""
    sh, sw = _pair(stride)
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    z, mean, var = cuda_kernels.conv1x1_bn_stats_train(x.contiguous(), w,
                                                       bias=bias)
    mean, var, _n = _global_moments(mean, var, z.numel() // mean.numel())
    return _fused_bn_epilogue(z, mean, var, gamma, beta, bias, eps,
                              fix_gamma)


def fused_convkxk_bn(x, w, bias, gamma, beta, pad=(1, 1), eps=1e-5,
                     fix_gamma=False):
    """Training-mode stride-1 KxK NHWC conv + batch norm with the batch
    statistics taken in the conv's own kernel (reference
    ``_fused_convkxk_bn``, ``ops/nn.py:493-513``), through
    :func:`cuda_kernels.convkxk_bn_stats_train`; the kernel size comes from
    w (OHWI). Bias as in :func:`fused_conv1x1_bn`. Returns ``(out,
    batch_mean, batch_var)``."""
    z, mean, var = cuda_kernels.convkxk_bn_stats_train(x, w, _pair(pad),
                                                       bias=bias)
    mean, var, _n = _global_moments(mean, var, z.numel() // mean.numel())
    return _fused_bn_epilogue(z, mean, var, gamma, beta, bias, eps,
                              fix_gamma)


@register("_fused_conv1x1_bn", num_inputs=-1, num_outputs=-1)
def _fused_conv1x1_bn_op(arrays, stride=(1, 1), eps=1e-5, fix_gamma=False,
                         has_bias=False):
    """``[x, w, (bias), gamma, beta]`` -> :func:`fused_conv1x1_bn`."""
    x, w = arrays[0], arrays[1]
    b = arrays[2] if has_bias else None
    gamma, beta = arrays[-2], arrays[-1]
    return fused_conv1x1_bn(x, w, b, gamma, beta, stride=tuple(stride),
                            eps=eps, fix_gamma=fix_gamma)


@register("_fused_convkxk_bn", num_inputs=-1, num_outputs=-1,
          aliases=("_fused_conv3x3_bn",))
def _fused_convkxk_bn_op(arrays, eps=1e-5, fix_gamma=False, has_bias=False,
                         pad=(1, 1)):
    """``[x, w, (bias), gamma, beta]`` -> :func:`fused_convkxk_bn`."""
    x, w = arrays[0], arrays[1]
    b = arrays[2] if has_bias else None
    gamma, beta = arrays[-2], arrays[-1]
    return fused_convkxk_bn(x, w, b, gamma, beta, pad=tuple(pad), eps=eps,
                            fix_gamma=fix_gamma)


@register("_fused_conv1x1_bn_act", num_inputs=-1, num_outputs=-1)
def _fused_conv1x1_bn_act_op(arrays, stride=(1, 1), eps=1e-5,
                             fix_gamma=False, has_bias=False,
                             has_residual=False, relu=True):
    """``[x, w, (bias), (residual), gamma, beta]`` ->
    :func:`fused_conv1x1_bn_act`."""
    x, w = arrays[0], arrays[1]
    i = 2
    b = r = None
    if has_bias:
        b = arrays[i]
        i += 1
    if has_residual:
        r = arrays[i]
        i += 1
    return fused_conv1x1_bn_act(x, w, b, r, arrays[i], arrays[i + 1],
                                stride=tuple(stride), eps=eps,
                                fix_gamma=fix_gamma, relu=relu)


def _affine(x, gamma, beta, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register("LayerNorm")
def layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5):
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    return _affine(out, gamma, beta, axis % data.dim())


get_op("LayerNorm").num_inputs = 3


@register("GroupNorm", num_inputs=-1)
def group_norm(arrays, num_groups=1, eps=1e-5):
    data, gamma, beta = arrays
    n, c = data.shape[0], data.shape[1]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    return _affine(x, gamma, beta, 1)


@register("InstanceNorm", num_inputs=-1)
def instance_norm(arrays, eps=1e-3):
    data, gamma, beta = arrays
    axes = tuple(range(2, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, unbiased=False)
    return _affine((data - mean) * torch.rsqrt(var + eps), gamma, beta, 1)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (axis 1)."""
    half = nsize // 2
    sq = F.pad(torch.square(data).movedim(1, -1), (half, half))
    windows = sum(sq[..., i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha / nsize * windows.movedim(-1, 1),
                            beta)


# -- dropout ----------------------------------------------------------------------

@register("Dropout", num_inputs=2, rng_input=True)
def dropout(data, key=None, p=0.5, mode="training", axes=None,
            training=False, cudnn_off=None):
    """Reference ``Dropout``: in training (or ``mode="always"``) keeps each
    element (or each slice along ``axes``) with probability 1 - p, scaled
    by 1 / (1 - p). The mask is drawn from the generator of data's device;
    the reference's ``key`` input is accepted and ignored."""
    if (not training and mode != "always") or p <= 0.0:
        return data
    shape = tuple(1 if axes and i in axes else s
                  for i, s in enumerate(data.shape))
    keep = 1.0 - p
    u = torch.rand(shape, generator=_rng.generator(data.device),
                   device=data.device)
    return data * ((u < keep).to(data.dtype) / keep)


# -- losses as ops ------------------------------------------------------------------

@register("softmax_cross_entropy", num_inputs=2)
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    onehot = (label.long().unsqueeze(-1) == torch.arange(
        data.shape[-1], device=data.device)).to(data.dtype)
    return -torch.sum(onehot * logp)


@register("SoftmaxOutput", num_inputs=2, aliases=["Softmax"])
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    return torch.softmax(data, dim=-1)


@register("MakeLoss", aliases=["make_loss"])
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return data


@register("CTCLoss", num_inputs=-1, aliases=["ctc_loss"])
def ctc_loss(arrays, use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss by the forward recursion in log space (reference
    ``ctc_loss.cc``): data (seq, batch, alphabet), label (batch, L)."""
    data, label = arrays[0], arrays[1]
    seq_len, batch, alphabet = data.shape
    blank = 0 if blank_label == "first" else alphabet - 1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.long()
    n_ext = 2 * lab.shape[1] + 1
    ext = torch.full((batch, n_ext), blank, dtype=torch.long,
                     device=data.device)
    ext[:, 1::2] = lab
    neg_inf = torch.full((), -1e30, dtype=logp.dtype, device=data.device)
    alpha = torch.full((batch, n_ext), -1e30, dtype=logp.dtype,
                       device=data.device)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       torch.gather(logp[0], 1, ext[:, 1:2]),
                       alpha[:, 2:]], dim=1)
    same = ext == torch.cat([torch.full((batch, 2), blank, dtype=torch.long,
                                        device=data.device), ext[:, :-2]], 1)
    for t in range(1, seq_len):
        emit = torch.gather(logp[t], 1, ext)
        shift1 = torch.cat([neg_inf.expand(batch, 1), alpha[:, :-1]], 1)
        shift2 = torch.cat([neg_inf.expand(batch, 2), alpha[:, :-2]], 1)
        cand = torch.logaddexp(alpha, shift1)
        cand = torch.where(same, cand, torch.logaddexp(cand, shift2))
        alpha = cand + emit
    return -torch.logaddexp(alpha[:, -1], alpha[:, -2])


# -- upsampling and moments -----------------------------------------------------------

@register("UpSampling", num_inputs=-1)
def upsampling(arrays, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=None):
    data = arrays[0]
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("moments", num_outputs=-1)
def moments(data, axes=None, keepdims=False):
    dims = tuple(axes) if axes else tuple(range(data.dim()))
    return (data.mean(dim=dims, keepdim=keepdims),
            data.var(dim=dims, keepdim=keepdims, unbiased=False))
