"""Neural-network operators on tensors.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` that the Gluon ResNet
path runs: ``convolution``, ``pooling``, ``batch_norm``,
``fully_connected``, ``activation``, ``log_softmax``/``pick`` (for the
loss), the fused ``fused_conv1x1_bn_act`` and the fused conv + batch-norm
statistics ops ``fused_conv1x1_bn`` and ``fused_convkxk_bn``. They are
plain functions on
``torch.Tensor``s, in the reference's conventions: ``layout="NHWC"``
tensors are (N, H, W, C) and their conv weights OHWI (O, kh, kw, I); the
default is NCHW with OIHW weights. NHWC convolutions and pools run through
torch's NCHW functions on ``channels_last`` views of the same memory, so
nothing is copied.

The reference's MXU channel-padding pass (``MXNET_PAD_CHANNELS``,
``ops/nn.py:184-224``) is a TPU tiling pass that changes no result; it is
not ported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import config as _config
from . import cuda_kernels

__all__ = ["activation", "fully_connected", "convolution", "pooling",
           "batch_norm", "log_softmax", "pick", "fused_conv1x1_bn_act",
           "fused_conv1x1_bn", "fused_convkxk_bn"]

def activation(data, act_type: str = "relu"):
    """Reference ``Activation`` (relu only so far)."""
    if act_type != "relu":
        raise NotImplementedError(f"activation {act_type!r} is not ported")
    return torch.relu(data)


def fully_connected(data, weight, bias=None, flatten: bool = True):
    """data (N, ...), weight (num_hidden, in_units): ``x @ wᵀ + b``."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(int(a) for a in v)


def _to_nchw(x, layout: str):
    """An NCHW view of x: NHWC tensors become channels_last views."""
    if layout == "NCHW":
        return x
    if layout == "NHWC":
        return x.permute(0, 3, 1, 2)
    raise NotImplementedError(f"layout {layout!r}: only 2-D NCHW and NHWC "
                              f"are ported")


def _from_nchw(y, layout: str):
    return y if layout == "NCHW" else y.permute(0, 2, 3, 1).contiguous()


def convolution(data, weight, bias=None, kernel: Sequence[int] = (1, 1),
                stride=(1, 1), dilate=(1, 1), pad=(0, 0), num_group: int = 1,
                layout: str = "NCHW"):
    """2-D convolution (reference ``Convolution``). NHWC data takes an OHWI
    weight; both are passed to ``F.conv2d`` as channels_last views."""
    if tuple(weight.shape[1:3] if layout == "NHWC" else weight.shape[2:]) \
            != _pair(kernel):
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"kernel {tuple(kernel)} in layout {layout}")
    x = _to_nchw(data, layout)
    w = weight if layout == "NCHW" else weight.permute(0, 3, 1, 2)
    out = F.conv2d(x, w, bias, stride=_pair(stride), padding=_pair(pad),
                   dilation=_pair(dilate), groups=num_group)
    return _from_nchw(out, layout)


def pooling(data, kernel=(1, 1), pool_type: str = "max",
            global_pool: bool = False, stride=None, pad=(0, 0),
            pooling_convention: str = "valid", layout: str = "NCHW"):
    """Reference ``Pooling``: max pooling (padding counts as -inf) and
    global average pooling (keeping the spatial dims as 1)."""
    if layout not in ("NCHW", "NHWC"):
        raise NotImplementedError(f"layout {layout!r} is not ported")
    if global_pool:
        if pool_type != "avg":
            raise NotImplementedError(f"global {pool_type} pooling")
        return data.mean(dim=(1, 2) if layout == "NHWC" else (2, 3),
                         keepdim=True)
    if pool_type != "max" or pooling_convention != "valid":
        raise NotImplementedError(f"{pool_type} pooling with convention "
                                  f"{pooling_convention!r} is not ported")
    stride = _pair(stride) if stride else (1, 1)
    out = F.max_pool2d(_to_nchw(data, layout), _pair(kernel), stride,
                       _pair(pad))
    return _from_nchw(out, layout)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=False):
    """Reference ``BatchNorm`` (``ops/nn.py:393-442``). Training: single-pass
    fp32 batch statistics ``E[x]`` and ``max(E[x²] - E[x]², 0)`` (two-pass
    under ``MXNET_BN_TWO_PASS_VAR``); the affine is folded into per-channel
    fp32 scale and shift, applied in data's dtype. Returns ``(out,)``, or
    ``(out, mean, var)`` in the running stats' dtype when training."""
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


def log_softmax(data, axis: int = -1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis: int = -1, keepdims: bool = False):
    """``data`` at ``index`` along ``axis`` (reference ``pick``, clipped
    indices)."""
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


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
    (reference ``ops/nn.py:445-461``), in plain torch: ``z · sc + bi`` in
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
    return _fused_bn_epilogue(z, mean, var, gamma, beta, bias, eps,
                              fix_gamma)
