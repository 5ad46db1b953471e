"""Tensor manipulation operators (counterpart of
``mxnet_tpu/ops/tensor.py``): shapes, joins and splits, slicing and
indexing, gathers and scatters, sorting. Index outputs keep the
reference's dtypes (``topk``/``argsort`` float32 by default,
``shape_array``/``size_array`` int64). The reference's int32
factorizations of gathers past 2^31 (``_concrete_big``) are JAX s64
workarounds and are not ported: torch indexes in int64.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from .registry import register
from ..base import op_dtype


def _ax(axis, ndim):
    return axis % ndim if ndim else axis


@register("reshape", aliases=["Reshape"])
def reshape(data, shape=None, reverse=False):
    """Reshape with MXNet's special codes 0 (copy a dim), -1 (infer), -2
    (copy the rest), -3 (merge two), -4 (split one)."""
    shape = tuple(shape)
    if 0 in shape or -2 in shape or -3 in shape or -4 in shape:
        shape = _expand_reshape_codes(tuple(data.shape), shape)
    return torch.reshape(data, shape)


@register("npx_reshape", aliases=["_npx_reshape"])
def npx_reshape(data, newshape=None, reverse=False, order="C"):
    """``npx.reshape``'s codes: -1 infer, -2 copy a dim, -3 drop a size-1
    dim, -4 copy the rest, -5 merge two, -6 split one into the two factors
    that follow."""
    src = tuple(data.shape)
    shape = list(newshape if isinstance(newshape, (list, tuple))
                 else [newshape])
    if reverse:
        out_rev = _expand_npx_codes(src[::-1], _reverse_npx_spec(shape),
                                    mirror_splits=True)
        return torch.reshape(data, tuple(out_rev)[::-1])
    return torch.reshape(data, tuple(_expand_npx_codes(src, shape)))


def _expand_npx_codes(src, shape, mirror_splits=False):
    out = []
    i = j = 0
    while j < len(shape):
        s = shape[j]
        if s == -2:
            out.append(src[i])
            i += 1
        elif s == -3:
            if src[i] != 1:
                raise ValueError(
                    f"npx.reshape -3 requires a size-1 dim, got {src[i]}")
            i += 1
        elif s == -4:
            out.extend(src[i:])
            i = len(src)
        elif s == -5:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -6:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            if d1 * d2 != src[i]:
                raise ValueError(f"npx.reshape -6: {d1}x{d2} != {src[i]}")
            out.extend([d2, d1] if mirror_splits else [d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return out


def _reverse_npx_spec(shape):
    groups = []
    j = 0
    while j < len(shape):
        if shape[j] == -6:
            groups.append(shape[j:j + 3])
            j += 3
        else:
            groups.append([shape[j]])
            j += 1
    return [v for g in reversed(groups) for v in g]


def _expand_reshape_codes(src, shape):
    out = []
    i = j = 0
    shape = list(shape)
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


@register("transpose")
def transpose(data, axes=None):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=["SwapAxis"])
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


@register("flatten", aliases=["Flatten"])
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("expand_dims")
def expand_dims(data, axis=0):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    out = data
    nd = data.dim() + len(axes)
    for a in sorted(x % nd for x in axes):
        out = out.unsqueeze(a)
    return out


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if data.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size "
                             f"{data.shape[a]}")
    return torch.squeeze(data, tuple(axes))


@register("broadcast_to")
def broadcast_to(data, shape=None):
    shape = tuple(shape)
    if 0 in shape:          # 0 keeps the matching input dim, right-aligned
        offset = len(shape) - data.dim()
        shape = tuple(s if s != 0 else data.shape[i - offset]
                      for i, s in enumerate(shape))
    return torch.broadcast_to(data, shape)


@register("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, axis=None, size=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return torch.broadcast_to(data, tuple(shape))


@register("tile")
def tile(data, reps=None):
    return torch.tile(data, tuple(reps) if not isinstance(reps, int)
                      else (reps,))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("pad", aliases=["Pad"])
def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    pw = list(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    while pairs and pairs[0] == (0, 0) and mode != "constant":
        pairs.pop(0)
    flat = [v for p in reversed(pairs) for v in p]
    if mode == "constant":
        return F.pad(data, flat, value=constant_value)
    tmode = {"edge": "replicate", "reflect": "reflect"}[mode]
    lead = data.dim() - len(pairs)
    x = data.reshape((1,) * max(0, 2 - lead)
                     + tuple(data.shape)) if lead < 2 else data
    out = F.pad(x, flat, mode=tmode)
    return out.reshape(out.shape[max(0, 2 - lead):]) if lead < 2 else out


@register("concat", num_inputs=-1, aliases=["Concat"])
def concat(arrays, dim=1):
    return torch.cat(list(arrays), dim=dim)


@register("stack", num_inputs=-1)
def stack(arrays, axis=0):
    return torch.stack(list(arrays), dim=axis)


@register("split", num_outputs=-1, aliases=["SliceChannel"])
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError(f"cannot split axis of size {n} into "
                         f"{num_outputs} equal parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _slice_dim(x, dim, begin, end, step):
    n = x.shape[dim]
    idx = range(*slice(begin, end, step).indices(n))
    if idx.step > 0:
        return x.narrow(dim, idx.start, max(0, len(idx)))[
            (slice(None),) * dim + (slice(None, None, idx.step),)] \
            if idx.step > 1 else x.narrow(dim, idx.start, len(idx))
    sel = torch.as_tensor(list(idx), dtype=torch.long, device=x.device)
    return x.index_select(dim, sel)


@register("slice", aliases=["crop"])
def slice_op(data, begin=None, end=None, step=None):
    ndim = data.dim()
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = list(step or []) + [None] * (ndim - len(step or []))
    out = data
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        if (b, e, s) != (None, None, None):
            out = _slice_dim(out, d, b, e, s)
    return out


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    return _slice_dim(data, _ax(axis, data.dim()), begin, end, None)


@register("slice_like", num_inputs=2)
def slice_like(data, shape_like, axes=None):
    tgt = shape_like.shape
    out = data
    for a in (axes if axes else range(data.dim())):
        out = out.narrow(a, 0, tgt[a])
    return out


@register("take", num_inputs=2)
def take(a, indices, axis=0, mode="clip"):
    axis = _ax(axis, a.dim())
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick", num_inputs=2)
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    axis = _ax(axis, data.dim())
    n = data.shape[axis]
    idx = index.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("gather_nd", num_inputs=2)
def gather_nd(data, indices):
    idx = indices.long()
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", num_inputs=2, differentiable=True)
def scatter_nd(data, indices, shape=None):
    idx = indices.long()
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


@register("one_hot", differentiable=False)
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = op_dtype(dtype)
    classes = torch.arange(depth, device=indices.device)
    eye = (indices.long().unsqueeze(-1) == classes).to(dt)
    return eye * on_value + (1.0 - eye) * off_value


@register("cast", aliases=["Cast"])
def cast(data, dtype=None):
    return data.to(op_dtype(dtype))


@register("_copy", aliases=["identity", "stop_gradient_copy"])
def _copy(data):
    return data.clone()


@register("BlockGrad", aliases=["stop_gradient"], differentiable=False)
def block_grad(data):
    return data.detach()


@register("where", num_inputs=3)
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


def index_key(key, device):
    """An index key torch takes: integer tensors and arrays as int64 on the
    data's device, lists of ints as such tensors."""
    def one(k):
        if isinstance(k, onp.ndarray):
            k = torch.as_tensor(k)
        elif isinstance(k, list) and k and all(
                isinstance(v, (int, onp.integer)) and not isinstance(v, bool)
                for v in k):
            k = torch.as_tensor(k)
        if isinstance(k, torch.Tensor):
            if k.dtype != torch.bool and not k.is_floating_point():
                k = k.long()
            return k.to(device)
        if isinstance(k, onp.integer):
            return int(k)
        return k

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


def _positive_steps(key, shape):
    """(key with each negative-step slice made the positive slice of the
    same elements, the output dims to flip back), for basic keys; None
    where no slice steps backwards."""
    keys = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in keys):
        return None
    if any(not isinstance(k, (int, onp.integer, slice)) and k is not None
           and k is not Ellipsis for k in keys):
        raise NotImplementedError("a negative-step slice beside an array "
                                  "index is not supported")
    ndim = len(shape)
    n_in = sum(1 for k in keys if k is not None and k is not Ellipsis)
    out, flips, dim_in, dim_out = [], [], 0, 0
    for k in keys:
        if k is Ellipsis:
            skip = ndim - n_in
            dim_in += skip
            dim_out += skip
            out.append(k)
        elif k is None:
            dim_out += 1
            out.append(k)
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                idx = range(*k.indices(shape[dim_in]))
                k = slice(idx[-1], idx[0] + 1, -k.step) if len(idx) \
                    else slice(0, 0)
                flips.append(dim_out)
            out.append(k)
            dim_in += 1
            dim_out += 1
        else:
            out.append(k)
            dim_in += 1
    return tuple(out), flips


def set_index(data, key, value):
    """``data`` with ``data[key] = value`` written into a copy (the
    reference's ``.at[key].set``); negative-step slices write the value
    in their own order."""
    new = data.clone()
    pos = _positive_steps(key, tuple(data.shape))
    if pos is None:
        new[index_key(key, data.device)] = value
        return new
    key, flips = pos
    key = index_key(key, data.device)
    region = new[key]
    new[key] = torch.flip(torch.broadcast_to(value, region.shape), flips) \
        if flips else value
    return new


@register("_index", differentiable=True)
def _index(data, key=None):
    pos = _positive_steps(key, tuple(data.shape))
    if pos is None:
        return data[index_key(key, data.device)]
    key, flips = pos
    out = data[index_key(key, data.device)]
    return torch.flip(out, flips) if flips else out


@register("reverse", aliases=["flip"])
def reverse(data, axis=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


@register("roll")
def roll(data, shift=None, axis=None):
    return torch.roll(data, shift, axis)


@register("diag")
def diag(data, k=0):
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, k, 0, 1)


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def _steps_mask(data, sequence_length, axis):
    seq_len = data.shape[axis]
    steps = torch.arange(seq_len, device=data.device)
    lens = sequence_length.long()
    if axis == 0:
        mask = steps[:, None] < lens[None, :]
    else:
        mask = steps[None, :] < lens[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("sequence_mask", num_inputs=2, aliases=["SequenceMask"])
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    mask = _steps_mask(data, sequence_length, axis)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("sequence_last", num_inputs=2, aliases=["SequenceLast"])
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    last = sequence_length.long() - 1
    if axis == 0:
        idx = last.reshape((1, -1) + (1,) * (data.dim() - 2))
        idx = idx.expand((1,) + tuple(data.shape[1:]))
        return torch.gather(data, 0, idx).squeeze(0)
    idx = last.reshape((-1, 1) + (1,) * (data.dim() - 2))
    idx = idx.expand((data.shape[0], 1) + tuple(data.shape[2:]))
    return torch.gather(data, 1, idx).squeeze(1)


@register("sequence_reverse", num_inputs=2, aliases=["SequenceReverse"])
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    steps = torch.arange(data.shape[0], device=data.device)
    lens = sequence_length.long()
    rev = torch.where(steps[:, None] < lens[None, :],
                      lens[None, :] - 1 - steps[:, None], steps[:, None])
    rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


@register("shape_array", differentiable=False)
def shape_array(data):
    """int64, as the reference's (``shape_array``)."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", differentiable=False)
def size_array(data):
    """int64, as the reference's (see ``shape_array``)."""
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("add_n", num_inputs=-1, aliases=["ElementWiseSum"])
def add_n(arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("dot", num_inputs=2)
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of lhs against the first of rhs."""
    a = lhs.t() if transpose_a and lhs.dim() == 2 else lhs
    b = rhs.t() if transpose_b and rhs.dim() == 2 else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot", num_inputs=2)
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("embedding", num_inputs=2, aliases=["Embedding"])
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    return weight[data.long()]


@register("topk", differentiable=False, num_outputs=-1)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    axis = _ax(axis, data.dim())
    neg = -data if is_ascend else data
    vals, idx = torch.topk(neg.movedim(axis, -1), k, dim=-1, sorted=True)
    vals, idx = vals.movedim(-1, axis), idx.movedim(-1, axis)
    if is_ascend:
        vals = -vals
    dt = op_dtype(dtype)
    if ret_typ == "indices":
        return idx.to(dt)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(dt)
    if ret_typ == "mask":
        last = torch.zeros_like(data.movedim(axis, -1))
        last = last.scatter(-1, idx.movedim(axis, -1), 1.0)
        return last.movedim(-1, axis)
    raise ValueError(f"unknown ret_typ {ret_typ}")


@register("sort", differentiable=False)
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(op_dtype(dtype))


@register("unique", differentiable=False, num_outputs=-1)
def unique(data):
    return torch.unique(data.reshape(-1), sorted=True)
