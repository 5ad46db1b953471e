"""Carry parameter dicts between the JAX package and the port.

The JAX package has no counterpart: this is the bridge that lets the port be
held against ``mxnet_tpu`` on the same weights. It takes plain numpy arrays
(``{k: np.asarray(v)}`` of ``mxnet_tpu.models.init_params(...)``), so the
port itself never imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .context import resolve_device
from .models.transformer_lm import TransformerLMConfig, param_shapes

__all__ = ["params_from_numpy", "tensor_from_numpy",
           "gluon_params_from_numpy", "decode_params_from_numpy"]

_DECODE_TOP = ("emb", "pos", "out")
_DECODE_LAYER = ("wq", "wk", "wv", "wo", "w1", "w2")


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values and dtype. numpy arrays of the
    ``bfloat16`` extension dtype (what JAX hands out) become
    ``torch.bfloat16`` bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def params_from_numpy(np_params: Mapping[str, np.ndarray],
                      cfg: TransformerLMConfig, device=None
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat LM param dict (as numpy) -> the port's, on
    ``device`` (``cuda`` if None), keeping each array's dtype. Raises if a
    name is missing or extra or a shape differs from ``cfg``'s."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(np_params))
    extra = sorted(set(np_params) - set(want))
    if missing or extra:
        raise KeyError(f"param names differ from the config's: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    out = {}
    for name, (shape, _dtype) in want.items():
        t = tensor_from_numpy(np_params[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, config wants "
                             f"{shape}")
        out[name] = t.to(dev)
    return out


def gluon_params_from_numpy(net, np_params: Mapping[str, np.ndarray]) -> None:
    """Load the JAX net's ``collect_params()`` values, given as numpy
    (``{name: p.data().asnumpy()}``), into the port's net by structural
    name, each cast to the parameter's dtype on its device. The port's
    parameters must have their shapes (given, or inferred by a first
    call). Raises on a missing or extra name or a wrong shape."""
    params = net.collect_params()
    missing = sorted(set(params) - set(np_params))
    extra = sorted(set(np_params) - set(params))
    if missing or extra:
        raise KeyError(f"param names differ from the net's: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        t = tensor_from_numpy(np_params[name])
        if p.shape is None or tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the net "
                             f"wants {p.shape}")
        p.set_data(t)


def decode_params_from_numpy(np_params: Mapping, device=None) -> Dict:
    """The JAX package's decode-parameter pytree (``serving_decode``'s
    ``TinyCausalLM.init_params``, leaves given as numpy: ``emb``, ``pos``,
    ``out`` and ``layers[i]`` with ``wq``, ``wk``, ``wv``, ``wo``, ``w1``,
    ``w2``) -> the port's dict of the same structure on ``device``
    (``cuda`` if None), each leaf keeping its dtype. Raises on a missing or
    extra name."""
    dev = resolve_device(device)

    def take(tree, names, where):
        missing = sorted(set(names) - set(tree))
        extra = sorted(set(tree) - set(names))
        if missing or extra:
            raise KeyError(f"{where}: missing {missing}, unexpected {extra}")
        return {k: tensor_from_numpy(tree[k]).to(dev) for k in names}

    top = {k: v for k, v in np_params.items() if k != "layers"}
    out = take(top, _DECODE_TOP, "decode params")
    out["layers"] = [take(lp, _DECODE_LAYER, f"layer {i}")
                     for i, lp in enumerate(np_params["layers"])]
    return out
