"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``, whole).

Accumulation is two-tier, as in the reference:

- **device accumulators** (default, ``MXNET_METRIC_DEVICE=1``): when
  ``update()`` receives tensors or NDArrays and the metric has a device
  form (``_device_batch``), the batch's reduction runs as torch ops on the
  tensors' device and leaves a ``(sum, count)`` pair of fp32 scalars
  there, unread: no host synchronization per batch. The host reads the
  pairs at ``.get()``, at ``engine.waitall()`` (the metric registers as a
  drainable) or every ``MXNET_METRIC_SYNC_STEPS`` updates, all pending
  pairs in one read, and folds them in order into the host sums as the
  reference does (``float`` of each fp32 scalar, summed in Python).
- **host accumulation** for metrics without a device form (the
  confusion-matrix families, custom metrics), for numpy inputs, and under
  ``MXNET_METRIC_DEVICE=0`` or ``MXNET_ENGINE_TYPE=NaiveEngine``: every
  device-to-host read on this path is counted in :func:`host_sync_count`
  (counter ``metric.host_sync``), so a per-batch read in a train loop
  shows.

The device forms mirror the reference's ``jnp`` kernels step for step
(``argsort`` stable, fp32 sums and counts), and the host forms its numpy.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as onp
import torch

from . import telemetry as _telemetry
from .ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
    "BinaryAccuracy", "F1", "Fbeta", "MCC", "Perplexity", "MAE", "MSE",
    "RMSE", "CrossEntropy", "NegativeLogLikelihood", "PearsonCorrelation",
    "PCC", "Loss", "CustomMetric", "MeanCosineSimilarity",
    "MeanPairwiseDistance", "np", "create", "check_label_shapes",
    "host_sync_count", "reset_host_sync_count",
]

_HOST_SYNC = _telemetry.counter(
    "metric.host_sync",
    "blocking per-update device->host reads by metrics that bypassed "
    "the device accumulator path (no device form / disabled / "
    "NaiveEngine)")


def host_sync_count() -> int:
    """Blocking per-update device-to-host reads by metrics on the host
    path (a view over the ``metric.host_sync`` counter)."""
    return int(_HOST_SYNC.value)


def reset_host_sync_count() -> None:
    _HOST_SYNC.reset()


_REGISTRY: Dict[str, type] = {}


def _register(*names):
    def deco(cls):
        for n in names + (cls.__name__.lower(),):
            _REGISTRY[n.lower()] = cls
        return cls

    return deco


def create(metric, *args, **kwargs):
    """A metric by name, callable, instance or list (reference
    ``metric.create``)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        cls = _REGISTRY.get(metric.lower())
        if cls is None:
            raise ValueError(
                f"unknown metric '{metric}'; have {sorted(_REGISTRY)}")
        return cls(*args, **kwargs)
    raise TypeError(f"cannot create metric from {metric!r}")


def _is_array(x) -> bool:
    return isinstance(x, (NDArray, torch.Tensor))


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        lshape, pshape = len(labels), len(preds)
    else:
        lshape, pshape = labels.shape, preds.shape
    if lshape != pshape:
        raise ValueError(
            f"Shape of labels {lshape} does not match shape of "
            f"predictions {pshape}")
    if wrap:
        if _is_array(labels):
            labels = [labels]
        if _is_array(preds):
            preds = [preds]
    return labels, preds


def _host(x) -> onp.ndarray:
    """``x`` on the host; a tensor or NDArray read is counted (the loud
    fallback)."""
    if isinstance(x, NDArray):
        _HOST_SYNC.inc()
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        _HOST_SYNC.inc()
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return onp.asarray(x)


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """An fp32 scalar on ``like``'s device, made by a fill (a host
    constant copied to a CUDA device would synchronize)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


class EvalMetric:
    """Base metric (reference ``EvalMetric``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    # -- device-side accumulation ---------------------------------------
    def _device_batch(self, label, pred):
        """Per-batch device form: (label, pred) tensors -> ``(sum, count)``
        fp32 scalars on their device, mirroring the host ``update()``.
        ``None`` (the base default) marks a host-only metric."""
        return None

    def _device_ok(self) -> bool:
        if type(self)._device_batch is EvalMetric._device_batch:
            return False
        from . import config as _config
        from . import engine as _engine

        return (not _engine.is_naive()
                and bool(_config.get("MXNET_METRIC_DEVICE")))

    def _try_device_update(self, labels, preds) -> bool:
        """Add this batch's ``(sum, count)`` on the device, unread. False
        sends the caller to the host path (counted)."""
        if not self._device_ok():
            return False
        try:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        except ValueError:
            return False          # the host path raises the documented error
        pairs = []
        for label, pred in zip(labels, preds):
            if not (_is_array(label) and _is_array(pred)):
                return False
            pairs.append((_tensor(label).detach(), _tensor(pred).detach()))
        try:
            # every pair computed before the accumulator is touched, so a
            # failure leaves the state clean for the host path
            with torch.no_grad():
                batch = [self._device_batch(l, p) for l, p in pairs]
        except Exception:
            return False
        self._dev_pairs.extend(batch)
        self._dev_pending += 1
        from . import config as _config
        from . import engine as _engine

        _engine.register_drainable(self)
        if self._dev_pending >= _config.get("MXNET_METRIC_SYNC_STEPS"):
            self._fold_device()
        return True

    def _fold_device(self) -> None:
        """The host read: the pending device scalars, all in one read,
        folded in order into the host sums. Happens at ``.get()``,
        ``engine.waitall()`` or every ``MXNET_METRIC_SYNC_STEPS``
        updates, never per batch."""
        pairs = getattr(self, "_dev_pairs", None)
        if not pairs:
            return
        self._dev_pairs = []
        self._dev_pending = 0
        by_device: Dict[torch.device, list] = {}
        for i, (s, n) in enumerate(pairs):
            by_device.setdefault(s.device, []).append(i)
        values = [None] * len(pairs)
        for idx in by_device.values():
            flat = torch.stack([torch.stack([pairs[i][0].float(),
                                             pairs[i][1].float()])
                                for i in idx]).cpu().tolist()
            for i, v in zip(idx, flat):
                values[i] = v
        for s, n in values:
            self.sum_metric += float(s)
            self.num_inst += int(round(float(n)))

    def drain(self) -> None:
        """``engine.waitall()`` hook: land the outstanding device
        accumulation."""
        self._fold_device()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label: dict, pred: dict):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        # a cleared metric must not fold a previous epoch's batches
        self._dev_pairs = []
        self._dev_pending = 0

    def get(self):
        self._fold_device()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """Several metrics as one (reference ``CompositeEvalMetric``)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


@_register("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=-1, name="accuracy", **kwargs):
        super().__init__(name, axis=axis, **kwargs)
        self.axis = axis

    def _device_batch(self, label, pred):
        if pred.dim() > label.dim():
            pred = pred.argmax(dim=self.axis)
        if pred.shape != label.shape:      # the host path raises it
            raise ValueError("shape mismatch")
        pred = pred.to(torch.int32).reshape(-1)
        label = label.to(torch.int32).reshape(-1)
        return ((pred == label).sum().float(), _f32(label.shape[0], label))

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _host(pred)
            label = _host(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).flatten()
            label = label.astype(onp.int64).flatten()
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@_register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", top_k=top_k, **kwargs)
        self.top_k = top_k
        assert top_k > 1, "use Accuracy for top_k=1"

    def _device_batch(self, label, pred):
        topk = torch.argsort(pred, dim=-1, stable=True)[..., -self.top_k:]
        label = label.to(torch.int64)
        if topk.shape[:-1] != label.shape:
            raise ValueError("shape mismatch")
        hits = (topk == label[..., None]).sum().float()
        return hits, _f32(label.numel(), label)

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _host(pred)
            label = _host(label).astype(onp.int64)
            topk = onp.argsort(pred, axis=-1)[..., -self.top_k:]
            for j in range(self.top_k):
                self.sum_metric += float(
                    (topk[..., j].flatten() == label.flatten()).sum())
            self.num_inst += label.size


@_register("binary_accuracy")
class BinaryAccuracy(EvalMetric):
    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, threshold=threshold, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = (_host(pred).flatten() > self.threshold).astype(onp.int64)
            label = _host(label).flatten().astype(onp.int64)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


class _BinaryStats:
    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred, threshold=0.5):
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred_label = pred.argmax(-1).flatten()
        else:
            pred_label = (pred.flatten() > threshold).astype(onp.int64)
        label = label.flatten().astype(onp.int64)
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def fbeta(self, beta):
        p, r = self.precision, self.recall
        if p + r == 0:
            return 0.0
        b2 = beta * beta
        return (1 + b2) * p * r / (b2 * p + r)

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn

    def matthewscc(self):
        terms = [(self.tp + self.fp), (self.tp + self.fn),
                 (self.tn + self.fp), (self.tn + self.fn)]
        denom = 1.0
        for t in terms:
            denom *= t if t else 1.0
        return (self.tp * self.tn - self.fp * self.fn) / math.sqrt(denom)


@_register("fbeta")
class Fbeta(EvalMetric):
    def __init__(self, name="fbeta", beta=1, average="macro", threshold=0.5,
                 **kwargs):
        super().__init__(name, **kwargs)
        self.beta = beta
        self.average = average
        self.threshold = threshold
        self._stats = _BinaryStats()

    def reset(self):
        super().reset()
        if hasattr(self, "_stats"):
            self._stats.reset()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self._stats.update(_host(label), _host(pred), self.threshold)

    def get(self):
        if self._stats.total == 0:
            return self.name, float("nan")
        return self.name, self._stats.fbeta(self.beta)


@_register("f1")
class F1(Fbeta):
    def __init__(self, name="f1", average="macro", threshold=0.5, **kwargs):
        super().__init__(name=name, beta=1, average=average,
                         threshold=threshold, **kwargs)


@_register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._stats = _BinaryStats()

    def reset(self):
        super().reset()
        if hasattr(self, "_stats"):
            self._stats.reset()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self._stats.update(_host(label), _host(pred))

    def get(self):
        if self._stats.total == 0:
            return self.name, float("nan")
        return self.name, self._stats.matthewscc()


def _picked(label, pred):
    """(int labels flattened, each row's probability of its label)."""
    label = label.to(torch.int64).reshape(-1)
    pred = pred.reshape(-1, pred.shape[-1])
    if pred.shape[0] != label.shape[0]:
        raise ValueError("shape mismatch")
    return label, pred[torch.arange(label.shape[0], device=label.device),
                       label]


@_register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, ignore_label=ignore_label, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def _device_batch(self, label, pred):
        label, probs = _picked(label, pred)
        nll = -torch.log(torch.clamp(probs, min=1e-10))
        if self.ignore_label is not None:
            mask = (label != self.ignore_label).float()
            return (nll * mask).sum().float(), mask.sum()
        return nll.sum().float(), _f32(label.shape[0], label)

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _host(label).astype(onp.int64).flatten()
            pred = _host(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[onp.arange(len(label)), label]
            if self.ignore_label is not None:
                mask = label != self.ignore_label
                probs = probs[mask]
            self.sum_metric += float(-onp.log(onp.maximum(probs, 1e-10)).sum())
            self.num_inst += len(probs)

    def get(self):
        self._fold_device()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


def _align_regression(label, pred):
    """A label one rank lower than the prediction gains a trailing axis
    (and the other way round), as the reference's MAE/MSE reshape it."""
    if label.ndim == pred.ndim - 1:
        label = label[..., None]
    elif pred.ndim == label.ndim - 1:
        pred = pred[..., None]
    return label, pred


@_register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def _device_batch(self, label, pred):
        label, pred = _align_regression(label, pred)
        return ((label - pred).abs().mean().float() * label.shape[0],
                _f32(label.shape[0], label))

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label, pred = _align_regression(_host(label), _host(pred))
            self.sum_metric += float(
                onp.abs(label - pred).mean()) * label.shape[0]
            self.num_inst += label.shape[0]


@_register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def _device_batch(self, label, pred):
        label, pred = _align_regression(label, pred)
        return (((label - pred) ** 2).mean().float() * label.shape[0],
                _f32(label.shape[0], label))

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label, pred = _align_regression(_host(label), _host(pred))
            self.sum_metric += float(
                ((label - pred) ** 2).mean()) * label.shape[0]
            self.num_inst += label.shape[0]


@_register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        self._fold_device()
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@_register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, ignore_label=None, axis=-1,
                 name="cross-entropy", **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps
        self.ignore_label = ignore_label

    def _device_batch(self, label, pred):
        label, probs = _picked(label, pred)
        nll = -torch.log(probs + self.eps)
        if self.ignore_label is not None:
            mask = (label != self.ignore_label).float()
            return (nll * mask).sum().float(), mask.sum()
        return nll.sum().float(), _f32(label.shape[0], label)

    def update(self, labels, preds):
        if self._try_device_update(labels, preds):
            return
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _host(label).astype(onp.int64).flatten()
            pred = _host(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[onp.arange(len(label)), label]
            if self.ignore_label is not None:
                mask = label != self.ignore_label
                probs = probs[mask]
            self.sum_metric += float(-onp.log(probs + self.eps).sum())
            self.num_inst += len(probs)


@_register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@_register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._x: List[onp.ndarray] = []
        self._y: List[onp.ndarray] = []

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            lab = _host(label)
            self._x.append(lab.flatten())
            self._y.append(_host(pred).flatten())
            self.num_inst += lab.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        x = onp.concatenate(self._x)
        y = onp.concatenate(self._y)
        return self.name, float(onp.corrcoef(x, y)[0, 1])


@_register("pcc")
class PCC(EvalMetric):
    """Multiclass Pearson correlation through a confusion matrix
    (reference ``PCC``)."""

    def __init__(self, name="pcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._cm = onp.zeros((0, 0), onp.float64)

    def _grow(self, n):
        if n > self._cm.shape[0]:
            cm = onp.zeros((n, n), onp.float64)
            cm[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _host(label).astype(onp.int64).flatten()
            pred = _host(pred)
            if pred.ndim > 1:
                pred = pred.argmax(-1)
            pred = pred.astype(onp.int64).flatten()
            n = int(max(label.max(), pred.max())) + 1
            self._grow(n)
            for lt, pt in zip(label, pred):
                self._cm[pt, lt] += 1
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        c = self._cm
        n = c.sum()
        x = c.sum(axis=1)  # predicted counts
        y = c.sum(axis=0)  # true counts
        cov_xy = (c.trace() * n - x @ y)
        cov_xx = (n * n - x @ x)
        cov_yy = (n * n - y @ y)
        denom = math.sqrt(cov_xx * cov_yy)
        return self.name, float(cov_xy / denom) if denom else 0.0


@_register("loss")
class Loss(EvalMetric):
    """Running mean of a loss output (reference ``Loss``)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def _device_batch(self, label, pred):
        return pred.sum().float(), _f32(pred.numel(), pred)

    def update(self, _, preds):
        if _is_array(preds):
            preds = [preds]
        # label-free: the device path pairs each pred with itself
        if isinstance(preds, (list, tuple)) and \
                self._try_device_update(list(preds), list(preds)):
            return
        for pred in preds:
            loss = _host(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


@_register("cos_sim")
class MeanCosineSimilarity(EvalMetric):
    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label, pred = _host(label), _host(pred)
            num = (label * pred).sum(-1)
            den = onp.linalg.norm(label, axis=-1) * \
                onp.linalg.norm(pred, axis=-1)
            sim = num / onp.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@_register("pdist")
class MeanPairwiseDistance(EvalMetric):
    def __init__(self, name="pdist", p=2, **kwargs):
        super().__init__(name, p=p, **kwargs)
        self.p = p

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label, pred = _host(label), _host(pred)
            d = onp.linalg.norm((label - pred).reshape(label.shape[0], -1),
                                ord=self.p, axis=-1)
            self.sum_metric += float(d.sum())
            self.num_inst += d.size


class CustomMetric(EvalMetric):
    """``feval(label, pred) -> float`` or ``(sum, count)`` on host arrays
    (reference ``CustomMetric``)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False, **kwargs):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            v = self._feval(_host(label), _host(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A numpy ``feval`` as a metric (reference ``metric.np``)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
