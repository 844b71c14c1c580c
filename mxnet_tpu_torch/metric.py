"""Evaluation metrics of the PyTorch port (reference:
python/mxnet/metric.py; the counterpart of ``mxnet_tpu.metric``):
``EvalMetric`` and its registry, Accuracy, TopKAccuracy, F1, MAE, MSE,
RMSE, CrossEntropy, Perplexity, Loss, PearsonCorrelation,
CompositeEvalMetric and CustomMetric, ``create`` and ``np_metric``.

As in the reference, ``update`` reads its arrays to the host (one copy
each) and keeps ``sum_metric`` and ``num_inst`` as Python numbers.
"""
from __future__ import annotations

import math

import numpy as np

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Perplexity", "Loss", "PearsonCorrelation",
           "CompositeEvalMetric", "CustomMetric", "create", "np_metric",
           "register"]

# lower-cased class name -> metric class
_REG = {}


def register(klass):
    """Register a metric class under its lower-cased name (``create``)."""
    _REG[klass.__name__.lower()] = klass
    return klass


def _to_numpy(x):
    from .ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class EvalMetric:
    """Base metric with the reference's update/get/reset contract."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int32).ravel()
            label = label.astype(np.int32).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int32)
            topk = np.argsort(-pred, axis=-1)[..., :self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


@register
class F1(EvalMetric):
    """Binary F1 (reference: metric.py F1; average='macro' over resets)."""

    def __init__(self, name="f1", average="macro", **kwargs):
        self.average = average
        super().__init__(name, **kwargs)

    def reset(self):
        self.tp = self.fp = self.fn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int32).ravel()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = np.argmax(pred, axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype(np.int32)
            pred = pred.astype(np.int32).ravel()
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (self.name, f1)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_numpy(label), _to_numpy(pred)
            self.sum_metric += float(
                np.abs(label - pred.reshape(label.shape)).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_numpy(label), _to_numpy(pred)
            self.sum_metric += float(
                ((label - pred.reshape(label.shape)) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(np.int32).ravel()
            pred = _to_numpy(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += float(-np.log(prob + self.eps).sum())
            self.num_inst += label.shape[0]


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).astype(np.int32).ravel()
            pred = _to_numpy(pred).reshape(-1, _to_numpy(pred).shape[-1])
            prob = pred[np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                mask = label != self.ignore_label
                prob = prob[mask]
            self.sum_metric += float(-np.log(prob + self.eps).sum())
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class Loss(EvalMetric):
    """Mean of raw loss outputs (reference: metric.py Loss)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            pred = _to_numpy(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_numpy(label).ravel(), _to_numpy(pred).ravel()
            if label.std() > 0 and pred.std() > 0:
                self.sum_metric += float(np.corrcoef(label, pred)[0, 1])
            self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_as_list(n))
            values.extend(_as_list(v))
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            val = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """Decorator creating a CustomMetric from a numpy function
    (reference: mx.metric.np)."""
    def factory():
        return CustomMetric(numpy_feval, name or numpy_feval.__name__,
                            allow_extra_outputs)
    return factory


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m))
        return composite
    if isinstance(metric, str):
        klass = _REG.get(metric.lower().replace("-", ""))
        if klass is None:
            aliases = {"acc": Accuracy, "ce": CrossEntropy,
                       "top_k_accuracy": TopKAccuracy,
                       "top_k_acc": TopKAccuracy}
            klass = aliases.get(metric.lower())
        if klass is None:
            raise MXNetError(f"unknown metric {metric!r}")
        return klass(*args, **kwargs)
    raise MXNetError(f"cannot create metric from {metric!r}")
