"""Validation metrics.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/metrics.py``
(parity surface ``zoo/.../pipeline/api/keras/metrics/`` and
``KerasUtils.toBigDLMetrics``). Metrics are streaming: each batch gives a
``(numerator, denominator)`` pair of device tensors, the engine sums them
on the device and fetches them once, and :meth:`Metric.finalize` reduces
the host arrays.
"""

from __future__ import annotations

import numpy as np
import torch


class Metric:
    name = "metric"

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        """(numerator, denominator) partial sums for one batch, each of a
        shape that does not depend on the batch's content."""
        raise NotImplementedError

    def finalize(self, num, den):
        """Reduce the partials summed over every batch (host arrays)."""
        return float(np.asarray(num / np.maximum(den, 1e-12)))

    def __repr__(self):
        return self.name


def _weights(y_pred, sample_weight):
    if sample_weight is None:
        return torch.ones(y_pred.shape[0], dtype=torch.float32,
                          device=y_pred.device)
    return sample_weight.float()


def _labels_of(y_true, y_pred, zero_based_label=True):
    if y_true.dim() == y_pred.dim() and y_true.shape[-1] == y_pred.shape[-1] \
            and y_pred.shape[-1] > 1:
        return torch.argmax(y_true, dim=-1)  # one-hot targets
    labels = y_true.long()
    if labels.dim() == y_pred.dim():
        labels = labels.reshape(labels.shape[:-1])
    if not zero_based_label:
        labels = labels - 1
    return labels


def _mean_to_rows(correct):
    while correct.dim() > 1:
        correct = correct.mean(dim=-1)
    return correct


class Accuracy(Metric):
    """Top-1 accuracy; binary (one sigmoid output) or categorical."""

    name = "accuracy"

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        if y_pred.dim() == 1 or y_pred.shape[-1] == 1:
            pred = (y_pred.reshape(y_pred.shape[0]) > 0.5).long()
            labels = y_true.reshape(y_true.shape[0]).long()
        else:
            pred = torch.argmax(y_pred, dim=-1)
            labels = _labels_of(y_true, y_pred, self.zero_based_label)
            if pred.dim() > 1:  # sequence outputs: per-token accuracy
                w = w.reshape((-1,) + (1,) * (pred.dim() - 1)) \
                    .expand(pred.shape)
        correct = (pred == labels).float()
        return (correct * w).sum(), (w * torch.ones_like(correct)).sum()


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class BinaryAccuracy(Metric):
    name = "binary_accuracy"

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        pred = (y_pred.reshape(y_pred.shape[0], -1) > 0.5).float()
        labels = y_true.reshape(y_true.shape[0], -1).float()
        correct = (pred == labels).all(dim=-1).float()
        return (correct * w).sum(), w.sum()


class CategoricalAccuracy(Metric):
    name = "categorical_accuracy"

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        correct = _mean_to_rows((torch.argmax(y_pred, dim=-1) ==
                                 torch.argmax(y_true, dim=-1)).float())
        return (correct * w).sum(), w.sum()


class Top5Accuracy(Metric):
    name = "top5accuracy"

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        labels = _labels_of(y_true, y_pred, self.zero_based_label)
        k = min(5, y_pred.shape[-1])
        topk = torch.topk(y_pred, k, dim=-1).indices
        correct = _mean_to_rows(
            (topk == labels[..., None]).any(dim=-1).float())
        return (correct * w).sum(), w.sum()


class MAE(Metric):
    name = "mae"

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        err = torch.abs(y_pred - y_true).reshape(y_pred.shape[0], -1) \
            .mean(dim=-1)
        return (err * w).sum(), w.sum()


class MSE(Metric):
    name = "mse"

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        err = torch.square(y_pred - y_true).reshape(y_pred.shape[0], -1) \
            .mean(dim=-1)
        return (err * w).sum(), w.sum()


class AUC(Metric):
    """Streaming AUC over fixed thresholds; num/den are true- and
    false-positive counts per threshold and the class totals."""

    name = "auc"

    def __init__(self, threshold_num: int = 200):
        self.threshold_num = threshold_num

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        scores = y_pred.reshape(y_pred.shape[0], -1)[:, -1]
        labels = y_true.reshape(y_true.shape[0], -1)[:, -1]
        if y_pred.dim() > 1 and y_pred.shape[-1] == 2:
            scores = y_pred[:, 1]
        thresholds = torch.linspace(0.0, 1.0, self.threshold_num,
                                    device=y_pred.device)
        pred_pos = (scores[None, :] >= thresholds[:, None]).float()
        pos = (labels > 0.5).float() * w
        neg = (labels <= 0.5).float() * w
        tp = (pred_pos * pos[None, :]).sum(dim=1)
        fp = (pred_pos * neg[None, :]).sum(dim=1)
        return torch.stack([tp, fp]), torch.stack([pos.sum(), neg.sum()])

    def finalize(self, num, den):
        tp, fp = num[0], num[1]
        p, n = float(den[0]), float(den[1])
        # thresholds ascend, so fpr descends; integrate on reversed arrays
        fpr = np.asarray(fp / max(n, 1e-12))[::-1]
        tpr = np.asarray(tp / max(p, 1e-12))[::-1]
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))


class Loss(Metric):
    """Reports the loss function as a validation metric."""

    name = "loss"

    def __init__(self, loss_fn=None):
        from .objectives import get_loss
        self.loss_fn = get_loss(loss_fn) if loss_fn is not None else None

    def batch_stats(self, y_pred, y_true, sample_weight=None):
        w = _weights(y_pred, sample_weight)
        losses = self.loss_fn.per_sample(y_pred, y_true)
        return (losses * w).sum(), w.sum()


_METRICS = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5acc": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
    "loss": Loss,
}


def get_metric(identifier, loss_fn=None):
    if isinstance(identifier, Metric):
        return identifier
    name = identifier.lower()
    if name == "loss":
        return Loss(loss_fn)
    try:
        return _METRICS[name]()
    except KeyError:
        raise ValueError(f"Unknown metric: {identifier}")
