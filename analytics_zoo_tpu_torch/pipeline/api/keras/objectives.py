"""Loss objectives.

Counterpart of ``analytics_zoo_tpu/pipeline/api/keras/objectives.py``
(parity surface ``zoo/.../pipeline/api/keras/objectives/`` and the string
mapping of ``KerasUtils.toBigDLCriterion``). Each objective computes a
per-sample loss vector so the engine can apply sample weights and padding
masks, then reduces by the weighted mean, with the JAX package's clips
(``_EPS = 1e-7``). Labels are 0-based unless ``zero_based_label=False``.

Not ported yet: ``CRFLoss`` (it needs ``ops/crf.py``) and ``MultiLoss``;
both arrive with the layer-library slice, and asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

_EPS = 1e-7
_LAYER_SLICE = "the layer-library slice of the port"


class LossFunction:
    """Base: subclasses implement per_sample(y_pred, y_true) -> (batch,)."""

    def per_sample(self, y_pred, y_true):
        raise NotImplementedError

    def __call__(self, y_pred, y_true, sample_weight=None):
        losses = self.per_sample(y_pred, y_true)
        if sample_weight is not None:
            return (losses * sample_weight).sum() / \
                torch.clamp(sample_weight.sum(), min=_EPS)
        return losses.mean()

    def __repr__(self):
        return type(self).__name__


def _flat_mean(x):
    """Mean over all non-batch dims -> (batch,)."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def _flat_sum(x):
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def _int_labels(y_true, y_pred, zero_based_label):
    labels = y_true.long()
    if labels.dim() == y_pred.dim():  # allow shape (B, 1)
        labels = labels.reshape(labels.shape[:-1])
    if not zero_based_label:
        labels = labels - 1
    return labels


def _picked(logp, labels):
    picked = torch.gather(logp, -1, labels[..., None]).squeeze(-1)
    if picked.dim() > 1:
        picked = picked.reshape(picked.shape[0], -1).mean(dim=-1)
    return picked


class MeanSquaredError(LossFunction):
    def per_sample(self, y_pred, y_true):
        return _flat_mean(torch.square(y_pred - y_true))


class MeanAbsoluteError(LossFunction):
    def per_sample(self, y_pred, y_true):
        return _flat_mean(torch.abs(y_pred - y_true))


class MeanAbsolutePercentageError(LossFunction):
    def per_sample(self, y_pred, y_true):
        diff = torch.abs(y_true - y_pred) / \
            torch.clamp(torch.abs(y_true), min=_EPS)
        return 100.0 * _flat_mean(diff)


class MeanSquaredLogarithmicError(LossFunction):
    def per_sample(self, y_pred, y_true):
        a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
        b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
        return _flat_mean(torch.square(a - b))


class BinaryCrossEntropy(LossFunction):
    """Expects probabilities in (0, 1) (post-sigmoid)."""

    def per_sample(self, y_pred, y_true):
        p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
        return _flat_mean(-(y_true * torch.log(p) +
                            (1.0 - y_true) * torch.log(1.0 - p)))


class CategoricalCrossEntropy(LossFunction):
    """One-hot targets, probability predictions."""

    def per_sample(self, y_pred, y_true):
        p = torch.clamp(y_pred, _EPS, 1.0)
        return -_flat_sum(y_true * torch.log(p))


class SparseCategoricalCrossEntropy(LossFunction):
    """Integer targets, probability predictions (post-softmax)
    (log_prob_as_input, zero_based_label options)."""

    def __init__(self, log_prob_as_input=False, zero_based_label=True):
        self.log_prob_as_input = log_prob_as_input
        self.zero_based_label = zero_based_label

    def per_sample(self, y_pred, y_true):
        labels = _int_labels(y_true, y_pred, self.zero_based_label)
        logp = y_pred if self.log_prob_as_input else \
            torch.log(torch.clamp(y_pred, _EPS, 1.0))
        return -_picked(logp, labels)


class ClassNLLCriterion(LossFunction):
    """Log-prob inputs + integer labels."""

    def __init__(self, logProbAsInput=True, zeroBasedLabel=True):
        self.inner = SparseCategoricalCrossEntropy(
            log_prob_as_input=logProbAsInput, zero_based_label=zeroBasedLabel)

    def per_sample(self, y_pred, y_true):
        return self.inner.per_sample(y_pred, y_true)


class Hinge(LossFunction):
    """Targets in {-1, 1}."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def per_sample(self, y_pred, y_true):
        return _flat_mean(torch.clamp(self.margin - y_true * y_pred, min=0.0))


class SquaredHinge(LossFunction):
    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def per_sample(self, y_pred, y_true):
        return _flat_mean(torch.square(
            torch.clamp(self.margin - y_true * y_pred, min=0.0)))


class Poisson(LossFunction):
    def per_sample(self, y_pred, y_true):
        return _flat_mean(y_pred - y_true * torch.log(y_pred + _EPS))


class CosineProximity(LossFunction):
    def per_sample(self, y_pred, y_true):
        t = y_true.reshape(y_true.shape[0], -1)
        p = y_pred.reshape(y_pred.shape[0], -1)
        t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                            min=_EPS)
        p = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                            min=_EPS)
        return -(t * p).sum(dim=-1)


class KullbackLeiblerDivergence(LossFunction):
    def per_sample(self, y_pred, y_true):
        t = torch.clamp(y_true, _EPS, 1.0)
        p = torch.clamp(y_pred, _EPS, 1.0)
        return _flat_sum(t * torch.log(t / p))


class RankHinge(LossFunction):
    """Pairwise ranking hinge: consecutive (positive, negative) pairs
    within the batch."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def per_sample(self, y_pred, y_true):
        pos = y_pred[0::2]
        neg = y_pred[1::2]
        loss = torch.clamp(self.margin - pos + neg, min=0.0)
        return torch.repeat_interleave(loss, 2, dim=0) \
            .reshape(y_pred.shape[0], -1)[:, 0]


class SoftmaxCrossEntropyWithLogits(LossFunction):
    """Logits + integer labels."""

    def __init__(self, zero_based_label=True):
        self.zero_based_label = zero_based_label

    def per_sample(self, y_pred, y_true):
        labels = _int_labels(y_true, y_pred, self.zero_based_label)
        return -_picked(torch.log_softmax(y_pred, dim=-1), labels)


class SigmoidCrossEntropyWithLogits(LossFunction):
    def per_sample(self, y_pred, y_true):
        z = y_pred
        return _flat_mean(torch.clamp(z, min=0.0) - z * y_true +
                          torch.log1p(torch.exp(-torch.abs(z))))


class Identity(LossFunction):
    """The prediction IS the loss (a graph that computes its own scalar
    objective)."""

    def per_sample(self, y_pred, y_true):
        if y_pred.dim() == 0:  # graph already reduced over the batch
            batch = y_true.shape[0] if y_true is not None and \
                y_true.dim() > 0 else 1
            return y_pred.expand(batch)
        return _flat_mean(y_pred)


_LOSSES = {
    "identity": Identity,
    "binary_crossentropy": BinaryCrossEntropy,
    "categorical_crossentropy": CategoricalCrossEntropy,
    "mse": MeanSquaredError,
    "mean_squared_error": MeanSquaredError,
    "mae": MeanAbsoluteError,
    "mean_absolute_error": MeanAbsoluteError,
    "hinge": Hinge,
    "mape": MeanAbsolutePercentageError,
    "mean_absolute_percentage_error": MeanAbsolutePercentageError,
    "msle": MeanSquaredLogarithmicError,
    "mean_squared_logarithmic_error": MeanSquaredLogarithmicError,
    "squared_hinge": SquaredHinge,
    "sparse_categorical_crossentropy": SparseCategoricalCrossEntropy,
    "kld": KullbackLeiblerDivergence,
    "kullback_leibler_divergence": KullbackLeiblerDivergence,
    "poisson": Poisson,
    "cosine_proximity": CosineProximity,
    "rank_hinge": RankHinge,
    "softmax_crossentropy_with_logits": SoftmaxCrossEntropyWithLogits,
    "sigmoid_crossentropy_with_logits": SigmoidCrossEntropyWithLogits,
}

_NOT_PORTED = ("crf", "crf_nll")


def get_loss(identifier):
    if identifier is None or isinstance(identifier, LossFunction):
        return identifier
    if isinstance(identifier, (list, tuple)):
        raise NotImplementedError(
            f"MultiLoss (a list of losses) is not ported yet; it arrives "
            f"with {_LAYER_SLICE}")
    if callable(identifier):
        fn = identifier

        class _Wrapped(LossFunction):
            def per_sample(self, y_pred, y_true):
                out = fn(y_pred, y_true)
                if out.dim() == 0:
                    out = out.expand(y_pred.shape[0])
                return out

        return _Wrapped()
    key = identifier.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"CRFLoss is not ported yet (it needs ops/crf.py); it arrives "
            f"with {_LAYER_SLICE}")
    try:
        return _LOSSES[key]()
    except KeyError:
        raise ValueError(f"Unknown loss: {identifier}")
