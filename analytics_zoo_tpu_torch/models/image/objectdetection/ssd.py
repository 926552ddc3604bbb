"""SSD (Single Shot MultiBox Detector).

Counterpart of ``analytics_zoo_tpu/models/image/objectdetection/ssd.py``
(parity: the reference's SSD-VGG/MobileNet graphs with PriorBox /
DetectionOutput modules, ``zoo/.../models/image/objectdetection/``). The
multiscale heads concatenate into one (B, priors, 4 + C) tensor; the
priors and the training targets (``generate_priors``, ``encode_boxes``,
``iou_matrix``, ``match_priors``) are host numpy, copied. Box decoding,
NMS, ``detection_output`` and ``MultiBoxLoss`` are torch on the model's
device. The JAX package vmaps an image's NMS and loops over the classes
in Python; here NMS runs over every (image, class) pair at once, so its
loop runs ``ceil(top_k / (C - 1))`` times, not that times B x (C - 1).
Ties break as JAX breaks them: NMS takes the first maximum, and the
final top-k and the hard-negative rank sort stably.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ....pipeline.api.keras.layers import (Activation, BatchNormalization,
                                           Convolution2D, Input, Permute,
                                           Reshape)
from ....pipeline.api.keras.layers.merge import Concatenate
from ....pipeline.api.keras.models import Model
from ....pipeline.api.keras.objectives import LossFunction

# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------


def generate_priors(image_size: int = 300,
                    feature_sizes: Sequence[int] = (38, 19, 10, 5, 3, 1),
                    min_sizes: Sequence[float] = (30, 60, 111, 162, 213, 264),
                    max_sizes: Sequence[float] = (60, 111, 162, 213, 264,
                                                  315),
                    aspect_ratios: Sequence[Sequence[float]] = (
                        (2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                    clip: bool = True) -> np.ndarray:
    """SSD300 prior boxes in center-size form, normalized to [0,1].

    (PriorBox semantics of the reference SSD pipeline; computed on the
    host once: the device sees a constant tensor.)
    """
    priors: List[Tuple[float, float, float, float]] = []
    for fs, mn, mx, ars in zip(feature_sizes, min_sizes, max_sizes,
                               aspect_ratios):
        step = image_size / fs
        for i in range(fs):
            for j in range(fs):
                cx = (j + 0.5) * step / image_size
                cy = (i + 0.5) * step / image_size
                s = mn / image_size
                priors.append((cx, cy, s, s))
                sp = math.sqrt(s * (mx / image_size))
                priors.append((cx, cy, sp, sp))
                for ar in ars:
                    r = math.sqrt(ar)
                    priors.append((cx, cy, s * r, s / r))
                    priors.append((cx, cy, s / r, s * r))
    out = np.asarray(priors, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def priors_per_cell(aspect_ratios: Sequence[float]) -> int:
    return 2 + 2 * len(aspect_ratios)


# ---------------------------------------------------------------------------
# box math
# ---------------------------------------------------------------------------

VARIANCES = (0.1, 0.2)


def decode_boxes(loc, priors, variances=VARIANCES):
    """loc deltas (..., N, 4) + priors (N, 4 cs-form) -> corner boxes."""
    pcx, pcy, pw, ph = (priors[..., k] for k in range(4))
    cx = loc[..., 0] * variances[0] * pw + pcx
    cy = loc[..., 1] * variances[0] * ph + pcy
    w = torch.exp(loc[..., 2] * variances[1]) * pw
    h = torch.exp(loc[..., 3] * variances[1]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def encode_boxes(matched, priors, variances=VARIANCES):
    """corner gt boxes matched per prior -> regression targets (numpy ok)."""
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    gw = np.maximum(matched[..., 2] - matched[..., 0], 1e-8)
    gh = np.maximum(matched[..., 3] - matched[..., 1], 1e-8)
    pcx, pcy, pw, ph = (priors[..., k] for k in range(4))
    return np.stack([
        (gcx - pcx) / (variances[0] * pw),
        (gcy - pcy) / (variances[0] * ph),
        np.log(gw / pw) / variances[1],
        np.log(gh / ph) / variances[1]], axis=-1).astype(np.float32)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A,4) x (B,4) corner-form IoU (host-side target assignment)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-8)


def match_priors(gt_boxes: np.ndarray, gt_labels: np.ndarray,
                 priors: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Assign ground truth to priors (host-side target encoding).

    Returns (num_priors, 5): [dx, dy, dw, dh, label] with label 0 =
    background. Standard SSD bipartite + per-prior matching.
    """
    n = priors.shape[0]
    target = np.zeros((n, 5), np.float32)
    if len(gt_boxes) == 0:
        return target
    pr_corner = np.stack([
        priors[:, 0] - priors[:, 2] / 2, priors[:, 1] - priors[:, 3] / 2,
        priors[:, 0] + priors[:, 2] / 2, priors[:, 1] + priors[:, 3] / 2],
        axis=1)
    iou = iou_matrix(np.asarray(gt_boxes, np.float32), pr_corner)
    best_prior_per_gt = iou.argmax(axis=1)
    best_gt_per_prior = iou.argmax(axis=0)
    best_gt_iou = iou.max(axis=0)
    # force each gt's best prior to match it
    for g, p in enumerate(best_prior_per_gt):
        best_gt_per_prior[p] = g
        best_gt_iou[p] = 2.0
    pos = best_gt_iou >= threshold
    matched = np.asarray(gt_boxes)[best_gt_per_prior]
    target[:, :4] = encode_boxes(matched, priors)
    target[pos, 4] = np.asarray(gt_labels)[best_gt_per_prior[pos]]
    target[~pos, 4] = 0
    return target


# ---------------------------------------------------------------------------
# NMS: fixed trip count, batched over (image, class)
# ---------------------------------------------------------------------------


def nms(boxes, scores, iou_threshold: float = 0.45, max_out: int = 100):
    """Greedy NMS over ``scores`` (..., N) sharing ``boxes`` (..., N, 4)
    (leading dims broadcast: boxes (B, 1, N, 4) serve scores (B, C, N)).
    Returns (indices, kept scores), each (..., min(max_out, N)); slots
    past the real detections carry score -inf."""
    boxes = torch.as_tensor(boxes)
    scores = torch.as_tensor(scores, dtype=torch.float32)
    n = scores.shape[-1]
    max_out = min(max_out, n)
    lead = torch.broadcast_shapes(boxes.shape[:-2], scores.shape[:-1])
    boxes = boxes.expand(lead + boxes.shape[-2:])
    remaining = scores.expand(lead + (n,)).clone()
    areas = torch.prod(boxes[..., 2:] - boxes[..., :2], dim=-1)
    ar = torch.arange(n, device=scores.device)
    keep_idx = torch.zeros(lead + (max_out,), dtype=torch.long,
                           device=scores.device)
    keep_score = torch.full(lead + (max_out,), -math.inf,
                            device=scores.device)
    for i in range(max_out):
        # the first maximum, as jnp.argmax takes it (also when every
        # score is -inf), whatever order the device's reduction visits
        top = remaining.amax(dim=-1, keepdim=True)
        j = torch.where(remaining == top, ar, n).amin(dim=-1, keepdim=True)
        keep_idx[..., i] = j[..., 0]
        keep_score[..., i] = torch.gather(remaining, -1, j)[..., 0]
        box = torch.gather(boxes, -2, j[..., None].expand(
            j.shape + (4,)))                       # (..., 1, 4)
        tl = torch.maximum(box[..., :2], boxes[..., :2])
        br = torch.minimum(box[..., 2:], boxes[..., 2:])
        inter = torch.prod(torch.clamp(br - tl, min=0), dim=-1)
        area = torch.prod(box[..., 2:] - box[..., :2], dim=-1)
        iou = inter / torch.clamp(area + areas - inter, min=1e-8)
        suppress = (iou > iou_threshold) | (ar == j)
        remaining = torch.where(suppress, -math.inf, remaining)
    return keep_idx, keep_score


def detection_output(preds, priors, num_classes: int,
                     conf_threshold: float = 0.01,
                     iou_threshold: float = 0.45,
                     top_k: int = 100):
    """(B, N, 4+C) raw head output -> (B, top_k, 6) [label, score, box]
    on ``preds``' device: softmax, box decode, per-class NMS with fixed
    output slots (rows past the real detections have score -inf), and
    the top ``top_k`` rows by score."""
    preds = torch.as_tensor(preds, dtype=torch.float32)
    priors = torch.as_tensor(priors, dtype=torch.float32,
                             device=preds.device)
    loc, logits = preds[..., :4], preds[..., 4:]
    conf = torch.softmax(logits, dim=-1)
    boxes = torch.clamp(decode_boxes(loc, priors), 0.0, 1.0)  # (B, N, 4)
    # ceil so the class-wise pools always cover top_k total rows
    per_class = max(1, -(-top_k // max(1, num_classes - 1)))
    cls = conf[..., 1:].transpose(1, 2)                        # (B, C-1, N)
    scores = torch.where(cls >= conf_threshold, cls, -math.inf)
    idx, kept = nms(boxes[:, None], scores, iou_threshold, per_class)
    b, c1, k = idx.shape
    sel = torch.gather(boxes[:, None].expand(b, c1, -1, 4), 2,
                       idx[..., None].expand(b, c1, k, 4))
    labels = torch.arange(1, num_classes, device=preds.device,
                          dtype=torch.float32)[None, :, None, None]
    rows = torch.cat([labels.expand(b, c1, k, 1), kept[..., None], sel],
                     dim=-1).reshape(b, c1 * k, 6)
    order = torch.argsort(-rows[..., 1], dim=1, stable=True)[:, :top_k]
    return torch.gather(rows, 1, order[..., None].expand(-1, -1, 6))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


class MultiBoxLoss(LossFunction):
    """SSD loss: smooth-L1 on matched locs + cross-entropy with hard
    negative mining (neg:pos = 3:1), per image over its positives.
    ``selection`` picks the priors the cross-entropy sums over and
    ``masked_loss`` sums over a given selection, so a caller can hold two
    runs to one selection (near-tied negatives make the mining
    discontinuous)."""

    def __init__(self, num_classes: int, neg_pos_ratio: float = 3.0):
        self.num_classes = num_classes
        self.neg_pos_ratio = neg_pos_ratio

    @staticmethod
    def _cross_entropy(y_pred, labels):
        logp = torch.log_softmax(y_pred[..., 4:], dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]

    def selection(self, y_pred, y_true):
        """(B, N) bool: the positives and the hard negatives, the
        ``neg_pos_ratio * n_pos`` background priors of largest
        cross-entropy (ties to the lower index)."""
        labels = y_true[..., 4].long()
        pos = labels > 0
        n_pos = torch.clamp(pos.sum(dim=1), min=1)
        ce = self._cross_entropy(y_pred.detach(), labels)
        neg_ce = torch.where(pos, -math.inf, ce)
        rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True),
                             dim=1, stable=True)
        n_neg = torch.minimum((self.neg_pos_ratio * n_pos).to(torch.int32),
                              (~pos).sum(dim=1).to(torch.int32))
        return pos | (rank < n_neg[:, None])

    def masked_loss(self, y_pred, y_true, keep):
        """The per-image loss with the cross-entropy summed over
        ``keep``."""
        labels = y_true[..., 4].long()
        pos = labels > 0
        n_pos = torch.clamp(pos.sum(dim=1), min=1)
        diff = torch.abs(y_pred[..., :4] - y_true[..., :4])
        smooth_l1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        loc_loss = torch.where(pos[..., None], smooth_l1, 0.0).sum(
            dim=(1, 2))
        ce = self._cross_entropy(y_pred, labels)
        conf_loss = torch.where(keep, ce, 0.0).sum(dim=1)
        return (loc_loss + conf_loss) / n_pos

    def per_sample(self, y_pred, y_true):
        return self.masked_loss(y_pred, y_true,
                                self.selection(y_pred, y_true))


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------


def _head(x, n_priors, num_classes, name):
    out = Convolution2D(n_priors * (4 + num_classes), 3, 3,
                        border_mode="same", name=name)(x)
    # NCHW (B, P*(4+C), H, W) -> (B, H, W, P*(4+C)) -> (B, H*W*P, 4+C)
    out = Permute((2, 3, 1))(out)
    return Reshape((-1, 4 + num_classes))(out)


def build_ssd(num_classes: int, image_size: int = 300,
              base_channels: int = 32,
              max_scales: int = 6) -> Tuple[Model, np.ndarray]:
    """A compact SSD (BN backbone, up to 6 adaptive scales).

    Returns (model, priors); model output is (B, num_priors,
    4 + num_classes). Prior sizes follow the standard SSD scale schedule
    s_k = 0.2 + 0.7·k/(m−1).
    """
    inp = Input(shape=(3, image_size, image_size), name="image")

    def conv_bn(x, ch, stride=1):
        x = Convolution2D(ch, 3, 3, subsample=(stride, stride),
                          border_mode="same", bias=False)(x)
        x = BatchNormalization()(x)
        return Activation("relu")(x)

    c = base_channels
    x = conv_bn(inp, c, 2)
    x = conv_bn(x, c * 2, 2)
    x = conv_bn(x, c * 4, 2)
    feats = [conv_bn(x, c * 4)]   # first detection scale (size/8)
    ch = c * 8
    while len(feats) < max_scales and feats[-1].shape[2] > 1:
        stride_feat = conv_bn(feats[-1], ch, 2)
        feats.append(conv_bn(stride_feat, ch))

    base_aspect = [(2,), (2, 3), (2, 3), (2, 3), (2,), (2,)]
    aspect = [base_aspect[min(k, len(base_aspect) - 1)]
              for k in range(len(feats))]
    feature_sizes = [int(f.shape[2]) for f in feats]
    m = len(feats)
    scales = [0.2 + 0.7 * k / max(m - 1, 1) for k in range(m + 1)]
    min_sizes = [s * image_size for s in scales[:m]]
    max_sizes = [s * image_size for s in scales[1:m + 1]]

    heads = [_head(f, priors_per_cell(ars), num_classes, name=f"head{k}")
             for k, (f, ars) in enumerate(zip(feats, aspect))]
    out = heads[0] if len(heads) == 1 else Concatenate(axis=1)(heads)
    model = Model(inp, out)
    priors = generate_priors(image_size, feature_sizes, min_sizes,
                             max_sizes, aspect)
    return model, priors
