"""The SSD object detector of the port against the JAX package on the
CPU: the priors and training targets, box decoding, NMS and
``detection_output`` on drawn scores with ties and classes below the
threshold, ``MultiBoxLoss`` and its gradient, ``ObjectDetector``'s head
output, ``predict_image_set`` rows from seeded PNG and JPEG files and one
``fit`` step from copied weights, and ``ImageClassifier.
predict_image_set`` through its default chain.

Tolerances (largest |port - JAX|):
- priors, matched targets, encoded boxes: equal (the same numpy code);
- ``decode_boxes`` 1e-4: PyTorch's vectorised CPU ``exp`` is off the
  float64 value by up to 2.5e-5 relative for some arguments, depending
  on how a tensor falls into vector lanes (measured 5.4e-5 apart from
  JAX, whose ``exp`` is within 1e-7); ``nms`` indices equal and kept
  scores equal; ``detection_output`` labels equal, scores 1e-6 (a
  softmax summed in another order) and boxes 1e-4 (the same ``exp``);
- ``MultiBoxLoss`` 1e-5 of the loss, its gradient 1e-5 of the
  gradient's largest element;
- the detector's head output 1e-4 (six scales of float32 convolutions
  summed in another order); ``predict_image_set`` rows: the same labels
  in the same order, scores 1e-5 and boxes 1e-3 pixels;
- one SGD ``fit`` step: the loss 1e-5, every weight and moving statistic
  1e-5;
- ``ImageClassifier.predict_image_set``'s probabilities 1e-5.
"""

import random

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import nncontext as jnn
from analytics_zoo_tpu.feature.image import ImageSet as JImageSet
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu.models.image.objectdetection import object_detector \
    as jod
from analytics_zoo_tpu.models.image.objectdetection import ssd as jssd
from analytics_zoo_tpu_torch.common import nncontext as tnn
from analytics_zoo_tpu_torch.feature.image import ImageSet as TImageSet
from analytics_zoo_tpu_torch.feature.image import codec
from analytics_zoo_tpu_torch.models.image import imageclassification as tic
from analytics_zoo_tpu_torch.models.image.objectdetection import \
    object_detector as tod
from analytics_zoo_tpu_torch.models.image.objectdetection import ssd as tssd
from analytics_zoo_tpu_torch.utils import load_jax_params

DECODE_TOL = 1e-4
ROW_TOL = 1e-6
LOSS_TOL = 1e-5
HEAD_TOL = 1e-4
PIXEL_TOL = 1e-3
FIT_TOL = 1e-5
PROB_TOL = 1e-5


@pytest.fixture(autouse=True)
def _contexts():
    jnn.set_nncontext(jnn.ZooContext(jnn.ZooConfig(log_every_n_steps=1),
                                     devices=jax.devices()[:1]))
    tnn.set_nncontext(None)
    tnn.init_nncontext(device="cpu")
    yield
    jnn.set_nncontext(None)
    tnn.set_nncontext(None)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64) -
                        np.asarray(want, np.float64)).max())


def _pair_trees(jmodel, tmodel, seed):
    """The port model's weights as a JAX params tree under the JAX
    model's layer names (the same code built both graphs, so their
    layers pair in order) and seeded moving statistics for both."""
    pairs = list(zip(jmodel.graph_function().layers,
                     tmodel.graph_function().layers))
    assert all(type(j).__name__ == type(t).__name__ for j, t in pairs)
    params = {j.name: {k: v.detach().numpy().copy()
                       for k, v in t.param_tree().items()}
              for j, t in pairs if t.param_tree()}
    rs = np.random.default_rng(seed)
    state = {j.name: {"moving_mean": rs.uniform(-0.2, 0.2, s.shape)
                      .astype(np.float32),
                      "moving_var": rs.uniform(0.5, 1.5, s.shape)
                      .astype(np.float32)}
             for j, t in pairs if t.state_tree()
             for s in [t.state_tree()["moving_mean"]]}
    return params, state


def _detector_pair(class_num=3, image_size=64, base_channels=4, seed=1):
    jdet = jod.ObjectDetector(class_num=class_num, image_size=image_size,
                              base_channels=base_channels)
    tdet = tod.ObjectDetector(class_num=class_num, image_size=image_size,
                              base_channels=base_channels)
    params, state = _pair_trees(jdet.model, tdet.model, seed)
    jdet.model._built_params = (params, state)
    load_jax_params(tdet.model, params, state=state)
    return jdet, tdet, params, state


# ---------------------------------------------------------------------------
# priors and targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [
    dict(),   # SSD300's published schedule
    dict(image_size=64, feature_sizes=(8, 4, 2, 1),
         min_sizes=(12.8, 27.7, 42.7, 57.6), max_sizes=(27.7, 42.7, 57.6,
                                                       72.5),
         aspect_ratios=((2,), (2, 3), (2, 3), (2, 3)))])
def test_priors_match_jax(config):
    want = jssd.generate_priors(**config)
    got = tssd.generate_priors(**config)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_full_width_detector_has_8744_priors_over_six_scales():
    det = tod.ObjectDetector(class_num=21)
    assert det.priors.shape == (8744, 4)
    shape = det.model.graph_function().outputs[0].shape
    assert tuple(shape) == (None, 8744, 25)
    heads = sorted(l.name for l in det.model.graph_function().layers
                   if l.name.startswith("head"))
    assert heads == [f"head{k}" for k in range(6)]


def test_match_priors_and_encode_boxes_match_jax():
    priors = tssd.generate_priors(64, (8, 4, 2, 1), (12.8, 27.7, 42.7, 57.6),
                                  (27.7, 42.7, 57.6, 72.5),
                                  ((2,), (2, 3), (2, 3), (2, 3)))
    rs = np.random.default_rng(3)
    for n_gt in (0, 1, 3):
        xy = rs.uniform(0, 0.6, (n_gt, 2))
        boxes = np.concatenate([xy, xy + rs.uniform(0.1, 0.4, (n_gt, 2))],
                               1).astype(np.float32)
        labels = rs.integers(1, 3, n_gt)
        want = jssd.match_priors(boxes, labels, priors)
        got = tssd.match_priors(boxes, labels, priors)
        np.testing.assert_array_equal(got, want)
        if n_gt:
            assert (got[:, 4] > 0).sum() >= n_gt
    corner = rs.uniform(0, 1, (len(priors), 4)).astype(np.float32)
    np.testing.assert_array_equal(tssd.encode_boxes(corner, priors),
                                  jssd.encode_boxes(corner, priors))
    np.testing.assert_array_equal(tssd.iou_matrix(corner[:5], corner[5:9]),
                                  jssd.iou_matrix(corner[:5], corner[5:9]))


# ---------------------------------------------------------------------------
# decode, NMS, detection_output
# ---------------------------------------------------------------------------

def _drawn_preds(rs, b, n, num_classes):
    """Head outputs whose class scores tie (logits on a coarse grid, some
    priors sharing a logit row) and one class that never clears the
    threshold."""
    loc = rs.normal(0, 0.5, (b, n, 4)).astype(np.float32)
    logits = rs.integers(-2, 3, (b, n, num_classes)).astype(np.float32)
    logits[:, ::7] = logits[:, 3:4]          # many identical rows: ties
    logits[..., num_classes - 1] = -30.0     # below any threshold
    return np.concatenate([loc, logits], -1)


def test_decode_boxes_matches_jax():
    rs = np.random.default_rng(4)
    priors = tssd.generate_priors()
    loc = rs.normal(0, 1, (2, len(priors), 4)).astype(np.float32)
    want = np.asarray(jssd.decode_boxes(loc, priors))
    got = tssd.decode_boxes(torch.from_numpy(loc),
                            torch.from_numpy(priors)).numpy()
    d = np.abs(got - want)
    at = np.unravel_index(d.argmax(), d.shape)
    assert d.max() <= DECODE_TOL, (at, got[at], want[at], loc[at[:2]])


@pytest.mark.parametrize("max_out", [1, 5, 40])
def test_nms_matches_jax(max_out):
    rs = np.random.default_rng(5)
    n = 60
    xy = rs.uniform(0, 0.7, (n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0.05, 0.3, (n, 2))],
                           1).astype(np.float32)
    boxes[10:20] = boxes[0]                  # coincident boxes
    scores = rs.integers(0, 6, n).astype(np.float32) / 5   # ties
    scores[::9] = -np.inf
    jidx, jscore = jssd.nms(boxes, scores, 0.45, max_out)
    tidx, tscore = tssd.nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), 0.45, max_out)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(jscore))
    # every score below the threshold: the first index, score -inf
    none = np.full(n, -np.inf, np.float32)
    jidx, jscore = jssd.nms(boxes, none, 0.45, 3)
    tidx, tscore = tssd.nms(torch.from_numpy(boxes), torch.from_numpy(none),
                            0.45, 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.all(np.isneginf(tscore.numpy()))


@pytest.mark.parametrize("num_classes,top_k", [(4, 100), (6, 7), (3, 12)])
def test_detection_output_matches_jax(num_classes, top_k):
    rs = np.random.default_rng(num_classes)
    priors = tssd.generate_priors(64, (8, 4, 2, 1), (12.8, 27.7, 42.7, 57.6),
                                  (27.7, 42.7, 57.6, 72.5),
                                  ((2,), (2, 3), (2, 3), (2, 3)))
    preds = _drawn_preds(rs, 3, len(priors), num_classes)
    want = np.asarray(jssd.detection_output(preds, priors, num_classes,
                                            conf_threshold=0.05,
                                            top_k=top_k))
    got = tssd.detection_output(torch.from_numpy(preds),
                                torch.from_numpy(priors), num_classes,
                                conf_threshold=0.05, top_k=top_k).numpy()
    assert got.shape == want.shape == (3, top_k, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    real = np.isfinite(want[..., 1])
    np.testing.assert_array_equal(np.isfinite(got[..., 1]), real)
    assert _err(got[..., 1][real], want[..., 1][real]) <= ROW_TOL
    assert _err(got[..., 2:][real], want[..., 2:][real]) <= DECODE_TOL
    # the class that never clears the threshold has no real row
    assert not np.any(got[..., 0][real] == num_classes - 1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_multibox_loss_and_gradient_match_jax():
    rs = np.random.default_rng(7)
    b, n, c = 3, 50, 4
    y_pred = rs.normal(0, 1, (b, n, 4 + c)).astype(np.float32)
    y_true = np.zeros((b, n, 5), np.float32)
    y_true[..., :4] = rs.normal(0, 1.5, (b, n, 4))
    y_true[0, :4, 4] = [1, 2, 3, 1]
    y_true[1, 10:30, 4] = rs.integers(1, c, 20)   # 3 * 20 > 30 negatives
    # image 2 has no positive: n_pos clamps to 1
    y_pred[2, 5:9, 4:] = y_pred[2, 4, 4:]         # tied negatives
    jloss = jssd.MultiBoxLoss(c)
    tloss = tssd.MultiBoxLoss(c)
    want = np.asarray(jloss.per_sample(y_pred, y_true))
    got = tloss.per_sample(torch.from_numpy(y_pred), torch.from_numpy(y_true))
    assert _err(got.numpy(), want) <= LOSS_TOL * np.abs(want).max()
    wgrad = np.asarray(jax.grad(lambda p: jloss(p, y_true))(y_pred))
    x = torch.from_numpy(y_pred).requires_grad_(True)
    tloss(x, torch.from_numpy(y_true)).backward()
    assert _err(x.grad.numpy(), wgrad) <= LOSS_TOL * np.abs(wgrad).max()
    assert np.abs(wgrad).max() > 0


# ---------------------------------------------------------------------------
# ObjectDetector
# ---------------------------------------------------------------------------

def test_detector_head_output_matches_jax():
    jdet, tdet, params, state = _detector_pair()
    x = np.random.default_rng(8).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    want = np.asarray(jdet.model.predict(x, batch_size=2))
    got = tdet.model.predict(x, batch_size=2)
    assert got.shape == want.shape == (2, len(tdet.priors), 7)
    assert _err(got, want) <= HEAD_TOL
    dev = tdet.forward_device(x)
    assert _err(dev.numpy(), want) <= HEAD_TOL
    rows = tdet.detect(x, batch_size=1)
    wrows = np.asarray(jdet.detect(x))
    np.testing.assert_array_equal(rows[..., 0], wrows[..., 0])


def _write_images(root, rs, n=6):
    """Seeded images drawn as gradients with filled rectangles, half PNG,
    half baseline JPEG, in two class folders."""
    paths = []
    for i in range(n):
        h, w = (45, 60) if i % 2 else (64, 48)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                        np.full((h, w), 40.0 * i)], -1)
        for _ in range(2):
            y0, x0 = rs.integers(0, h // 2), rs.integers(0, w // 2)
            img[y0:y0 + h // 3, x0:x0 + w // 3] = rs.integers(0, 256, 3)
        img = img.astype(np.uint8)
        folder = root / ("cat" if i < n // 2 else "dog")
        folder.mkdir(exist_ok=True)
        if i % 2:
            p = folder / f"img{i}.png"
            p.write_bytes(codec.encode_png(img))
        else:
            p = folder / f"img{i}.jpg"
            p.write_bytes(codec.encode_jpeg(img, 90))
        paths.append(p)
    return paths


def test_detector_predict_image_set_matches_jax(tmp_path):
    _write_images(tmp_path, np.random.default_rng(9))
    jdet, tdet, params, state = _detector_pair()
    jset = jdet.predict_image_set(JImageSet.read(str(tmp_path),
                                                 with_label=True))
    tset = tdet.predict_image_set(TImageSet.read(str(tmp_path),
                                                 with_label=True),
                                  batch_size=4)
    assert len(tset) == len(jset) == 6
    n_rows = 0
    for jf, tf in zip(jset.features, tset.features):
        assert jf["uri"] == tf["uri"]
        want, got = jf["detection"], tf["detection"]
        assert got.shape == want.shape and got.shape[1] == 6
        n_rows += len(got)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        assert _err(got[:, 1], want[:, 1]) <= LOSS_TOL
        assert _err(got[:, 2:], want[:, 2:]) <= PIXEL_TOL
        assert np.all(got[:, [2, 4]] <= tf["original_width"] + PIXEL_TOL)
        assert np.all(got[:, [3, 5]] <= tf["original_height"] + PIXEL_TOL)
        assert tf["original_mat"].shape[:2] == (tf["original_height"],
                                                tf["original_width"])
    assert n_rows > 0
    img = tod.visualize(tset.features[0], threshold=0.0)
    assert img.shape == tset.features[0]["original_mat"].shape
    row = tset.features[0]["detection"][0]
    x1, y1 = int(row[2]), int(row[3])
    if 0 <= y1 < img.shape[0] and 0 <= x1 < img.shape[1]:
        np.testing.assert_array_equal(img[y1, x1], [0, 255, 0])


def test_detector_fit_step_matches_jax(tmp_path):
    jdet, tdet, params, state = _detector_pair(seed=2)
    rs = np.random.default_rng(10)
    x = rs.standard_normal((4, 3, 64, 64)).astype(np.float32)
    boxes, labels = [], []
    for _ in range(4):
        k = int(rs.integers(1, 4))
        xy = rs.uniform(0, 0.6, (k, 2))
        boxes.append(np.concatenate([xy, xy + rs.uniform(0.15, 0.4, (k, 2))],
                                    1).astype(np.float32))
        labels.append(rs.integers(1, 3, k))
    y = tdet.encode_targets(boxes, labels)
    np.testing.assert_array_equal(y, jdet.encode_targets(boxes, labels))
    jdet.compile(optimizer="sgd")
    jdet.model._built_params = (params, state)
    jdet.model.set_tensorboard(str(tmp_path), "jax")
    jdet.model.fit(x, y, batch_size=4, nb_epoch=1)
    jloss = [v for _, _, _, v in jdet.model.get_train_summary("Loss")]
    jparams, jstate = jax.tree.map(np.array, jdet.model._params_tuple())
    tdet.compile(optimizer="sgd")
    tdet.model.fit(x, y, batch_size=4, nb_epoch=1)
    tloss = tdet.model.trainer.step_losses
    assert len(tloss) == len(jloss) == 1
    assert _err(tloss, jloss) <= FIT_TOL * max(1.0, abs(jloss[0]))
    twin = tod.ObjectDetector(class_num=3, image_size=64, base_channels=4)
    load_jax_params(twin.model, jparams, state=jstate)
    for (name, p), (_, want) in zip(tdet.model.named_parameters(),
                                    twin.model.named_parameters()):
        assert _err(p.detach().numpy(), want.detach().numpy()) <= FIT_TOL, \
            name
    for (name, b), (_, want) in zip(tdet.model.named_buffers(),
                                    twin.model.named_buffers()):
        assert _err(b.numpy(), want.numpy()) <= FIT_TOL, name
    # the step moves the parameters well past the tolerance, so that a
    # fit that left them where they were could not pass the comparison
    moved = max(_err(jparams[n][k], params[n][k])
                for n in params for k in params[n])
    assert moved > 10 * FIT_TOL, moved


def test_image_classifier_predict_image_set_default_chain_matches_jax(
        tmp_path):
    _write_images(tmp_path, np.random.default_rng(12), n=4)
    jclf = jic.ImageClassifier(class_num=5, model_name="squeezenet",
                               input_shape=(3, 64, 64))
    tclf = tic.ImageClassifier(class_num=5, model_name="squeezenet",
                               input_shape=(3, 64, 64))
    params, state = _pair_trees(jclf.model, tclf.model, 13)
    jclf.model._built_params = (params, state)
    load_jax_params(tclf.model, params, state=state)
    random.seed(0)
    jset = jclf.predict_image_set(JImageSet.read(str(tmp_path)))
    tset = tclf.predict_image_set(TImageSet.read(str(tmp_path)),
                                  batch_size=3)
    for jf, tf in zip(jset.features, tset.features):
        assert tf["clses"] == jf["clses"]
        assert _err(tf["probs"], jf["probs"]) <= PROB_TOL
        assert tf["sample"].features[0].shape == (3, 64, 64)
