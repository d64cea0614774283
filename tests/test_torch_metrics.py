"""The port's metric modules and box helpers against the JAX package's, on
seeded numpy inputs (no model): ``core/boxes.py::box_iou_pairwise`` and
``bbox2dist``, ``metrics/classification.py``, ``metrics/segmentation.py``
and ``metrics/detection.py::MeanAveragePrecision``. The numpy metrics are
copies and must agree exactly; the torch box helpers at fp32 rounding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.core import boxes as jax_boxes
from multitask_bonetumor_yolo_tpu.metrics import classification as jax_cls
from multitask_bonetumor_yolo_tpu.metrics import detection as jax_det
from multitask_bonetumor_yolo_tpu.metrics import segmentation as jax_seg
from multitask_bonetumor_yolo_tpu_torch.core import boxes
from multitask_bonetumor_yolo_tpu_torch.metrics import classification, detection, segmentation
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)


def random_xyxy(rs, shape, size=100.0):
    xy = rs.uniform(0, size, shape + (2,))
    wh = rs.uniform(0, size / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def assert_same_dicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_box_helpers_match_jax():
    """``box_iou_pairwise`` on aligned boxes (some disjoint, some degenerate)
    and ``bbox2dist`` with its clamp, against the JAX functions."""
    rs = np.random.RandomState(0)
    a, b = random_xyxy(rs, (3, 50)), random_xyxy(rs, (3, 50))
    b[0, :5] = a[0, :5]  # identical pairs
    a[1, :5, 2:] = a[1, :5, :2]  # zero-area boxes
    got = boxes.box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_boxes.box_iou_pairwise(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got > 0.2).any() and (got == 0).any()

    anchors = rs.uniform(0, 20, (200, 2)).astype(np.float32)
    bx = random_xyxy(rs, (4, 200), size=20.0)
    for reg_max, delta in ((16, 1.01), (8, 0.5)):
        got = boxes.bbox2dist(torch.from_numpy(anchors), torch.from_numpy(bx), reg_max, delta)
        want = jax_boxes.bbox2dist(jnp.asarray(anchors), jnp.asarray(bx), reg_max, delta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert (got.numpy() == 0).any() and (got.numpy() == reg_max - delta).any()


def test_classification_metrics_match_jax():
    """``confusion_matrix`` (both normalisations, out-of-range labels
    dropped) and ``ClassificationMetrics`` fed by logits, by class ids and by
    precomputed counts (``update_cm``) give the JAX values exactly."""
    rs = np.random.RandomState(1)
    for nc in (2, 3):
        preds = rs.randint(-1, nc + 1, 300)
        targets = rs.randint(0, nc, 300)
        for norm in (None, "true"):
            np.testing.assert_array_equal(
                classification.confusion_matrix(preds, targets, nc, norm),
                jax_cls.confusion_matrix(preds, targets, nc, norm))
        ours, theirs = classification.ClassificationMetrics(nc), jax_cls.ClassificationMetrics(nc)
        logits = rs.randn(40, nc).astype(np.float32)
        labels = rs.randint(0, nc, 40)
        counts = rs.randint(0, 9, (nc, nc))
        for m in (ours, theirs):
            m.update(logits, labels)
            m.update(preds[:40].clip(0, nc - 1), targets[:40])
            m.update_cm(counts)
        assert ours.compute() == theirs.compute()
        np.testing.assert_array_equal(ours.normalized_cm(), theirs.normalized_cm())
        with pytest.raises(ValueError):
            ours.update_cm(np.zeros((nc + 1, nc + 1)))


def test_segmentation_metrics_match_jax():
    """``binary_counts`` (torch) against the jitted JAX one; the accumulator
    from probabilities and from per-image counts; the three mask-mAP input
    builders."""
    rs = np.random.RandomState(2)
    probs = rs.rand(3, 24, 20, 1).astype(np.float32)
    probs[0, :4] = 0.5  # exactly at the threshold: background
    gt = (rs.rand(3, 24, 20, 1) > 0.6).astype(np.uint8)
    got = segmentation.binary_counts(torch.from_numpy(probs), torch.from_numpy(gt))
    want = jax_seg.binary_counts(jnp.asarray(probs), jnp.asarray(gt))
    assert [int(v) for v in got] == [int(v) for v in want]

    counts = rs.randint(0, 500, (5, 4))
    scores = rs.rand(5).astype(np.float32)
    ours, theirs = segmentation.BinarySegMetrics(), jax_seg.BinarySegMetrics()
    for m in (ours, theirs):
        m.update(probs, gt)
        m.update_counts(counts)
    assert ours.compute() == theirs.compute()
    assert (ours.tp, ours.fp, ours.fn, ours.tn) == (theirs.tp, theirs.fp, theirs.fn, theirs.tn)

    counts[1] = 0  # an image with no foreground anywhere
    for fn, args in ((segmentation.mask_map_inputs_from_counts, (counts, scores)),
                     (segmentation.mask_map_inputs_from_masks, (probs > 0.5, scores, gt)),
                     (segmentation.mask_map_inputs, (probs, gt))):
        got_p, got_t = fn(*args)
        want_p, want_t = getattr(jax_seg, fn.__name__)(*args)
        assert_same_dicts(got_p, want_p)
        assert_same_dicts(got_t, want_t)


def map_inputs(rs, n_img, nc):
    """Per-image detections and GT of every area range, some empty, with
    detections scattered around the GT so that matches happen at every IoU
    threshold."""
    preds, targets = [], []
    for i in range(n_img):
        g = rs.randint(0 if i == 1 else 1, 6)
        gt = random_xyxy(rs, (g,), size=300.0)
        gt[:, 2:] += rs.choice([0.0, 40.0, 120.0], (g, 1))  # small, medium, large
        d = rs.randint(0 if i == 2 else 1, 15)
        src = gt[rs.randint(0, g, d)] if g else random_xyxy(rs, (d,), size=300.0)
        det = src + rs.randn(d, 4).astype(np.float32) * rs.choice([1.0, 5.0, 30.0], (d, 1))
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1.0)
        preds.append(dict(boxes=det, scores=rs.rand(d).astype(np.float32),
                          labels=rs.randint(0, nc, d).astype(np.int64)))
        targets.append(dict(boxes=gt, labels=rs.randint(0, nc, g).astype(np.int64)))
    return preds, targets


@pytest.mark.parametrize("kind", ["bbox", "segm", "precomputed"])
def test_mean_average_precision_matches_jax(kind):
    """Every key of ``MeanAveragePrecision.compute`` (per-class keys
    included) equals the JAX accumulator's, fed the same two updates: boxes
    at the default IoU thresholds and at 0.5 alone with max-dets 1 / 5 / 100;
    whole-image masks; the precomputed-geometry path of the device-side mask
    mAP."""
    rs = np.random.RandomState({"bbox": 3, "segm": 4, "precomputed": 5}[kind])
    settings = [dict(class_metrics=True), dict(iou_thresholds=[0.5], class_metrics=True,
                                               max_detection_thresholds=(5, 1, 100))]
    if kind == "bbox":
        updates = [map_inputs(rs, 6, 3), map_inputs(rs, 4, 3)]
    elif kind == "segm":
        probs = rs.rand(6, 16, 16).astype(np.float32)
        flip = rs.rand(6, 16, 16) < rs.uniform(0.02, 0.4, (6, 1, 1))
        gt = ((probs > 0.5) ^ flip).astype(np.float32)
        updates = [segmentation.mask_map_inputs(probs[:4], gt[:4]),
                   segmentation.mask_map_inputs(probs[4:], gt[4:])]
    else:
        counts = rs.randint(0, 300, (7, 4))
        counts[:, 0] *= rs.randint(1, 8, 7)  # IoUs from ~0.3 to ~0.9
        counts[3, :3] = 0
        updates = [segmentation.mask_map_inputs_from_counts(counts, rs.rand(7))]
    for setting in settings:
        iou_type = "bbox" if kind == "bbox" else "segm"
        ours = detection.MeanAveragePrecision(iou_type, **setting)
        theirs = jax_det.MeanAveragePrecision(iou_type, **setting)
        for p, t in updates:
            ours.update(p, t)
            theirs.update(p, t)
        got, want = ours.compute(), theirs.compute()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert got["map"] > 0 and got["map"] < 1
