"""Binary segmentation metrics (threshold 0.5): F1 / Precision / Recall /
Pixel-Accuracy / Dice (counterpart of the JAX ``metrics/segmentation.py``).

Parity target: the torchmetrics objects at
the reference's running_main_v3.py:198-202 (BinaryPrecision/Recall/
Accuracy, F1Score(task="binary"), DiceScore) — all are micro-aggregated
counters over every pixel of every update, so one accumulated
(tp, fp, fn, tn) tuple reproduces them:

  precision = tp/(tp+fp)   recall = tp/(tp+fn)   accuracy = (tp+tn)/total
  f1 = dice = 2tp/(2tp+fp+fn)

:func:`binary_counts` runs on the tensors' device; the accumulation and the
mask-mAP input builders are numpy copies of the JAX functions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def binary_counts(probs: torch.Tensor, gt: torch.Tensor, thresh: float = 0.5):
    """probs/gt: any matching shape. Returns (tp, fp, fn, tn) int64 scalars
    on the tensors' device."""
    pred = probs > thresh
    pos = gt > 0.5
    tp = (pred & pos).sum()
    fp = (pred & ~pos).sum()
    fn = (~pred & pos).sum()
    tn = (~pred & ~pos).sum()
    return tp, fp, fn, tn


class BinarySegMetrics:
    """Accumulating micro binary-segmentation metrics."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.tp = self.fp = self.fn = self.tn = 0

    def update(self, probs, gt) -> None:
        tp, fp, fn, tn = binary_counts(torch.as_tensor(probs), torch.as_tensor(gt))
        self.tp += int(tp)
        self.fp += int(fp)
        self.fn += int(fn)
        self.tn += int(tn)

    def update_counts(self, counts) -> None:
        """counts: [N, 4] per-sample (tp, fp, fn, tn), e.g. device-computed."""
        tp, fp, fn, tn = np.asarray(counts).sum(axis=0)
        self.tp += int(tp)
        self.fp += int(fp)
        self.fn += int(fn)
        self.tn += int(tn)

    def compute(self) -> Dict[str, float]:
        tp, fp, fn, tn = self.tp, self.fp, self.fn, self.tn
        total = tp + fp + fn + tn
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * tp / max(2 * tp + fp + fn, 1)
        return {
            "precision": float(precision),
            "recall": float(recall),
            "f1": float(f1),
            "dice": float(f1),  # binary micro dice == micro F1
            "accuracy": float((tp + tn) / max(total, 1)),
            "iou": float(tp / max(tp + fp + fn, 1)),
        }


def mask_map_inputs_from_counts(counts, scores):
    """Per-image pred/target mAP dicts from device-side scalar reductions, so
    that no mask pixels cross to the host.

    counts: [B, 4] per-image (tp, fp, fn, tn) pixel counts of the
    thresholded semantic mask against the GT (``make_eval_step`` computes
    them on the device); scores: [B] mean foreground probability. For the
    one-pred/one-gt semantic-mask case these determine the mask IoU and
    both areas exactly: iou = tp/(tp+fp+fn), pred area = tp+fp,
    gt area = tp+fn — consumed by MeanAveragePrecision's precomputed-
    geometry path ('ious' + 'areas' keys).

    Empty-geometry semantics match mask_map_inputs: an all-background
    prediction or GT still contributes one zero-area entry whose IoU is 0
    (identical to a [H,W] all-false mask under _mask_iou)."""
    counts = np.asarray(counts, np.float64)
    scores = np.asarray(scores, np.float32)
    preds, targets = [], []
    for i in range(counts.shape[0]):
        tp, fp, fn, _ = counts[i]
        pred_area = tp + fp
        gt_area = tp + fn
        iou = tp / max(tp + fp + fn, 1e-9)
        preds.append(
            dict(
                ious=np.asarray([[iou]], np.float64),
                areas=np.asarray([pred_area], np.float64),
                scores=np.asarray([scores[i]], np.float32),
                labels=np.zeros((1,), np.int64),
            )
        )
        targets.append(
            dict(
                areas=np.asarray([gt_area], np.float64),
                labels=np.zeros((1,), np.int64),
            )
        )
    return preds, targets


def mask_map_inputs_from_masks(pred_masks, scores, gt_masks):
    """Like :func:`mask_map_inputs` but from pre-thresholded masks and
    per-image scores (both computable on the device; only bools and scalars
    cross to the host)."""
    pred_masks = np.asarray(pred_masks).astype(bool)
    scores = np.asarray(scores, np.float32)
    gt_masks = np.asarray(gt_masks)
    if pred_masks.ndim == 4:
        pred_masks = pred_masks[..., 0]
    if gt_masks.ndim == 4:
        gt_masks = gt_masks[..., 0]
    preds, targets = [], []
    for i in range(pred_masks.shape[0]):
        preds.append(
            dict(
                masks=pred_masks[i][None],
                scores=np.asarray([scores[i]], np.float32),
                labels=np.zeros((1,), np.int64),
            )
        )
        targets.append(
            dict(masks=(gt_masks[i] > 0.5)[None], labels=np.zeros((1,), np.int64))
        )
    return preds, targets


def mask_map_inputs(seg_probs: np.ndarray, gt_masks: np.ndarray, thresh: float = 0.5):
    """Build per-image pred/target dicts for MeanAveragePrecision(iou_type=
    'segm') the way the reference does (running_main_v3.py:478-498): one
    whole-image binary mask per image, single class 0, score = mean
    probability over predicted-foreground pixels.

    seg_probs/gt_masks: [B, H, W] (or [B, H, W, 1])."""
    seg_probs = np.asarray(seg_probs)
    gt_masks = np.asarray(gt_masks)
    if seg_probs.ndim == 4:
        seg_probs = seg_probs[..., 0]
    if gt_masks.ndim == 4:
        gt_masks = gt_masks[..., 0]
    preds, targets = [], []
    for i in range(seg_probs.shape[0]):
        pm = seg_probs[i] > thresh
        score = float((seg_probs[i] * pm).sum() / (pm.sum() + 1e-6))
        preds.append(
            dict(
                masks=pm[None],
                scores=np.asarray([score], np.float32),
                labels=np.zeros((1,), np.int64),
            )
        )
        targets.append(
            dict(masks=(gt_masks[i] > 0.5)[None], labels=np.zeros((1,), np.int64))
        )
    return preds, targets
