"""Image-classification metrics: micro accuracy, macro P/R/F1, confusion
matrices (optionally row-normalised).

A copy of ``multitask_bonetumor_yolo_tpu/metrics/classification.py`` (numpy
only): importing it from the JAX package would import jax through its
``metrics/__init__.py``.

Parity targets: MulticlassAccuracy(average='micro'),
MulticlassConfusionMatrix(normalize='true') at
the reference's running_main_v3.py:193-195 and the macro P/R/F1 of
multitask_logging.log_cls_metrics (multitask_logging.py:298-361).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(
    preds: np.ndarray, targets: np.ndarray, num_classes: int,
    normalize: Optional[str] = None,
) -> np.ndarray:
    """Integer preds/targets -> [C, C] matrix (rows = true class).
    normalize='true' divides each row by its sum (torchmetrics convention)."""
    preds = np.asarray(preds).astype(np.int64).ravel()
    targets = np.asarray(targets).astype(np.int64).ravel()
    ok = (preds >= 0) & (preds < num_classes) & (targets >= 0) & (targets < num_classes)
    cm = np.zeros((num_classes, num_classes), np.float64)
    np.add.at(cm, (targets[ok], preds[ok]), 1.0)
    if normalize == "true":
        row = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, row, out=np.zeros_like(cm), where=row > 0)
    return cm


class ClassificationMetrics:
    """Accumulating confusion-matrix-backed classification metrics."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self.cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update(self, logits_or_preds, targets) -> None:
        arr = np.asarray(logits_or_preds)
        preds = arr.argmax(-1) if arr.ndim == 2 else arr
        self.cm += confusion_matrix(preds, np.asarray(targets), self.num_classes)

    def update_cm(self, cm_counts) -> None:
        """Add precomputed [C, C] counts (rows = true class) — the
        device-side accumulation path (``train/steps.py::make_eval_step``)."""
        cm = np.asarray(cm_counts, np.float64)
        if cm.shape != (self.num_classes, self.num_classes):
            raise ValueError(f"cm shape {cm.shape} != C={self.num_classes}")
        self.cm += cm

    def compute(self) -> Dict[str, float]:
        cm = self.cm
        tp = np.diag(cm)
        fp = cm.sum(0) - tp
        fn = cm.sum(1) - tp
        total = cm.sum()
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
            rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
            f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
        return {
            "accuracy": float(tp.sum() / total) if total > 0 else 0.0,
            "precision_macro": float(prec.mean()),
            "recall_macro": float(rec.mean()),
            "f1_macro": float(f1.mean()),
        }

    def normalized_cm(self) -> np.ndarray:
        row = self.cm.sum(axis=1, keepdims=True)
        return np.divide(self.cm, row, out=np.zeros_like(self.cm), where=row > 0)
