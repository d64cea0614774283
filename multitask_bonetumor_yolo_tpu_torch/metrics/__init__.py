"""Metrics: COCO-style mAP (bbox + segm), binary segmentation stats,
classification accuracy / macro-PRF / confusion matrices (counterpart of the
JAX ``metrics/``): host-side numpy accumulators with torchmetrics-compatible
output keys, fed by the eval step's device outputs."""

from .detection import MeanAveragePrecision
from .segmentation import BinarySegMetrics
from .classification import ClassificationMetrics, confusion_matrix

__all__ = [
    "MeanAveragePrecision",
    "BinarySegMetrics",
    "ClassificationMetrics",
    "confusion_matrix",
]
