"""Validation metrics of the training loop (counterpart of the evaluation half
of the JAX ``train/loop.py``): ``ExperimentConfig``, the mAP input builders
and ``ValidationMetrics``. The ``Trainer`` is not ported yet.

``ValidationMetrics`` keeps each batch's small aux (losses, NMS result,
segmentation counts and scores, class logits, confusion-matrix counts) on
the device as the eval step returns it, and moves it all to the host in one
copy when :meth:`ValidationMetrics.compute` runs: one wait for the device per
pass, where reading each batch would wait once per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import DataConfig
from ..data.preprocess import AugmentConfig
from ..losses import LossConfig
from ..metrics import BinarySegMetrics, ClassificationMetrics, MeanAveragePrecision
from ..metrics.segmentation import mask_map_inputs_from_counts
from ..models import ModelConfig
from .state import TrainConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    augment: AugmentConfig = AugmentConfig()
    run_dir: str = "runs/default"
    log_every: int = 10
    viz_every_epochs: int = 50  # mask/box overlay cadence (reference: 50)
    wandb_project: Optional[str] = None

    def __post_init__(self):
        if not self.model.img_size == self.data.img_size == self.loss.img_size:
            raise ValueError("img_size must match across model/data/loss configs")


def gt_to_map_targets(boxes: np.ndarray, valid: np.ndarray, img_size: int):
    """Padded GT -> per-image mAP target dicts (xyxy absolute, clamped —
    running_main_v3.py:560-570)."""
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i].astype(bool)
        b = boxes[i][v]
        xyxy = np.stack(
            [
                (b[:, 1] - b[:, 3] / 2) * img_size,
                (b[:, 2] - b[:, 4] / 2) * img_size,
                (b[:, 1] + b[:, 3] / 2) * img_size,
                (b[:, 2] + b[:, 4] / 2) * img_size,
            ],
            axis=-1,
        ).clip(0, img_size) if len(b) else np.zeros((0, 4), np.float32)
        out.append(dict(boxes=xyxy, labels=b[:, 0].astype(np.int64)))
    return out


def nms_to_map_preds(aux: Dict[str, np.ndarray]):
    """Batched NMS output -> per-image mAP pred dicts."""
    out = []
    boxes = np.asarray(aux["nms_boxes"])
    scores = np.asarray(aux["nms_scores"])
    labels = np.asarray(aux["nms_labels"])
    valid = np.asarray(aux["nms_valid"]).astype(bool)
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append(dict(boxes=boxes[i][v], scores=scores[i][v],
                        labels=labels[i][v].astype(np.int64)))
    return out


def _to_host(pending: list) -> list:
    """The tensors of ``pending`` (a list of dicts of tensors on one device)
    as numpy arrays, in one device-to-host copy: each is flattened into one
    fp64 buffer (exact for the bools, the int32/int64 counts below 2^53 and
    the fp32 values the eval step returns) and cast back on the host."""
    tensors = [t for d in pending for t in d.values()]
    if not tensors:
        return [{} for _ in pending]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for d in pending:
        host = {}
        for k, t in d.items():
            n = t.numel()
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            host[k] = flat[off:off + n].reshape(tuple(t.shape)).astype(dtype)
            off += n
        out.append(host)
    return out


class ValidationMetrics:
    """Bundles every accumulator the reference's validation epoch keeps."""

    # the aux keys the accumulators read; seg_prob and seg_mask stay on the
    # device for the overlays
    SMALL_AUX = ("seg_counts", "seg_score", "cls_logits", "cm_counts", "nms_boxes",
                 "nms_scores", "nms_labels", "nms_valid")

    def __init__(self, cfg: ExperimentConfig, class_metrics: bool = False,
                 max_det_thresholds=None):
        """``max_det_thresholds`` mirrors the reference's --map_thresholds
        rebuild of its mAP metrics (evaluate_model.py:81-94); defaults to
        the train-loop [1, 10, eval_top_k]."""
        self.cfg = cfg
        mdt = list(max_det_thresholds or [1, 10, cfg.train.eval_top_k])
        self.seg = BinarySegMetrics()
        self.cls = ClassificationMetrics(cfg.model.nc_img)
        self.det_cm = ClassificationMetrics(cfg.model.nc_det)
        self.map50 = MeanAveragePrecision(iou_thresholds=[0.5], max_detection_thresholds=mdt,
                                          class_metrics=class_metrics)
        self.map50_95 = MeanAveragePrecision(max_detection_thresholds=mdt,
                                             class_metrics=class_metrics)
        self.seg_map = MeanAveragePrecision(iou_type="segm")
        self.losses: Dict[str, list] = {}
        self._pending: list = []  # (device dict, host dict) per batch

    def update(self, metrics, aux, batch) -> None:
        """One eval step's ``metrics`` and ``aux`` (device tensors, kept as
        they are) and its host ``batch`` (numpy: ``img_cls``, ``boxes``,
        ``box_valid``, ``sample_valid``, which trims a ``pad_last`` batch's
        replicas)."""
        sv = np.asarray(batch.get("sample_valid", np.ones(len(batch["img_cls"]), bool))).astype(bool)
        small = {k: aux[k] for k in self.SMALL_AUX}
        small.update({f"m:{k}": v for k, v in metrics.items()})
        host = {"sv": sv, "img_cls": np.asarray(batch["img_cls"]),
                "boxes": np.asarray(batch["boxes"]), "box_valid": np.asarray(batch["box_valid"])}
        self._pending.append((small, host))

    def _drain(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for d, (_, host) in zip(_to_host([small for small, _ in pending]), pending):
            metrics = {k[2:]: v for k, v in d.items() if k.startswith("m:")}
            small = {k: v for k, v in d.items() if not k.startswith("m:")}
            self._apply(metrics, small, host)

    def _apply(self, metrics, aux, host) -> None:
        sv = host["sv"]
        for k, v in metrics.items():
            self.losses.setdefault(k, []).append(float(v))
        counts = aux["seg_counts"][sv]
        self.seg.update_counts(counts)
        self.seg_map.update(*mask_map_inputs_from_counts(counts, aux["seg_score"][sv]))
        self.cls.update(aux["cls_logits"][sv], host["img_cls"][sv])
        self.det_cm.update_cm(aux["cm_counts"])
        preds = [p for p, ok in zip(nms_to_map_preds(aux), sv) if ok]
        targets = [t for t, ok in zip(gt_to_map_targets(host["boxes"], host["box_valid"],
                                                        self.cfg.model.img_size), sv) if ok]
        self.map50.update(preds, targets)
        self.map50_95.update(preds, targets)

    def compute(self, full_map: bool) -> Dict[str, float]:
        self._drain()
        out = {f"{k}": float(np.mean(v)) for k, v in self.losses.items()}
        out.update({f"seg_{k}": v for k, v in self.seg.compute().items()})
        out.update({f"seg_map_{k}": v for k, v in self.seg_map.compute().items()
                    if isinstance(v, (int, float))})
        out.update({f"img_{k}": v for k, v in self.cls.compute().items()})
        m50 = self.map50.compute()
        out.update({f"map_iou50_{k}": v for k, v in m50.items() if isinstance(v, (int, float))})
        if "map_per_class" in m50:
            for i, ap in enumerate(np.asarray(m50["map_per_class"]).ravel()):
                cls_id = int(np.asarray(m50["classes"]).ravel()[i])
                out[f"map_iou50_class_detC{cls_id}"] = float(ap)
        if full_map:
            m = self.map50_95.compute()
            out.update({f"map_iou50_95_{k}": v for k, v in m.items()
                        if isinstance(v, (int, float))})
        return out
