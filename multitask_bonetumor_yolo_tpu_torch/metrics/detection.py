"""COCO-style mean-average-precision (bbox and segm), torchmetrics-compatible.

A copy of ``multitask_bonetumor_yolo_tpu/metrics/detection.py`` (numpy only):
importing it from the JAX package would import jax through its
``metrics/__init__.py``.

Replaces ``torchmetrics.detection.MeanAveragePrecision`` (pycocotools-backed;
used at the reference's running_main_v3.py:206-217) with a host-side numpy
implementation of the COCOeval algorithm:

  * greedy per-image matching, detections sorted by score, each detection
    takes the best still-unmatched GT with IoU >= threshold;
  * crowd/ignore handling is omitted (the BTXRD pipeline never produces
    iscrowd or ignore regions);
  * area-range evaluation marks out-of-range GT as ignored: detections matched
    to ignored GT are dropped from both TP and FP (COCOeval semantics);
  * AP = mean over 101-point interpolated precision at recalls 0:0.01:1,
    with precision made monotonically non-increasing from the right;
  * AR = mean best recall per IoU threshold with detections capped at maxDet;
  * scores averaged over classes present in GT; absent classes contribute -1
    and are excluded (COCO convention).

Performance (VERDICT r2 #3 — this accumulator dominated offline-eval wall
clock): IoU matrices and greedy matches are computed ONCE per (image, class,
area) at the largest maxDet and cached — smaller maxDets are exact prefixes
of the greedy match (detections are processed in score order, so a
detection's match never depends on later detections) — and the per-GT inner
loop is vectorised. Inputs may also carry PRECOMPUTED geometry summaries
(``ious`` + ``areas`` keys) so mask mAP can be fed from device-side scalar
reductions instead of shipping full-resolution masks to the host (see
metrics/segmentation.py:mask_map_inputs_from_counts).

Output keys mirror torchmetrics: map, map_50, map_75, map_small, map_medium,
map_large, mar_{d} for each max_detection_threshold, mar_small/medium/large,
map_per_class, mar_{maxdet}_per_class, classes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, float("inf")),
}
_REC_THRS = np.linspace(0.0, 1.0, 101)


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: [N,H,W] bool, b: [M,H,W] bool -> [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _greedy_match(
    iou: np.ndarray,  # [D, G] score-sorted detections
    gt_ignore: np.ndarray,  # [G] bool
    thrs: np.ndarray,  # [T]
    det_ignore_mask: np.ndarray,  # [D] bool (det area outside range)
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy COCO matching for every threshold. Semantics identical to the
    round-1 reference loop (oracle-fuzzed): a detection takes the best
    available GT with IoU >= thr, later GT wins IoU ties, a non-ignored GT
    is always preferred over an ignored one, and unmatched detections whose
    own area is out of range are ignored rather than counted as FP.
    Returns (tp [T, D], ign [T, D])."""
    D, G = iou.shape
    T = len(thrs)
    tp = np.zeros((T, D), bool)
    ign = np.zeros((T, D), bool)
    if D == 0:
        return tp, ign
    if G == 0:
        ign[:] = det_ignore_mask[None, :]
        return tp, ign
    nonign_g = ~gt_ignore
    for ti, thr in enumerate(thrs):
        taken = np.zeros(G, bool)
        for di in range(D):
            row = iou[di]
            ok = (~taken) & (row >= thr)
            cand = ok & nonign_g
            use_ign = False
            if not cand.any():
                cand = ok & gt_ignore
                use_ign = True
                if not cand.any():
                    continue
            vals = np.where(cand, row, -np.inf)
            mx = vals.max()
            gi = np.nonzero(vals == mx)[0][-1]  # later GT wins ties
            taken[gi] = True
            if use_ign:
                ign[ti, di] = True
            else:
                tp[ti, di] = True
        unmatched = ~(tp[ti] | ign[ti])
        ign[ti] |= unmatched & det_ignore_mask
    return tp, ign


class MeanAveragePrecision:
    """Accumulating COCO mAP. ``iou_type`` 'bbox' (xyxy) or 'segm' (bool
    masks). Per-image dicts may alternatively carry precomputed geometry:
    preds {'ious': [N, M_img], 'areas': [N], 'scores', 'labels'} and targets
    {'areas': [M_img], 'labels'} — used by the device-side mask-mAP path."""

    def __init__(
        self,
        iou_type: str = "bbox",
        iou_thresholds: Optional[Sequence[float]] = None,
        max_detection_thresholds: Sequence[int] = (1, 10, 100),
        class_metrics: bool = False,
    ):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type {iou_type!r}")
        self.iou_type = iou_type
        self.iou_thresholds = (
            np.asarray(iou_thresholds, np.float64)
            if iou_thresholds is not None
            else np.linspace(0.5, 0.95, 10)
        )
        self.max_dets = sorted(int(d) for d in max_detection_thresholds)
        self.class_metrics = class_metrics
        self.reset()

    def reset(self) -> None:
        self._preds: List[dict] = []
        self._targets: List[dict] = []
        self._img_cache: Dict[Tuple[int, int], tuple] = {}
        self._match_cache: Dict[Tuple[int, str], tuple] = {}

    def update(self, preds: Sequence[dict], targets: Sequence[dict]) -> None:
        """preds: per-image dicts with 'scores','labels' and 'boxes' (xyxy
        [N,4]) or 'masks' ([N,H,W] bool) or precomputed 'ious'+'areas'.
        targets: 'labels' + same geometry key (or 'areas'). Numpy arrays
        (or CPU tensors)."""
        if len(preds) != len(targets):
            raise ValueError("preds and targets must align per-image")
        for p, t in zip(preds, targets):
            self._preds.append({k: np.asarray(v) for k, v in p.items()})
            self._targets.append({k: np.asarray(v) for k, v in t.items()})
        self._img_cache.clear()
        self._match_cache.clear()

    # ------------------------------------------------------------------
    def _geometry(self, d: dict) -> np.ndarray:
        return d["masks"] if self.iou_type == "segm" else d["boxes"]

    def _areas(self, d: dict, sel: np.ndarray) -> np.ndarray:
        if "areas" in d:
            return np.asarray(d["areas"], np.float64)[sel]
        geom = self._geometry(d)[sel]
        if len(geom) == 0:
            return np.zeros((0,), np.float64)
        if self.iou_type == "segm":
            return geom.reshape(len(geom), -1).sum(1).astype(np.float64)
        return ((geom[:, 2] - geom[:, 0]) * (geom[:, 3] - geom[:, 1])).astype(
            np.float64
        )

    def _img_data(self, ii: int, cls: int):
        """Cached per-(image, class): score-sorted detections' scores, det
        areas, IoU matrix vs this class's GT, and GT areas."""
        key = (ii, cls)
        hit = self._img_cache.get(key)
        if hit is not None:
            return hit
        p, t = self._preds[ii], self._targets[ii]
        p_sel = np.asarray(p["labels"]) == cls
        t_sel = np.asarray(t["labels"]) == cls
        scores = np.asarray(p["scores"], np.float64)[p_sel]
        order = np.argsort(-scores, kind="stable")
        scores = scores[order]
        det_areas = self._areas(p, p_sel)[order]
        gt_areas = self._areas(t, t_sel)
        if "ious" in p:
            iou = np.asarray(p["ious"], np.float64)[p_sel][:, t_sel][order]
        else:
            geom_p = self._geometry(p)[p_sel][order]
            geom_t = self._geometry(t)[t_sel]
            iou = (
                _mask_iou(geom_p, geom_t)
                if self.iou_type == "segm"
                else _box_iou(geom_p, geom_t)
            )
        out = (scores, det_areas, iou, gt_areas)
        self._img_cache[key] = out
        return out

    def _matches(self, cls: int, area: str):
        """Cached per-(class, area): per-image (scores, tp [T,D], ign [T,D])
        at FULL detection depth, plus the in-range GT count. Any maxDet is
        an exact prefix of these."""
        key = (cls, area)
        hit = self._match_cache.get(key)
        if hit is not None:
            return hit
        lo, hi = _AREA_RANGES[area]
        per_img = []
        n_gt = 0
        for ii in range(len(self._preds)):
            scores, det_areas, iou, gt_areas = self._img_data(ii, cls)
            gt_ignore = (gt_areas < lo) | (gt_areas > hi)
            n_gt += int((~gt_ignore).sum())
            det_out = (det_areas < lo) | (det_areas > hi)
            tp, ign = _greedy_match(iou, gt_ignore, self.iou_thresholds, det_out)
            per_img.append((scores, tp, ign))
        out = (per_img, n_gt)
        self._match_cache[key] = out
        return out

    def _ap_ar_for(self, cls: int, area: str, max_det: int):
        """(AP[T], AR[T]) for one class/area/maxDet combo; -1 when no GT."""
        per_img, n_gt = self._matches(cls, area)
        T = len(self.iou_thresholds)
        if n_gt == 0:
            return np.full(T, -1.0), np.full(T, -1.0)
        scores = np.concatenate([s[:max_det] for s, _, _ in per_img])
        tp = np.concatenate([m[:, :max_det] for _, m, _ in per_img], axis=1)
        ign = np.concatenate([g[:, :max_det] for _, _, g in per_img], axis=1)
        order = np.argsort(-scores, kind="stable")
        tp, ign = tp[:, order], ign[:, order]
        ap = np.zeros(T)
        ar = np.zeros(T)
        for ti in range(T):
            keep = ~ign[ti]
            tps = np.cumsum(tp[ti][keep])
            fps = np.cumsum(~tp[ti][keep])
            rec = tps / n_gt
            prec = tps / np.maximum(tps + fps, 1e-9)
            ar[ti] = rec[-1] if len(rec) else 0.0
            # monotone precision from the right, sample at 101 recall points
            if len(prec):
                prec = np.maximum.accumulate(prec[::-1])[::-1]
                idx = np.searchsorted(rec, _REC_THRS, side="left")
                q = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
                ap[ti] = q.mean()
        return ap, ar

    def compute(self) -> Dict[str, float]:
        classes = sorted(
            {int(c) for t in self._targets for c in np.asarray(t["labels"]).ravel()}
            | {int(c) for p in self._preds for c in np.asarray(p["labels"]).ravel()}
        )
        T = len(self.iou_thresholds)
        max_det = self.max_dets[-1]

        def mean_valid(vals):
            vals = np.asarray(vals, np.float64)
            valid = vals > -1
            return float(vals[valid].mean()) if valid.any() else -1.0

        ap_all, ar_all = {}, {}
        per_class_ap, per_class_ar = [], []
        for cls in classes:
            ap, ar = self._ap_ar_for(cls, "all", max_det)
            ap_all[cls], ar_all[cls] = ap, ar
            per_class_ap.append(mean_valid(ap))
            per_class_ar.append(mean_valid(ar))

        out: Dict[str, float] = {}
        out["map"] = mean_valid([ap_all[c].mean() if (ap_all[c] > -1).all() else -1 for c in classes]) if classes else -1.0
        # per-threshold convenience keys when present
        for thr, key in ((0.5, "map_50"), (0.75, "map_75")):
            idx = np.where(np.isclose(self.iou_thresholds, thr))[0]
            if len(idx):
                out[key] = mean_valid([ap_all[c][idx[0]] for c in classes]) if classes else -1.0
            else:
                out[key] = -1.0
        for area in ("small", "medium", "large"):
            vals_ap, vals_ar = [], []
            for cls in classes:
                ap, ar = self._ap_ar_for(cls, area, max_det)
                vals_ap.append(mean_valid(ap))
                vals_ar.append(mean_valid(ar))
            out[f"map_{area}"] = mean_valid(vals_ap) if classes else -1.0
            out[f"mar_{area}"] = mean_valid(vals_ar) if classes else -1.0
        for d in self.max_dets:
            vals = []
            for cls in classes:
                _, ar = self._ap_ar_for(cls, "all", d)
                vals.append(mean_valid(ar))
            out[f"mar_{d}"] = mean_valid(vals) if classes else -1.0
        if self.class_metrics:
            out["map_per_class"] = np.asarray(per_class_ap)
            out[f"mar_{max_det}_per_class"] = np.asarray(per_class_ar)
        out["classes"] = np.asarray(classes, np.int32)
        return out
