"""Class-agnostic greedy NMS with a fixed-shape batched result.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/nms.py`` (reference decode:
conf filter -> class-agnostic NMS at IoU 0.6 -> top-100), in plain torch,
over the whole batch at once and on the tensors' device:

  1. drop candidates with score <= conf_thresh,
  2. sort each image's scores descending with a STABLE sort, so ties go to
     the lower anchor index (the order ``lax.top_k`` gives the JAX version),
  3. resolve the greedy keep-set block by block over the batch: inside a
     block of score-ordered candidates, iterate keep <- valid & !any(kept
     earlier with IoU > thr) to its fixed point (every fixed point of that
     map is the greedy solution; it is reached in at most chain-depth
     steps), then suppress every later candidate against the block's kept
     boxes,
  4. scatter the first ``top_k`` survivors of each image into fixed slots.

The keep-set equals unbounded greedy NMS. The host waits for the device once
per call (the longest candidate list sets the number of blocks) and once
every ``FIXED_POINT_CHECK`` iterations inside a block. Padded slots carry
score 0, label -1, box (0, 0, 0, 0) and index -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.boxes import box_cxcywh_to_xyxy, box_iou_matrix
from ..utils.profiling import count, span

BLOCK = 128  # candidates per block of the suppression loop
FIXED_POINT_CHECK = 4  # fixed-point iterations between convergence checks


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [B, top_k, 4] xyxy
    scores: torch.Tensor  # [B, top_k]
    labels: torch.Tensor  # [B, top_k] int32, -1 for padding
    valid: torch.Tensor  # [B, top_k] bool
    indices: torch.Tensor  # [B, top_k] int32 anchor index, -1 for padding


def _greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy keep-mask [B, K] over score-sorted candidates [B, K, 4]."""
    k = boxes.shape[1]
    keep = valid.clone()
    order = torch.arange(min(BLOCK, k), device=boxes.device)
    for start in range(0, k, BLOCK):
        end = min(start + BLOCK, k)
        t = end - start
        blk = boxes[:, start:end]
        # tri[:, j, i]: higher-ranked j can suppress i
        tri = (box_iou_matrix(blk, blk) > iou_thresh) & (order[:t, None] < order[None, :t])
        blk_valid = keep[:, start:end]
        cur = blk_valid
        for _ in range(0, t, FIXED_POINT_CHECK):
            for _ in range(FIXED_POINT_CHECK):
                prev = cur
                cur = blk_valid & ~(tri & cur[:, :, None]).any(1)
            count("nms.waits")
            with span("nms.wait"):
                converged = torch.equal(cur, prev)
            if converged:
                break
        keep[:, start:end] = cur
        if end < k:
            sup = ((box_iou_matrix(blk, boxes[:, end:]) > iou_thresh) & cur[:, :, None]).any(1)
            keep[:, end:] &= ~sup
    return keep


def batched_nms(
    boxes: torch.Tensor,  # [B, A, 4] xyxy
    scores: torch.Tensor,  # [B, A]
    labels: torch.Tensor,  # [B, A] int
    iou_thresh: float = 0.6,
    conf_thresh: float = 0.05,
    top_k: int = 100,
) -> NMSResult:
    """Class-agnostic greedy NMS over every candidate passing conf: the
    keep-set of unbounded greedy NMS, per image."""
    b = scores.shape[0]
    dev = boxes.device
    boxes = boxes.float()
    scores = scores.float()
    masked = torch.where(scores > conf_thresh, scores, -1.0)
    sorted_scores, order = torch.sort(masked, dim=1, descending=True, stable=True)
    cand_valid = sorted_scores > conf_thresh
    count("nms.waits")
    with span("nms.wait"):
        k = int(cand_valid.sum(1).max())  # the one wait per call
    count("nms.candidates", k)
    slot_idx = torch.full((b, top_k + 1), -1, dtype=torch.long, device=dev)
    if k > 0:
        order, cand_valid = order[:, :k], cand_valid[:, :k]
        cand_boxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
        keep = _greedy_keep(cand_boxes, cand_valid, iou_thresh)
        rank = keep.cumsum(1) - 1
        slot = torch.where(keep & (rank < top_k), rank, top_k)  # top_k: dropped
        slot_idx.scatter_(1, slot, order)
    idx = slot_idx[:, :top_k]
    valid = idx >= 0
    safe = idx.clamp(min=0)
    out_boxes = torch.where(valid[..., None],
                            boxes.gather(1, safe[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(valid, scores.gather(1, safe), 0.0)
    out_labels = torch.where(valid, labels.gather(1, safe).to(torch.int32), -1)
    return NMSResult(out_boxes, out_scores, out_labels.to(torch.int32), valid, idx.to(torch.int32))


def postprocess_detections(
    det_preds: torch.Tensor,  # [B, A, 4+nc] decoded xywh-abs + sigmoid scores
    img_size: int,
    iou_thresh: float = 0.6,
    conf_thresh: float = 0.05,
    top_k: int = 100,
) -> NMSResult:
    """Per-anchor best class, boxes clamped to [0, img_size], conf filter,
    class-agnostic NMS, top-K (the JAX ``postprocess_detections``)."""
    boxes_xyxy = box_cxcywh_to_xyxy(det_preds[..., :4].float()).clamp(0.0, float(img_size))
    cls_scores = det_preds[..., 4:].float()
    scores = cls_scores.amax(dim=-1)
    labels = cls_scores.argmax(dim=-1)  # first maximal class, as jnp.argmax
    return batched_nms(
        boxes_xyxy, scores, labels.to(torch.int32),
        iou_thresh=iou_thresh, conf_thresh=conf_thresh, top_k=top_k,
    )
