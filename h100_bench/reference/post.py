"""Plain decode stages after the model: greedy NMS and instance masks.

NMS: per image, the best class of each anchor; boxes xywh -> xyxy clamped
to the image; candidates with score > conf; a stable descending sort by
score (ties to the lower anchor index); then textbook greedy NMS, one
candidate at a time: keep it unless a kept candidate overlaps it with IoU >
``iou``; the first ``top_k`` kept fill the slots, the rest are -1 / 0.

Masks: the kept anchors' coefficients times the prototypes, sigmoid,
zeroed outside the box at prototype resolution (pixel centres), bilinear
to the image size; empty slots are zero.

``Precision.q`` rounds the box coordinates before the IoU and the operands
of the mask product (the control's bf16); the reference leaves them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import FP32, Precision


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4] xyxy
    scores: torch.Tensor  # [B, K]
    labels: torch.Tensor  # [B, K] int32, -1 empty
    valid: torch.Tensor  # [B, K] bool
    indices: torch.Tensor  # [B, K] int32 anchor, -1 empty


def iou_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a, b = a.unsqueeze(-2), b.unsqueeze(-3)
    w = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    h = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = w * h
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def boxes_scores(det_preds: torch.Tensor, img_size: int):
    """[B, A, 4 + nc] -> xyxy boxes clamped to the image, best score, its
    class (the first of equals)."""
    p = det_preds.float()
    cx, cy, w, h = p[..., :4].unbind(-1)
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)
    boxes = boxes.clamp(0.0, float(img_size))
    cls = p[..., 4:]
    return boxes, cls.amax(-1), cls.argmax(-1)


def nms(det_preds: torch.Tensor, img_size: int, conf: float, iou: float, top_k: int,
        precision: Precision = FP32) -> Detections:
    boxes, scores, labels = boxes_scores(det_preds, img_size)
    b = boxes.shape[0]
    idx = np.full((b, top_k), -1, np.int64)
    for i in range(b):
        s = scores[i].cpu().numpy()
        cand = np.nonzero(s > conf)[0]
        order = cand[np.argsort(-s[cand], kind="stable")]
        if order.size == 0:
            continue
        bx = precision.q(boxes[i, torch.as_tensor(order, device=boxes.device)])
        over = (iou_matrix(bx, bx) > iou).cpu().numpy()
        suppressed = np.zeros(order.size, bool)
        kept = []
        for j in range(order.size):
            if suppressed[j]:
                continue
            kept.append(j)
            if len(kept) == top_k:
                break
            suppressed |= over[j]
        idx[i, : len(kept)] = order[kept]
    ind = torch.as_tensor(idx, device=boxes.device)
    valid = ind >= 0
    safe = ind.clamp(min=0)
    gather = lambda t: t.gather(1, safe)  # noqa: E731
    out_boxes = torch.where(valid[..., None], boxes.gather(1, safe[..., None].expand(-1, -1, 4)),
                            0.0)
    return Detections(out_boxes, torch.where(valid, gather(scores), 0.0),
                      torch.where(valid, gather(labels), -1).to(torch.int32), valid,
                      ind.to(torch.int32))


def masks(coeffs: torch.Tensor, protos_nhwc: torch.Tensor, det, img_size: int,
          precision: Precision = FP32) -> torch.Tensor:
    """[B, K, S, S] float masks of the slots of ``det`` (anything with
    ``boxes``, ``valid`` and ``indices``)."""
    b, _, nm = coeffs.shape
    hp, wp = protos_nhwc.shape[1:3]
    valid = det.valid
    idx = det.indices.long().clamp(min=0)
    sel = coeffs.float().gather(1, idx[..., None].expand(-1, -1, nm))
    sel = torch.where(valid[..., None], sel, 0.0)
    flat = protos_nhwc.float().reshape(b, hp * wp, nm)
    logits = torch.einsum("bkc,bpc->bkp", precision.q(sel), precision.q(flat))
    m = torch.where(valid[..., None, None], torch.sigmoid(logits.reshape(b, -1, hp, wp)), 0.0)
    box = det.boxes.float() * (float(hp) / float(img_size))
    ys = torch.arange(hp, dtype=torch.float32, device=m.device)[None, None, :, None] + 0.5
    xs = torch.arange(wp, dtype=torch.float32, device=m.device)[None, None, None, :] + 0.5
    inside = ((xs >= box[..., 0, None, None]) & (xs <= box[..., 2, None, None])
              & (ys >= box[..., 1, None, None]) & (ys <= box[..., 3, None, None]))
    m = torch.where(inside, m, 0.0)
    k = m.shape[1]
    if (hp, wp) != (img_size, img_size):
        m = F.interpolate(m.reshape(b * k, 1, hp, wp), size=(img_size, img_size),
                          mode="bilinear", align_corners=False).reshape(b, k, img_size, img_size)
    return m
