"""Box coordinate transforms and IoU (counterpart of the JAX ``core/boxes.py``).

The arithmetic follows the JAX functions operation for operation, so that
IoU values at an NMS threshold compare equal on the same inputs.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-x, center-y, w, h -> x1, y1, x2, y2."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1
    )


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) x1, y1, x2, y2 -> cx, cy, w, h."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def box_iou_matrix(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a = boxes1.unsqueeze(-2)
    b = boxes2.unsqueeze(-3)
    inter_x1 = torch.maximum(a[..., 0], b[..., 0])
    inter_y1 = torch.maximum(a[..., 1], b[..., 1])
    inter_x2 = torch.minimum(a[..., 2], b[..., 2])
    inter_y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (inter_x2 - inter_x1).clamp(min=0) * (inter_y2 - inter_y1).clamp(min=0)
    area1 = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area2 = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area1 + area2 - inter
    return inter / (union + eps)


def box_iou_pairwise(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """Elementwise IoU of aligned xyxy boxes: (..., 4) x (..., 4) -> (...)."""
    inter_x1 = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    inter_y1 = torch.maximum(boxes1[..., 1], boxes2[..., 1])
    inter_x2 = torch.minimum(boxes1[..., 2], boxes2[..., 2])
    inter_y2 = torch.minimum(boxes1[..., 3], boxes2[..., 3])
    inter = (inter_x2 - inter_x1).clamp(min=0) * (inter_y2 - inter_y1).clamp(min=0)
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    return inter / (area1 + area2 - inter + eps)


def dist2bbox(
    distance: torch.Tensor, anchor_points: torch.Tensor, box_format: str = "xyxy"
) -> torch.Tensor:
    """Decode (l, t, r, b) distances from anchor points into boxes."""
    lt, rb = distance[..., :2], distance[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if box_format == "xyxy":
        return torch.cat([x1y1, x2y2], dim=-1)
    if box_format == "xywh":
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1)
    raise NotImplementedError(f"box_format {box_format!r}")


def bbox2dist(
    anchor_points: torch.Tensor,
    boxes_xyxy: torch.Tensor,
    reg_max: int,
    clamp_hi_delta: float = 1.01,
) -> torch.Tensor:
    """Inverse of :func:`dist2bbox`: ltrb distances of ``boxes_xyxy`` from
    ``anchor_points``, clipped to [0, reg_max - clamp_hi_delta] (the DFL
    target range; callers pass stride-normalised anchors and boxes)."""
    lt = anchor_points - boxes_xyxy[..., :2]
    rb = boxes_xyxy[..., 2:] - anchor_points
    return torch.cat([lt, rb], dim=-1).clamp(0.0, reg_max - clamp_hi_delta)
