"""The plain five-term multitask loss with the task-aligned assigner.

Image class: softmax cross-entropy, mean. Segmentation: BCE on the
upsampled mask logits, mean over pixels. Detection over the anchors the
assigner picks: box IoU, DFL and class BCE, each normalised by the sum of
the soft class targets (at least 1). The task-aligned assigner (TOOD /
YOLOv8): for each ground-truth box the top-k anchors whose centre lies
inside it, ranked by score^alpha * IoU^beta on detached predictions; an
anchor claimed by several boxes keeps the one it overlaps most; its soft
target is its metric rescaled so that each box's best anchor gets that
box's best IoU. ``assigner="reference"`` is the IoU-threshold assigner
with label smoothing.

Ground truth comes padded: ``boxes`` [B, M, 5] = (cls, xc, yc, w, h) in
[0, 1], ``box_valid`` [B, M], ``mask`` [B, S, S, 1], ``img_cls`` [B].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .model import anchors, dfl_decode, flatten_levels
from .post import iou_matrix

WEIGHTS = {"seg": 1.0, "box_iou": 7.5, "dfl": 1.5, "cls_det": 0.5, "img_cls": 1.0}
TERMS = ("total", *WEIGHTS)


def bce(logits, targets):
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def tal(iou, cls_logits, gt_cls, gt_valid, gt_xyxy, anchor_abs, topk=10, alpha=0.5, beta=6.0):
    b, a, m = iou.shape
    iou = iou.clamp(min=0.0)
    s_at_gt = torch.sigmoid(cls_logits).gather(-1, gt_cls[:, None, :].expand(b, a, m))
    ax, ay = anchor_abs[None, :, None, 0], anchor_abs[None, :, None, 1]
    inside = ((ax > gt_xyxy[:, None, :, 0]) & (ax < gt_xyxy[:, None, :, 2])
              & (ay > gt_xyxy[:, None, :, 1]) & (ay < gt_xyxy[:, None, :, 3]))
    align = torch.where(inside & gt_valid[:, None, :], s_at_gt ** alpha * iou ** beta, 0.0)
    kth = torch.topk(align.transpose(1, 2), min(topk, a), dim=-1).values[..., -1]
    selected = (align >= kth[:, None, :]) & (align > 0)
    best = torch.where(selected, iou, -1.0).argmax(-1)
    positive = selected.any(-1)
    scale = torch.where(selected, iou, 0.0).amax(1) / \
        torch.where(selected, align, 0.0).amax(1).clamp(min=1e-9)
    norm_t = torch.where(positive, align.gather(-1, best[..., None])[..., 0]
                         * scale.gather(1, best), 0.0)
    return positive, best, norm_t


def multitask_loss(out: Dict, batch: Dict, cfg: Dict, assigner: str = "tal",
                   label_smoothing: float = 0.1) -> Dict[str, torch.Tensor]:
    """The training loss of the model's ``mode="train"`` outputs; returns
    each term and ``total``."""
    s, nc, rm = cfg["img_size"], cfg["nc_det"], cfg["reg_max"]
    cls_logits = out["cls_logits"].float()
    labels = batch["img_cls"].long()
    loss_img = (torch.logsumexp(cls_logits, -1)
                - cls_logits.gather(-1, labels[:, None])[:, 0]).mean()
    loss_seg = bce(out["seg_logits"].float(), batch["mask"].float()).mean()

    x = flatten_levels(out["det_feats"]).float()
    b, a = x.shape[:2]
    dist = x[..., : 4 * rm].reshape(b, a, 4, rm)
    det_cls = x[..., 4 * rm:]
    pts, strides = anchors(s, x.device)
    anchor_abs = pts * strides
    ltrb = dfl_decode(dist) * strides
    pred = torch.cat([anchor_abs - ltrb[..., :2], anchor_abs + ltrb[..., 2:]], -1)

    gt_valid = batch["box_valid"].bool()
    gt_cls = batch["boxes"][..., 0].long()
    xc, yc, w, h = batch["boxes"][..., 1:5].float().unbind(-1)
    gt_xyxy = torch.stack([xc - w * 0.5, yc - h * 0.5, xc + w * 0.5, yc + h * 0.5], -1) * s
    iou = iou_matrix(pred, gt_xyxy)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)

    if assigner == "tal":
        positive, best, box_w = tal(iou.detach(), det_cls.detach(), gt_cls, gt_valid, gt_xyxy,
                                    anchor_abs)
        targets = F.one_hot(gt_cls.gather(1, best), nc).float() * box_w[..., None]
        norm = targets.sum().clamp(min=1.0)
        loss_cls = bce(det_cls, targets).sum() / norm
        loss_box = ((1.0 - iou.gather(-1, best[..., None])[..., 0]) * box_w).sum() / norm
    elif assigner == "reference":
        best_iou, best = iou.max(-1)
        box_w = (best_iou > 0.5).float()
        npos = box_w.sum()
        norm = torch.where(npos > 0, npos, float(b))
        one_hot = F.one_hot(gt_cls.gather(1, best), nc).float()
        if label_smoothing > 0 and nc > 1:
            one_hot = torch.where(one_hot > 0, 1.0 - label_smoothing,
                                  label_smoothing / (nc - 1))
        loss_cls = (bce(det_cls, one_hot).sum(-1) * box_w).sum() / norm
        loss_box = ((1.0 - best_iou) * box_w).sum() / norm
    else:
        raise ValueError(f"unknown assigner {assigner!r}")

    gt_m = gt_xyxy.gather(1, best[..., None].expand(-1, -1, 4))
    t = (torch.cat([anchor_abs - gt_m[..., :2], gt_m[..., 2:] - anchor_abs], -1) / strides)
    t = t.clamp(0.0, rm - 1.01)
    tl = t.floor().clamp(0, rm - 1).long()
    tr = (tl + 1).clamp(0, rm - 1)
    lse = torch.logsumexp(dist, -1)
    dfl = ((lse - dist.gather(-1, tl[..., None])[..., 0]) * (tr.float() - t)
           + (lse - dist.gather(-1, tr[..., None])[..., 0]) * (t - tl.float()))
    loss_dfl = (dfl.sum(-1) * box_w).sum() / norm

    terms = {"seg": loss_seg, "box_iou": loss_box, "dfl": loss_dfl, "cls_det": loss_cls,
             "img_cls": loss_img}
    terms["total"] = sum(WEIGHTS[k] * v for k, v in terms.items())
    return terms
