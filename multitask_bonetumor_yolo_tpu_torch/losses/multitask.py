"""The five-term multitask loss (counterpart of the JAX ``losses/multitask.py``).

Image-class softmax CE (mean), segmentation BCE (mean over pixels), and three
detection terms over the anchors assigned to ground truth: box IoU, DFL, and
class BCE, normalised by the batch's positives (or the assigner's target
sum). Two assigners, as in the JAX package:

  * ``"reference"`` (the parity default): an anchor is positive when its
    decoded prediction overlaps a GT box by more than ``iou_match_thresh``;
    hard (label-smoothed in training) class targets.
  * ``"tal"``: task-aligned assignment (TOOD / YOLOv8): per GT the top-k
    center-inside anchors by score^alpha * IoU^beta, soft class targets, on
    predictions detached from the graph (JAX ``stop_gradient``).

GT comes padded: ``boxes`` [B, M, 5] = (cls, xc, yc, w, h) normalised to
[0, 1], ``box_valid`` [B, M]; ``mask`` [B, S, S, 1]; ``img_cls`` [B].
Nothing here waits for the device: every data-dependent choice is a
``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core.anchors import make_anchors
from ..core.boxes import box_cxcywh_to_xyxy, box_iou_matrix, dist2bbox
from ..core.dfl import dfl_decode, dfl_targets


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The JAX ``LossConfig``'s fields and defaults."""

    img_size: int = 640
    nc_det: int = 2
    reg_max: int = 16
    iou_match_thresh: float = 0.5
    weight_seg: float = 1.0
    weight_box_iou: float = 7.5
    weight_dfl: float = 1.5
    weight_cls_det: float = 0.5
    weight_img_cls: float = 1.0
    det_label_smoothing: float = 0.1
    strides: Sequence[int] = (8, 16, 32)
    assigner: str = "reference"  # "reference" | "tal"
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0


class LossOutput(NamedTuple):
    total: torch.Tensor
    components: Dict[str, torch.Tensor]  # seg, box_iou, dfl, cls_det, img_cls
    num_pos: torch.Tensor  # scalar: positive anchors in the batch
    avg_iou: torch.Tensor  # scalar: mean IoU of the positives
    matched_mask: torch.Tensor  # [B, A] bool
    matched_pred_cls: torch.Tensor  # [B, A] int32 argmax of the class logits
    matched_gt_cls: torch.Tensor  # [B, A] int32 class of the assigned GT


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the JAX formula)."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE with integer labels: logsumexp(x) - x[label]."""
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def flatten_det_levels(det_feats: Sequence[torch.Tensor], reg_max: int):
    """Per-level NHWC raw maps -> ([B, A, 4, reg_max] distance logits,
    [B, A, nc] class logits), fp32, levels concatenated stride-ascending."""
    b = det_feats[0].shape[0]
    flat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in det_feats], dim=1).float()
    dist = flat[..., : 4 * reg_max].reshape(b, flat.shape[1], 4, reg_max)
    return dist, flat[..., 4 * reg_max :]


def _assign_tal(iou, det_cls_logits, gt_cls, gt_valid, gt_xyxy, anchor_abs, cfg):
    """Task-aligned assignment on detached inputs (JAX ``_assign_tal``).

    Returns (positive [B,A] bool, best_gt [B,A] int64, norm_t [B,A] fp32,
    avg_iou scalar)."""
    b, a, m = iou.shape
    iou_pos = iou.clamp(min=0.0)
    scores = torch.sigmoid(det_cls_logits.float())  # [B, A, nc]
    s_at_gt = scores.gather(-1, gt_cls.long()[:, None, :].expand(b, a, m))  # [B, A, M]
    ax, ay = anchor_abs[None, :, None, 0], anchor_abs[None, :, None, 1]
    inside = ((ax > gt_xyxy[:, None, :, 0]) & (ax < gt_xyxy[:, None, :, 2])
              & (ay > gt_xyxy[:, None, :, 1]) & (ay < gt_xyxy[:, None, :, 3]))
    cand = inside & gt_valid[:, None, :]
    align = torch.where(cand, (s_at_gt ** cfg.tal_alpha) * (iou_pos ** cfg.tal_beta), 0.0)

    # per-GT top-k over anchors (threshold form; zero-metric ties excluded)
    k = min(cfg.tal_topk, a)
    kth = torch.topk(align.transpose(1, 2), k, dim=-1).values[..., -1]  # [B, M]
    selected = (align >= kth[:, None, :]) & (align > 0)

    # anchors claimed by several GT keep the highest-IoU one
    best_gt = torch.where(selected, iou_pos, -1.0).argmax(-1)  # [B, A]
    positive = selected.any(-1)
    max_align = torch.where(selected, align, 0.0).amax(1)  # [B, M]
    max_iou = torch.where(selected, iou_pos, 0.0).amax(1)
    gt_scale = max_iou / max_align.clamp(min=1e-9)
    t_at = align.gather(-1, best_gt[..., None])[..., 0]
    norm_t = torch.where(positive, t_at * gt_scale.gather(1, best_gt), 0.0)

    iou_at = iou_pos.gather(-1, best_gt[..., None])[..., 0]
    pos_f = positive.float()
    npos = pos_f.sum()
    avg_iou = torch.where(npos > 0, (iou_at * pos_f).sum() / npos.clamp(min=1.0), 0.0)
    return positive, best_gt, norm_t, avg_iou


def multitask_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: LossConfig,
    train: bool = True,
) -> LossOutput:
    """``outputs``: the model's train-mode dict; ``batch``: the padded GT dict."""
    f32 = torch.float32
    cls_logits = outputs["cls_logits"].float()
    loss_img_cls = _softmax_ce(cls_logits, batch["img_cls"]).mean()
    loss_seg = _bce_with_logits(outputs["seg_logits"].float(), batch["mask"].to(f32)).mean()

    dist_logits, det_cls_logits = flatten_det_levels(outputs["det_feats"], cfg.reg_max)
    anchors, strides = make_anchors(cfg.img_size, cfg.strides, device=dist_logits.device)
    anchor_abs = anchors * strides  # [A, 2]
    ltrb = dfl_decode(dist_logits)  # [B, A, 4] grid units
    pred_xyxy = dist2bbox(ltrb * strides[None], anchor_abs[None])

    gt_valid = batch["box_valid"].bool()  # [B, M]
    gt_cls = batch["boxes"][..., 0].long()  # [B, M]
    gt_xyxy = box_cxcywh_to_xyxy(batch["boxes"][..., 1:5].to(f32)) * cfg.img_size

    iou = box_iou_matrix(pred_xyxy, gt_xyxy)  # [B, A, M]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    batch_size = pred_xyxy.shape[0]

    if cfg.assigner == "reference":
        pred_max_iou, best_gt = iou.max(-1)  # first index on ties, as jnp.argmax
        positive = pred_max_iou > cfg.iou_match_thresh
        pos_f = positive.float()
        num_pos = pos_f.sum()
        avg_factor = torch.where(num_pos > 0, num_pos, float(batch_size))
        loss_box_iou = ((1.0 - pred_max_iou) * pos_f).sum() / avg_factor
        avg_iou = torch.where(num_pos > 0, (pred_max_iou * pos_f).sum() / num_pos.clamp(min=1.0),
                              0.0)
        matched_gt_cls = gt_cls.gather(1, best_gt)
        one_hot = F.one_hot(matched_gt_cls, cfg.nc_det).to(f32)
        if train and cfg.det_label_smoothing > 0.0 and cfg.nc_det > 1:
            s = cfg.det_label_smoothing
            targets = torch.where(one_hot > 0, 1.0 - s, s / (cfg.nc_det - 1))
        else:
            targets = one_hot
        bce = _bce_with_logits(det_cls_logits, targets).sum(-1)  # [B, A]
        loss_cls_det = (bce * pos_f).sum() / avg_factor
        box_w = pos_f
        dfl_norm = avg_factor
    elif cfg.assigner == "tal":
        positive, best_gt, norm_t, avg_iou = _assign_tal(
            iou.detach(), det_cls_logits.detach(), gt_cls, gt_valid, gt_xyxy, anchor_abs, cfg
        )
        pos_f = positive.float()
        num_pos = pos_f.sum()
        matched_gt_cls = gt_cls.gather(1, best_gt)
        one_hot = F.one_hot(matched_gt_cls, cfg.nc_det).to(f32)
        targets = one_hot * (norm_t * pos_f)[..., None]
        target_sum = targets.sum().clamp(min=1.0)
        loss_cls_det = _bce_with_logits(det_cls_logits, targets).sum() / target_sum
        iou_at_assigned = iou.gather(-1, best_gt[..., None])[..., 0]
        box_w = norm_t
        loss_box_iou = ((1.0 - iou_at_assigned) * box_w).sum() / target_sum
        dfl_norm = target_sum
    else:
        raise ValueError(f"unknown assigner {cfg.assigner!r}")

    # DFL: two-bin interpolated CE per ltrb side, weighted by box_w
    matched_gt_xyxy = gt_xyxy.gather(1, best_gt[..., None].expand(-1, -1, 4))  # [B, A, 4]
    gt_ltrb = torch.cat([anchor_abs[None] - matched_gt_xyxy[..., :2],
                         matched_gt_xyxy[..., 2:] - anchor_abs[None]], dim=-1) / strides[None]
    gt_ltrb = gt_ltrb.clamp(0.0, cfg.reg_max - 1.01)
    tl, tr, wl, wr = dfl_targets(gt_ltrb, cfg.reg_max)
    lse = torch.logsumexp(dist_logits, dim=-1)  # [B, A, 4]
    logit_tl = dist_logits.gather(-1, tl[..., None])[..., 0]
    logit_tr = dist_logits.gather(-1, tr[..., None])[..., 0]
    dfl = (lse - logit_tl) * wl + (lse - logit_tr) * wr
    loss_dfl = (dfl.sum(-1) * box_w).sum() / dfl_norm

    total = (cfg.weight_seg * loss_seg + cfg.weight_box_iou * loss_box_iou
             + cfg.weight_dfl * loss_dfl + cfg.weight_cls_det * loss_cls_det
             + cfg.weight_img_cls * loss_img_cls)
    return LossOutput(
        total=total,
        components={"seg": loss_seg, "box_iou": loss_box_iou, "dfl": loss_dfl,
                    "cls_det": loss_cls_det, "img_cls": loss_img_cls},
        num_pos=num_pos,
        avg_iou=avg_iou,
        matched_mask=positive,
        matched_pred_cls=det_cls_logits.argmax(-1).to(torch.int32),
        matched_gt_cls=matched_gt_cls.to(torch.int32),
    )
