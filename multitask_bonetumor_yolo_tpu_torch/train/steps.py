"""The train and eval steps (counterpart of the JAX ``train/steps.py``).

Train step: forward with ``train=True, mode="train"``, the five-term loss,
the backward (through K1's residual-saving form and K2 on the kernel stages,
autograd of the eager blocks elsewhere, as ``ModelConfig.block_bwd`` picks),
then the clipped AdamW step with the non-finite skip (``state.py``). Nothing
in it waits for the device: metrics come back as device scalars.

Eval step: the reference's validation forward (``train=False,
mode="train"``: body BN on running statistics, head BN on the batch's), the
loss with ``train=False``, decode and NMS at the config's eval thresholds,
and the segmentation and confusion-matrix summaries, all on the device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data.preprocess import AugmentConfig, augment_batch, normalize
from ..losses import LossConfig, multitask_loss
from ..models import ModelConfig
from ..models.heads import decode_detections
from ..ops.nms import postprocess_detections
from .state import TrainConfig, TrainState


def make_train_step(model_cfg: ModelConfig, loss_cfg: LossConfig,
                    aug_cfg: AugmentConfig = AugmentConfig()) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics, aux)``, with
    the JAX step's metric keys (``loss_total``, ``loss_{seg,box_iou,dfl,
    cls_det,img_cls}``, ``num_pos``, ``avg_iou``, ``grad_norm``,
    ``step_skipped``) and aux (``cls_logits``, ``seg_prob``, ``image``).
    ``batch``: uint8 ``image`` [B, S, S, 3] and the padded GT of
    ``multitask_loss``, on the model's device. ``state`` is updated in place
    and returned."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        if state.model.cfg != model_cfg:
            raise ValueError("train_step: the state's model was built from another ModelConfig")
        batch = augment_batch(batch, generator, aug_cfg)
        params = state.params()
        bn_before = state.bn_snapshot()
        out = state.model(batch["image"], train=True, mode="train")
        lo = multitask_loss(out, batch, loss_cfg, train=True)
        grads = torch.autograd.grad(lo.total, params, allow_unused=True)
        grad_norm, ok = state.apply_gradients(grads, bn_before)
        metrics = {
            "loss_total": lo.total,
            **{f"loss_{k}": v for k, v in lo.components.items()},
            "num_pos": lo.num_pos,
            "avg_iou": lo.avg_iou,
            "grad_norm": grad_norm,
            "step_skipped": 1.0 - ok.float(),
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        aux = {
            "cls_logits": out["cls_logits"].detach(),
            "seg_prob": torch.sigmoid(out["seg_logits"].detach()),
            "image": batch["image"],
        }
        return state, metrics, aux

    return train_step


def make_eval_step(model_cfg: ModelConfig, loss_cfg: LossConfig,
                   train_cfg: TrainConfig) -> Callable:
    """``eval_step(state, batch) -> (metrics, aux)``, with the JAX step's keys:
    metrics ``loss_total`` and ``loss_{seg,box_iou,dfl,cls_det,img_cls}``;
    aux ``nms_{boxes,scores,labels,valid}`` (NMS at ``train_cfg``'s
    ``eval_conf_thresh``, ``eval_nms_iou``, ``eval_top_k``), ``seg_prob``
    [B, S, S, 1], ``seg_mask`` [B, S, S] (prob > 0.5), ``seg_score`` [B]
    (mean probability over the predicted foreground), ``seg_counts`` [B, 4]
    (tp, fp, fn, tn pixels against ``mask > 0.5``), ``cls_logits`` and
    ``cm_counts`` [nc, nc] (rows the matched GT class, columns the predicted
    class, over the assigner's positives of the samples that
    ``sample_valid`` marks). Everything stays on the model's device.

    The head BNs normalise with the batch's statistics, so a sample's
    outputs depend on the rest of its batch. The running statistics keep
    their values: the forward's updates are put back (JAX discards them)."""

    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.model.cfg != model_cfg:
            raise ValueError("eval_step: the state's model was built from another ModelConfig")
        with torch.inference_mode():
            bn_before = state.bn_snapshot()
            batch = {**batch, "image": normalize(batch["image"])}
            out = state.model(batch["image"], train=False, mode="train")
            state.bn_restore(bn_before)
            lo = multitask_loss(out, batch, loss_cfg, train=False)
            det_preds = decode_detections(out["det_feats"], model_cfg.nc_det,
                                          model_cfg.img_size, model_cfg.reg_max)
            nms = postprocess_detections(det_preds, model_cfg.img_size,
                                         iou_thresh=train_cfg.eval_nms_iou,
                                         conf_thresh=train_cfg.eval_conf_thresh,
                                         top_k=train_cfg.eval_top_k)
            metrics = {"loss_total": lo.total,
                       **{f"loss_{k}": v for k, v in lo.components.items()}}
            prob = torch.sigmoid(out["seg_logits"])[..., 0]
            pm = prob > 0.5
            pos = batch["mask"][..., 0] > 0.5
            px = (1, 2)
            counts = torch.stack([(pm & pos).sum(px), (pm & ~pos).sum(px),
                                  (~pm & pos).sum(px), (~pm & ~pos).sum(px)], dim=-1)
            score = (prob * pm).sum(px) / (pm.sum(px) + 1e-6)
            cm_mask = lo.matched_mask
            if "sample_valid" in batch:
                cm_mask = cm_mask & batch["sample_valid"].bool()[:, None]
            nc = model_cfg.nc_det
            cm_idx = (lo.matched_gt_cls.long() * nc + lo.matched_pred_cls.long()).reshape(-1)
            cm_counts = torch.zeros(nc * nc, dtype=torch.int64, device=cm_idx.device).index_add_(
                0, cm_idx, cm_mask.reshape(-1).long()).view(nc, nc)
            aux = {
                "nms_boxes": nms.boxes,
                "nms_scores": nms.scores,
                "nms_labels": nms.labels,
                "nms_valid": nms.valid,
                "seg_prob": prob[..., None],
                "seg_mask": pm,
                "seg_score": score,
                "seg_counts": counts,
                "cls_logits": out["cls_logits"],
                "cm_counts": cm_counts,
            }
        return metrics, aux

    return eval_step
