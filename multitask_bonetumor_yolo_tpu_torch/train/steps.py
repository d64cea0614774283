"""The train step (counterpart of the JAX ``train/steps.py::make_train_step``).

Forward with ``train=True, mode="train"``, the five-term loss, the backward
(through K1's residual-saving form and K2 on the kernel stages, autograd of
the eager blocks elsewhere, as ``ModelConfig.block_bwd`` picks), then the
clipped AdamW step with the non-finite skip (``state.py``). Nothing in it
waits for the device: metrics come back as device scalars.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data.preprocess import AugmentConfig, augment_batch
from ..losses import LossConfig, multitask_loss
from ..models import ModelConfig
from .state import TrainState


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
