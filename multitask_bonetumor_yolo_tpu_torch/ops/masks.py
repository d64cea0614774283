"""Batched instance-mask composition: NMS-selected coefficients x prototypes.

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/masks.py``: gather the
per-anchor coefficients at the NMS keep indices, one batched matmul against
the prototypes, sigmoid, optional crop-to-box at prototype resolution,
optional bilinear upsample to the input size. Invalid slots are all-zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from .nms import NMSResult
from .resize import resize_bilinear_nchw


def compose_masks(
    coeffs: torch.Tensor,  # [B, A, nm]
    protos: torch.Tensor,  # [B, Hp, Wp, nm] (NHWC)
    nms: NMSResult,
    crop: bool = True,
    img_size: Optional[int] = None,
    binarize: bool = False,
) -> torch.Tensor:
    """Per-instance sigmoid masks [B, K, Hp, Wp] (or [B, K, S, S] with
    ``img_size``), float32 in [0, 1], or bool if ``binarize``."""
    b, _, nm = coeffs.shape
    hp, wp = protos.shape[1], protos.shape[2]
    valid = nms.valid

    idx = nms.indices.clamp(min=0).long()  # invalid -> anchor 0, masked below
    sel = torch.gather(coeffs.float(), 1, idx[..., None].expand(-1, -1, nm))
    sel = torch.where(valid[..., None], sel, 0.0)

    flat = protos.float().reshape(b, hp * wp, nm)
    logits = torch.einsum("bkc,bpc->bkp", sel, flat).reshape(b, -1, hp, wp)
    masks = torch.where(valid[..., None, None], torch.sigmoid(logits), 0.0)

    if crop:
        if img_size is None:
            raise ValueError("crop=True requires img_size to scale boxes")
        bx = nms.boxes.float() * (float(hp) / float(img_size))
        dev = masks.device
        ys = torch.arange(hp, dtype=torch.float32, device=dev)[None, None, :, None] + 0.5
        xs = torch.arange(wp, dtype=torch.float32, device=dev)[None, None, None, :] + 0.5
        inside = (
            (xs >= bx[..., 0, None, None])
            & (xs <= bx[..., 2, None, None])
            & (ys >= bx[..., 1, None, None])
            & (ys <= bx[..., 3, None, None])
        )
        masks = torch.where(inside, masks, 0.0)

    if img_size is not None and (hp != img_size or wp != img_size):
        k = masks.shape[1]
        up = resize_bilinear_nchw(masks.reshape(b * k, 1, hp, wp), img_size, img_size)
        masks = up.reshape(b, k, img_size, img_size)

    if binarize:
        return masks > 0.5
    return masks
