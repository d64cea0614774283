"""A seeded synthetic train batch, made on the generator's device."""

from __future__ import annotations

from typing import Dict

import torch


def synthetic_batch(b: int, img: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """``b`` uint8 images ``[b, img, img, 3]`` with 3 random boxes each
    (normalised (cls, xc, yc, w, h) in 8 padded slots, sides 0.1-0.4, centres
    0.25-0.75), their union as a box-shaped mask, and random image classes:
    the keys ``make_train_step`` and ``multitask_loss`` read."""
    dev, n, slots = gen.device, 3, 8
    boxes = torch.zeros(b, slots, 5, device=dev)
    boxes[:, :n, 0] = torch.randint(0, 2, (b, n), generator=gen, device=dev).float()
    boxes[:, :n, 1:3] = torch.rand(b, n, 2, generator=gen, device=dev) * 0.5 + 0.25
    boxes[:, :n, 3:5] = torch.rand(b, n, 2, generator=gen, device=dev) * 0.3 + 0.1
    valid = torch.zeros(b, slots, dtype=torch.bool, device=dev)
    valid[:, :n] = True
    pix = (torch.arange(img, device=dev).float() + 0.5) / img
    lo = boxes[:, :n, 1:3] - boxes[:, :n, 3:5] / 2
    hi = boxes[:, :n, 1:3] + boxes[:, :n, 3:5] / 2
    in_x = (pix > lo[..., 0:1]) & (pix < hi[..., 0:1])
    in_y = (pix > lo[..., 1:2]) & (pix < hi[..., 1:2])
    mask = (in_y[..., :, None] & in_x[..., None, :]).any(1).float()[..., None]
    return {
        "image": torch.randint(0, 256, (b, img, img, 3), generator=gen, device=dev,
                               dtype=torch.uint8),
        "boxes": boxes, "box_valid": valid, "mask": mask,
        "img_cls": torch.randint(0, 2, (b,), generator=gen, device=dev),
    }
