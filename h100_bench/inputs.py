"""Inputs made from the seed, on the device, by the traffic file's
parameters.

``radiographs``: letterboxed uint8 canvases like the serving path's
(``cli/infer.py::load_and_letterbox``): an image of random aspect in the
top-left corner, grey 114 below or to the right of it. The image is a
synthetic radiograph: a vignetted background, a bright band at a random
angle (the bone), 1 to ``lesions`` bright ellipses and Gaussian noise.

``train_batches``: the train step's batch (a copy of the program's
``data/synthetic.py::synthetic_batch``): uniform noise images, ``boxes``
random boxes per image in ``slots`` padded slots (sides 0.1-0.4, centres
0.25-0.75), their union as a box-shaped mask, random image classes.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

PAD_VALUE = 114


def radiographs(n: int, size: int, gen: torch.Generator, p: Dict) -> torch.Tensor:
    """``n`` uint8 canvases [n, S, S, 3] on ``gen``'s device."""
    dev = gen.device
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    lo, hi = p["aspect"]
    aspect = lo + (hi - lo) * u(n)
    tall = u(n) < 0.5
    h_img = torch.where(tall, torch.ones(n, device=dev), aspect) * size
    w_img = torch.where(tall, aspect, torch.ones(n, device=dev)) * size
    r = (torch.arange(size, device=dev).float() + 0.5)
    yy, xx = r[None, :, None], r[None, None, :]
    cy, cx = h_img[:, None, None] / 2, w_img[:, None, None] / 2
    vig = 1.0 - 0.6 * (((xx - cx) / cx) ** 2 + ((yy - cy) / cy) ** 2).clamp(0, 1)
    img = 40.0 + 60.0 * vig
    ang = u(n)[:, None, None] * math.pi
    d = (xx - cx) * torch.sin(ang) - (yy - cy) * torch.cos(ang)
    img = img + 70.0 * torch.exp(-(d / (0.12 * torch.minimum(cx, cy) * 2)) ** 2)
    k = p["lesions"]
    count = 1 + (u(n) * k).long().clamp(max=k - 1)
    for j in range(k):
        ex = (0.15 + 0.7 * u(n))[:, None, None] * w_img[:, None, None]
        ey = (0.15 + 0.7 * u(n))[:, None, None] * h_img[:, None, None]
        rx = (0.03 + 0.12 * u(n))[:, None, None] * size
        ry = (0.03 + 0.12 * u(n))[:, None, None] * size
        inside = ((xx - ex) / rx) ** 2 + ((yy - ey) / ry) ** 2 <= 1.0
        inside &= (j < count)[:, None, None]
        img = torch.where(inside, 150.0 + 90.0 * u(n)[:, None, None], img)
    img = img + p["noise"] * torch.randn(n, size, size, generator=gen, device=dev)
    img = img.clamp(0, 255).round().to(torch.uint8)
    pad = (yy >= h_img[:, None, None].floor()) | (xx >= w_img[:, None, None].floor())
    img = torch.where(pad, torch.full_like(img, PAD_VALUE), img)
    return img[..., None].expand(n, size, size, 3).contiguous()


def train_batches(n: int, b: int, size: int, gen: torch.Generator,
                  p: Dict) -> List[Dict[str, torch.Tensor]]:
    return [_train_batch(b, size, gen, p["boxes"], p["slots"]) for _ in range(n)]


def _train_batch(b: int, img: int, gen: torch.Generator, n: int,
                 slots: int) -> Dict[str, torch.Tensor]:
    dev = gen.device
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
