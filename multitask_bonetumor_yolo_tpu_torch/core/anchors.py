"""Anchor-free grid for the 3 FPN levels (strides 8/16/32).

Counterpart of ``multitask_bonetumor_yolo_tpu/core/anchors.py``: anchor points
at (x + 0.5, y + 0.5) in grid units, levels concatenated stride-ascending,
each level flattened row-major over (H, W) — the NHWC flatten order the heads
use.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DEFAULT_STRIDES: Tuple[int, ...] = (8, 16, 32)


def level_shapes(img_size: int, strides: Sequence[int] = DEFAULT_STRIDES):
    """[(H_l, W_l)] for each FPN level of a square ``img_size`` input."""
    return [(img_size // s, img_size // s) for s in strides]


def make_anchors(
    img_size: int,
    strides: Sequence[int] = DEFAULT_STRIDES,
    offset: float = 0.5,
    device: torch.device | str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenated anchor points over all levels.

    Returns ``points`` (A, 2) float32 (x, y) in grid units and ``stride``
    (A, 1) float32, made on ``device`` (no host-to-device copy, which would
    wait for the device in the middle of a forward).
    """
    pts, strs = [], []
    for s in strides:
        n = img_size // s
        r = torch.arange(n, dtype=torch.float32, device=device) + offset
        ys, xs = torch.meshgrid(r, r, indexing="ij")
        pts.append(torch.stack([xs, ys], dim=-1).reshape(-1, 2))
        strs.append(torch.full((n * n, 1), float(s), device=device))
    return torch.cat(pts, 0), torch.cat(strs, 0)


def num_anchors(img_size: int, strides: Sequence[int] = DEFAULT_STRIDES) -> int:
    return sum((img_size // s) ** 2 for s in strides)
