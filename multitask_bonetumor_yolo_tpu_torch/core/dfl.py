"""Distribution Focal Loss (counterpart of the JAX ``core/dfl.py``): decode
(softmax over ``reg_max`` bins, then the expectation against
arange(reg_max)) and the two-bin interpolated targets of the loss."""

from __future__ import annotations

from typing import Tuple

import torch


def dfl_decode(dist_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4, reg_max) logits -> (..., 4) expected ltrb distances (fp32)."""
    reg_max = dist_logits.shape[-1]
    probs = torch.softmax(dist_logits.float(), dim=-1)
    project = torch.arange(reg_max, dtype=torch.float32, device=probs.device)
    return (probs * project).sum(-1)


def dfl_targets(
    gt_ltrb: torch.Tensor, reg_max: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft two-bin targets for the DFL cross-entropy.

    gt_ltrb: (..., 4) distances already clipped to [0, reg_max - 1.01].
    Returns (tl, tr, wl, wr): int64 bins (floor and ceil) and fp32 weights.
    """
    tl = torch.floor(gt_ltrb).clamp(0, reg_max - 1).long()
    tr = (tl + 1).clamp(0, reg_max - 1)
    wl = tr.float() - gt_ltrb
    wr = gt_ltrb - tl.float()
    return tl, tr, wl, wr
