"""Distribution Focal Loss decode (counterpart of the JAX ``core/dfl.py``):
softmax over ``reg_max`` bins, then the expectation against arange(reg_max)."""

from __future__ import annotations

import torch


def dfl_decode(dist_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4, reg_max) logits -> (..., 4) expected ltrb distances (fp32)."""
    reg_max = dist_logits.shape[-1]
    probs = torch.softmax(dist_logits.float(), dim=-1)
    project = torch.arange(reg_max, dtype=torch.float32, device=probs.device)
    return (probs * project).sum(-1)
