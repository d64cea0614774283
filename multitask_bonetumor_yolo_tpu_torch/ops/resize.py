"""Bilinear resize with half-pixel centers and no antialias.

``F.interpolate(mode="bilinear", align_corners=False, antialias=False)`` is
the convention ``jax.image.resize(..., antialias=False)`` follows in the JAX
package (``ops/resize.py``; pinned against torch by ``tests/test_resize.py``),
for the BiFPN 2x / 0.5x paths and the seg-logit upsample.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize (the port's internal layout)."""
    return F.interpolate(
        x, size=(out_h, out_w), mode="bilinear", align_corners=False,
        antialias=False,
    )


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC bilinear resize, the JAX function's public layout."""
    y = resize_bilinear_nchw(x.permute(0, 3, 1, 2), out_h, out_w)
    return y.permute(0, 2, 3, 1)
