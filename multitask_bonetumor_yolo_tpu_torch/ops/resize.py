"""Bilinear and nearest resize with half-pixel centers (counterpart of the
JAX ``ops/resize.py``).

``F.interpolate(mode="bilinear", align_corners=False, antialias=False)`` is
the convention ``jax.image.resize(..., antialias=False)`` follows in the JAX
package (pinned against torch by ``tests/test_resize.py``), for the BiFPN
2x / 0.5x paths, the seg-logit upsample and the mosaic's 2x downscale.

``jax.image.resize(method="nearest")`` samples at half-pixel centers too:
output index i reads source index floor((i + 0.5) * in / out), so a 2x
downscale takes 2i + 1 (``F.interpolate``'s ``"nearest"`` takes 2i; its
``"nearest-exact"`` has the rule but multiplies by in / out rounded to
fp32, which lands one index low where (i + 0.5) * in / out is a whole
number and in / out is not exact in fp32, e.g. 10 -> 3). :func:`resize_nearest`
computes the indices as JAX does, in fp32, and gathers.
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


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """JAX's source indices: floor(((i + 0.5) * n_in) / n_out) in fp32."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long().clamp_(max=n_in - 1)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC (or HWC) nearest resize, JAX's half-pixel-centre indices, any
    dtype (a gather: the values are copied, never converted)."""
    h, w = x.shape[-3], x.shape[-2]
    if out_h != h:
        x = x.index_select(x.dim() - 3, _nearest_index(h, out_h, x.device))
    if out_w != w:
        x = x.index_select(x.dim() - 2, _nearest_index(w, out_w, x.device))
    return x
