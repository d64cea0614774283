"""Fused 2x-transposed-conv + 3x3 conv (the Proto eval path).

Counterpart of ``multitask_bonetumor_yolo_tpu/ops/fused_upsample.py``.
``ConvTranspose2d(k=2, s=2)`` followed by a bias-free 3x3 SAME conv is linear
up to the BN/SiLU that follows, so it composes exactly into four 2x2 phase
convolutions at the LOW resolution plus a pixel shuffle.

In torch's layouts: the transposed conv places tap ``[a, b]`` of its weight
``kt [C, M, 2, 2]`` at output offset ``[a, b]``,
    z[2i+a, 2j+b] = x[i, j] @ kt[:, :, a, b] + bt,
and the 3x3 conv ``k3 [O, M, 3, 3]`` correlates,
    y[p, q] = sum_{u,v} z[p+u-1, q+v-1] @ k3[:, :, u, v].T.
Output phase (a, b) of y is then a 2x2 conv of x; the transposed conv's bias
does not fold to a constant, because the 3x3 conv's zero padding clips it at
the map border, so the exact per-position bias is R @ t @ C^T with
t[u, v] = bt @ k3[:, :, u, v].T and R/C the 0/1 tap-inclusion masks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Phases = Dict[Tuple[int, int], torch.Tensor]


def _phase_kernel(kt: torch.Tensor, k3: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Composite [O, C, 2, 2] kernel of output phase (a, b), fp32."""
    taps = {}
    for u in range(3):
        di, ap = divmod(a + u - 1, 2)
        for v in range(3):
            dj, bp = divmod(b + v - 1, 2)
            key = (di - (a - 1), dj - (b - 1))
            w_co = kt[:, :, ap, bp] @ k3[:, :, u, v].T  # [C, O]
            taps[key] = taps.get(key, 0) + w_co
    k = torch.stack(
        [torch.stack([taps[(r, s)] for s in range(2)], -1) for r in range(2)], -2
    )  # [C, O, 2, 2]
    return k.permute(1, 0, 2, 3)


def fused_upsample_conv3x3_phases_nchw(
    x: torch.Tensor,  # [B, C, H, W]
    kt: torch.Tensor,  # [C, M, 2, 2] ConvTranspose2d weight
    bt: torch.Tensor,  # [M]
    k3: torch.Tensor,  # [O, M, 3, 3] Conv2d weight (bias-free)
) -> Phases:
    """The four output phases of ``conv3x3(conv_transpose2x2s2(x))`` at the
    input resolution, bias included: ``phases[(a, b)][..., i, j] ==
    full[..., 2i+a, 2j+b]``."""
    _, _, h, w = x.shape
    dt = x.dtype
    kt = kt.float()
    k3 = k3.float()
    dev = x.device

    t = torch.einsum("m,omuv->uvo", bt.float(), k3)  # [3, 3, O]
    u_idx = torch.arange(3, device=dev)[None, :]
    rows = torch.arange(2 * h, device=dev)[:, None] + u_idx - 1
    cols = torch.arange(2 * w, device=dev)[:, None] + u_idx - 1
    rmask = ((rows >= 0) & (rows < 2 * h)).float()  # [2h, 3]
    cmask = ((cols >= 0) & (cols < 2 * w)).float()  # [2w, 3]

    phases = {}
    for a in range(2):
        for b in range(2):
            k = _phase_kernel(kt, k3, a, b).to(dt)
            pad_h = (1, 0) if a == 0 else (0, 1)
            pad_w = (1, 0) if b == 0 else (0, 1)
            y = F.conv2d(F.pad(x, pad_w + pad_h), k)
            bias = torch.einsum("pu,uvo,qv->opq", rmask[a::2], t, cmask[b::2])
            phases[(a, b)] = y + bias[None].to(dt)
    return phases


def shuffle_phases_nchw(phases: Phases) -> torch.Tensor:
    """Interleave the four phase maps back to [B, O, 2H, 2W]."""
    b, o, h, w = phases[(0, 0)].shape
    y = torch.stack(
        [phases[(0, 0)], phases[(0, 1)], phases[(1, 0)], phases[(1, 1)]], 2
    ).reshape(b, o, 2, 2, h, w)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(b, o, 2 * h, 2 * w)


def fused_upsample_conv3x3(
    x: torch.Tensor, kt: torch.Tensor, bt: torch.Tensor, k3: torch.Tensor
) -> torch.Tensor:
    """NHWC ``[B, H, W, C] -> [B, 2H, 2W, O]`` == Conv3x3(ConvTranspose(x)),
    the JAX function's public layout."""
    phases = fused_upsample_conv3x3_phases_nchw(x.permute(0, 3, 1, 2), kt, bt, k3)
    return shuffle_phases_nchw(phases).permute(0, 2, 3, 1)
