"""Anchor-free Detect / Segment heads (counterpart of the JAX
``models/heads.py``), inference form.

Detect: per level a box tower (Conv(c2,3) -> Conv(c2,3) -> 1x1 to
4*reg_max) and a cls tower (Conv(c3,3) -> Conv(c3,3) -> 1x1 to nc), with
c2 = max(16, ch0//4, 4*reg_max), c3 = max(ch0, min(nc, 100)). Segment: the
same towers + per-level coefficient towers (c4 = max(ch0//4, nm)) + Proto on
P3. Head convs are bias-free with BN eps 1e-3.

The towers' first 3x3 convs all read the same map and are bias-free, so
they always run as ONE conv whose output channels are split c2 | c3 (| c4):
exact, the JAX heads' default (``fuse_towers=True``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BN_EPS_HEAD, ConvBN, conv2d
from ..core.anchors import make_anchors
from ..core.boxes import dist2bbox
from ..core.dfl import dfl_decode
from ..ops.fused_upsample import fused_upsample_conv3x3_phases_nchw, shuffle_phases_nchw

DEFAULT_STRIDES = (8, 16, 32)


class HeadConv(nn.Module):
    """conv(bias=False) + BN(eps 1e-3) + SiLU."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, kernel_size, use_bias=False,
                               act="silu", bn_eps=BN_EPS_HEAD)

    @property
    def weight(self) -> torch.Tensor:
        return self.ConvBN_0.Conv_0.weight

    def forward(self, x, train: bool = False, conv_input: bool = True):
        return self.ConvBN_0(x, train, conv_input=conv_input)


def tower_widths(nc: int, ch0: int, reg_max: int) -> Tuple[int, int]:
    """(c2, c3) tower widths per the ultralytics Detect rules."""
    return max(16, ch0 // 4, 4 * reg_max), max(ch0, min(nc, 100))


def fused_first_conv(x: torch.Tensor, kernels: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """One 3x3 SAME conv whose output channels are the concatenation of
    ``kernels``' outputs (each ``[O_i, C, 3, 3]``)."""
    k = torch.cat([kk.to(dtype) for kk in kernels], dim=0)
    return F.conv2d(x.to(dtype), k, padding=1)


class DetectTowers(nn.Module):
    """Box/cls towers shared by the Detect and Segment heads."""

    def __init__(self, nc: int, ch0: int, in_chs: Sequence[int],
                 strides: Sequence[int] = DEFAULT_STRIDES, reg_max: int = 16):
        super().__init__()
        c2, c3 = tower_widths(nc, ch0, reg_max)
        self.c2 = c2
        self.nc, self.strides, self.reg_max = nc, tuple(strides), reg_max
        for i, cin in enumerate(in_chs):
            self.add_module(f"cv2_{i}_0", HeadConv(cin, c2, 3))
            self.add_module(f"cv2_{i}_1", HeadConv(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cv3_{i}_0", HeadConv(cin, c3, 3))
            self.add_module(f"cv3_{i}_1", HeadConv(c3, c3, 3))
            self.add_module(f"cv3_{i}_2", nn.Conv2d(c3, nc, 1))

    def bias_init_values(self, i: int) -> Tuple[float, float]:
        """(box bias, cls bias) of level i: ultralytics ``Detect.bias_init``."""
        return 1.0, math.log(5.0 / self.nc / (640.0 / self.strides[i]) ** 2)

    def forward(self, first_outs, train: bool = False) -> List[torch.Tensor]:
        """``first_outs``: per level the (box, cls) outputs of the fused
        first conv; the first convs' BN + SiLU run here."""
        outs = []
        for i, (yb, yc) in enumerate(first_outs):
            b = getattr(self, f"cv2_{i}_0")(yb, train, conv_input=False)
            c = getattr(self, f"cv3_{i}_0")(yc, train, conv_input=False)
            b = conv2d(getattr(self, f"cv2_{i}_1")(b, train), getattr(self, f"cv2_{i}_2"))
            c = conv2d(getattr(self, f"cv3_{i}_1")(c, train), getattr(self, f"cv3_{i}_2"))
            outs.append(torch.cat([b, c], dim=1))
        return outs  # per level NCHW [B, 4*reg_max + nc, H, W]


def decode_detections(
    raw_levels: Sequence[torch.Tensor],  # NHWC [B, H, W, 4*reg_max + nc]
    nc: int,
    img_size: int,
    reg_max: int = 16,
    strides: Sequence[int] = DEFAULT_STRIDES,
) -> torch.Tensor:
    """Raw per-level maps -> [B, A, 4+nc]: absolute-pixel xywh boxes and
    sigmoid class scores, anchors in NHWC row-major level order."""
    b = raw_levels[0].shape[0]
    x = torch.cat([lv.reshape(b, -1, lv.shape[-1]) for lv in raw_levels], 1).float()
    box_logits = x[..., : 4 * reg_max].reshape(b, -1, 4, reg_max)
    cls_logits = x[..., 4 * reg_max :]
    ltrb = dfl_decode(box_logits)
    pts, strd = make_anchors(img_size, strides, device=x.device)
    xywh = dist2bbox(ltrb, pts[None], box_format="xywh") * strd[None]
    return torch.cat([xywh, torch.sigmoid(cls_logits)], dim=-1)


class DetectHead(nn.Module):
    """Standalone Detect head (v1 model)."""

    def __init__(self, nc: int, ch0: int = 256, in_chs: Sequence[int] = (256,) * 3,
                 strides: Sequence[int] = DEFAULT_STRIDES, reg_max: int = 16):
        super().__init__()
        self.towers = DetectTowers(nc, ch0, in_chs, strides, reg_max)

    def forward(self, feats, train: bool = False):
        t = self.towers
        first_outs = []
        for i, x in enumerate(feats):
            y = fused_first_conv(
                x, [getattr(t, f"cv2_{i}_0").weight, getattr(t, f"cv3_{i}_0").weight], x.dtype
            )
            first_outs.append((y[:, : t.c2], y[:, t.c2 :]))
        return t(first_outs, train)


class Proto(nn.Module):
    """Prototype masks on P3: cv1 -> ConvTranspose 2x -> cv2 -> cv3. Eval
    path: the transposed conv and cv2's 3x3 conv run composed as four phase
    convs at P3 resolution; BN/SiLU and the 1x1 cv3 run per phase; the pixel
    shuffle happens at nm channels."""

    def __init__(self, cin: int, npr: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = HeadConv(cin, npr, 3)
        self.upsample = nn.ConvTranspose2d(npr, npr, 2, stride=2, bias=True)
        self.cv2 = HeadConv(npr, npr, 3)
        self.cv3 = HeadConv(npr, nm, 1)

    def forward(self, x, train: bool = False):
        x = self.cv1(x, train)
        phases = fused_upsample_conv3x3_phases_nchw(
            x, self.upsample.weight, self.upsample.bias, self.cv2.weight
        )
        out = {k: self.cv3(self.cv2(y, train, conv_input=False), train)
               for k, y in phases.items()}
        return shuffle_phases_nchw(out)


class SegmentHead(nn.Module):
    """Segment head = Detect towers + coefficient towers + Proto."""

    def __init__(self, nc: int, nm: int = 32, npr: int = 256, ch0: int = 256,
                 in_chs: Sequence[int] = (256,) * 3,
                 strides: Sequence[int] = DEFAULT_STRIDES, reg_max: int = 16):
        super().__init__()
        self.nm = nm
        self.c4 = max(ch0 // 4, nm)
        self.proto = Proto(in_chs[0], npr, nm)
        self.towers = DetectTowers(nc, ch0, in_chs, strides, reg_max)
        for i, cin in enumerate(in_chs):
            self.add_module(f"cv4_{i}_0", HeadConv(cin, self.c4, 3))
            self.add_module(f"cv4_{i}_1", HeadConv(self.c4, self.c4, 3))
            self.add_module(f"cv4_{i}_2", nn.Conv2d(self.c4, nm, 1))

    def forward(self, feats, train: bool = False):
        """-> (det_raw NCHW levels, coeffs [B, A, nm], protos NCHW)."""
        protos = self.proto(feats[0], train)
        t = self.towers
        first_outs, coeff_levels = [], []
        b = feats[0].shape[0]
        for i, x in enumerate(feats):
            y = fused_first_conv(
                x,
                [getattr(t, f"cv2_{i}_0").weight, getattr(t, f"cv3_{i}_0").weight,
                 getattr(self, f"cv4_{i}_0").weight],
                x.dtype,
            )
            c2c3 = y.shape[1] - self.c4  # split order c2 | c3 | c4
            first_outs.append((y[:, : t.c2], y[:, t.c2 : c2c3]))
            m = getattr(self, f"cv4_{i}_0")(y[:, c2c3:], train, conv_input=False)
            m = conv2d(getattr(self, f"cv4_{i}_1")(m, train), getattr(self, f"cv4_{i}_2"))
            coeff_levels.append(m.permute(0, 2, 3, 1).reshape(b, -1, self.nm))
        coeffs = torch.cat(coeff_levels, dim=1)
        det_raw = t(first_outs, train)
        return det_raw, coeffs, protos
