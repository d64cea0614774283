"""BiFPN neck (counterpart of the JAX ``models/bifpn.py``).

1x1 ConvBlock projections to ``feature_size``; ``num_layers`` BiFPN units
with ELU-then-normalised fusion weights (eps 1e-4, init 1.0); top-down via
bilinear 2x upsample, bottom-up via bilinear 0.5x downsample
(``align_corners=False``); each fused map through DepthwiseConvBlock + C2f.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import C2f, ConvBlock, DepthwiseConvBlock
from ..ops.resize import resize_bilinear_nchw


def _up2(x):
    return resize_bilinear_nchw(x, x.shape[-2] * 2, x.shape[-1] * 2)


def _down2(x):
    return resize_bilinear_nchw(x, x.shape[-2] // 2, x.shape[-1] // 2)


class BiFPNUnit(nn.Module):
    def __init__(self, feature_size: int = 256, eps: float = 1e-4):
        super().__init__()
        fs = feature_size
        self.eps = eps
        self.w1 = nn.Parameter(torch.ones(2, 2))
        self.w2 = nn.Parameter(torch.ones(3, 2))
        for name in ("p4_td", "p3_td", "p4_out", "p5_out"):
            self.add_module(f"{name}_conv", DepthwiseConvBlock(fs, fs))
            self.add_module(f"{name}_cf", C2f(fs, fs))

    def _norm(self, w):
        w = F.elu(w)
        return w / (w.sum(dim=0, keepdim=True) + self.eps)

    def _fuse(self, name, x, train):
        x = getattr(self, f"{name}_conv")(x, train)
        return getattr(self, f"{name}_cf")(x, train)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False):
        if len(feats) != 3:
            raise ValueError(f"BiFPNUnit expects 3 levels, got {len(feats)}")
        p3_x, p4_x, p5_x = feats
        dt = p3_x.dtype
        w1 = self._norm(self.w1).to(dt)
        w2 = self._norm(self.w2).to(dt)

        p5_td = p5_x
        p4_td = self._fuse("p4_td", w1[0, 0] * p4_x + w1[1, 0] * _up2(p5_td), train)
        p3_td = self._fuse("p3_td", w1[0, 1] * p3_x + w1[1, 1] * _up2(p4_td), train)

        p3_out = p3_td
        p4_out = self._fuse(
            "p4_out",
            w2[0, 0] * p4_x + w2[1, 0] * p4_td + w2[2, 0] * _down2(p3_out), train,
        )
        p5_out = self._fuse(
            "p5_out",
            w2[0, 1] * p5_x + w2[1, 1] * p5_td + w2[2, 1] * _down2(p4_out), train,
        )
        return [p3_out, p4_out, p5_out]


class BiFPN(nn.Module):
    def __init__(self, in_channels=(256, 384, 512), feature_size: int = 256,
                 num_layers: int = 2, eps: float = 1e-4):
        super().__init__()
        self.num_layers = num_layers
        for name, cin in zip(("p3_proj", "p4_proj", "p5_proj"), in_channels):
            self.add_module(name, ConvBlock(cin, feature_size, 1))
        for i in range(num_layers):
            self.add_module(f"unit{i}", BiFPNUnit(feature_size, eps))

    def forward(self, inputs: Sequence[torch.Tensor], train: bool = False) -> List[torch.Tensor]:
        if len(inputs) != 3:
            raise ValueError(f"BiFPN expects 3 feature maps, got {len(inputs)}")
        c3, c4, c5 = inputs
        feats = [self.p3_proj(c3, train), self.p4_proj(c4, train), self.p5_proj(c5, train)]
        for i in range(self.num_layers):
            feats = getattr(self, f"unit{i}")(feats, train)
        return feats
