"""ConvNeXt-Tiny backbone + C2f stage adapters (counterpart of the JAX
``models/backbone.py``).

Stem 4x4/4 patchify conv + LN; four stages of depths (3, 3, 9, 3) and dims
(96, 192, 384, 768); between stages LN + 2x2/2 patchify conv. Block: 7x7
depthwise -> LN -> 4x MLP -> layer-scale -> residual, run either by the
hand-written CUDA kernel or by the eager reference (``pallas`` below). In
training the kernel path is K1's residual-saving form with K2 as its
backward, the eager path runs under autograd; ``block_bwd`` picks per stage
width, as the JAX ``_bwd_for_dim`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BN_MOMENTUM_BODY, C2f
from ..ops.kernels.convnext_block import convnext_block, convnext_block_ref

TINY_DEPTHS = (3, 3, 9, 3)
TINY_DIMS = (96, 192, 384, 768)


class PatchifyConv(nn.Module):
    """Non-overlapping conv (kernel == stride). Odd input sizes are cropped
    (valid-conv semantics), as the JAX module does. The product runs in the
    compute dtype; the bias is added in fp32, then the result is cast."""

    def __init__(self, cin: int, features: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(features, cin, patch, patch))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        k = self.patch
        h, w = x.shape[-2:]
        if h % k or w % k:
            x = x[..., : h - h % k, : w - w % k]
        y = F.conv2d(x, self.weight.to(x.dtype), None, stride=k)
        return (y.float() + self.bias[None, :, None, None]).to(x.dtype)


class LayerNorm(nn.Module):
    """Channel LayerNorm in fp32 (eps 1e-6) on NCHW; the Flax scope keeps the
    parameters one level down (``LayerNorm_0``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=eps)

    def forward(self, x):
        ln = self.LayerNorm_0
        y = F.layer_norm(x.permute(0, 2, 3, 1).float(), ln.normalized_shape,
                         ln.weight, ln.bias, ln.eps)
        return y.to(x.dtype).permute(0, 3, 1, 2)


def use_kernel(pallas: str, x: torch.Tensor) -> bool:
    """The block dispatch of the JAX ``_use_pallas``: "on" -> the CUDA kernel
    (its wrapper returns the plain twin for a CPU tensor); "auto" -> the
    kernel on a CUDA tensor, the eager reference on a CPU tensor; "off" ->
    the eager reference."""
    if pallas not in ("auto", "on", "off"):
        raise ValueError(f"unknown pallas setting {pallas!r}")
    return pallas == "on" or (pallas == "auto" and x.device.type == "cuda")


def bwd_for_dim(dim: int, policy: str = "auto") -> str:
    """The block backward of a stage of width ``dim`` (JAX ``_bwd_for_dim``):
    "fused" (K1's saving form + K2) or "ref" (eager blocks under autograd).
    "auto" is the JAX package's per-stage policy, measured on the TPU: fused
    for C <= 384, eager at C = 768."""
    if policy not in ("auto", "fused", "ref"):
        raise ValueError(f"unknown block_bwd {policy!r}")
    if policy != "auto":
        return policy
    return "fused" if dim <= 384 else "ref"


class ConvNeXtBlock(nn.Module):
    """One ConvNeXt block. Raw parameters named as the Flax module's, in torch
    layouts (``dw_kernel [C,1,7,7]``, ``w1 [4C,C]``, ``w2 [C,4C]``)."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, pallas: str = "auto",
                 block_bwd: str = "auto"):
        super().__init__()
        c = dim
        self.pallas = pallas
        self.bwd = bwd_for_dim(dim, block_bwd)
        self.dw_kernel = nn.Parameter(torch.empty(c, 1, 7, 7))
        self.dw_bias = nn.Parameter(torch.zeros(c))
        self.ln_scale = nn.Parameter(torch.ones(c))
        self.ln_bias = nn.Parameter(torch.zeros(c))
        self.w1 = nn.Parameter(torch.empty(4 * c, c))
        self.b1 = nn.Parameter(torch.zeros(4 * c))
        self.w2 = nn.Parameter(torch.empty(c, 4 * c))
        self.b2 = nn.Parameter(torch.zeros(c))
        self.gamma = nn.Parameter(torch.full((c,), layer_scale_init))

    def params(self):
        return (self.dw_kernel, self.dw_bias, self.ln_scale, self.ln_bias,
                self.w1, self.b1, self.w2, self.b2, self.gamma)

    def forward(self, x, train: bool = False):
        """NCHW (channels_last) in and out; the block itself runs on the
        NHWC view, which is contiguous for a channels_last tensor. The
        kernel path, unless this stage trains as eager blocks."""
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        if use_kernel(self.pallas, x) and not (train and self.bwd == "ref"):
            out = convnext_block(x, *self.params(), bwd=self.bwd)
        else:
            out = convnext_block_ref(x, *self.params())
        return out.permute(0, 3, 1, 2)


class ConvNeXtFeatures(nn.Module):
    """ConvNeXt trunk returning the stage outputs in ``out_indices``."""

    def __init__(self, depths: Sequence[int] = TINY_DEPTHS,
                 dims: Sequence[int] = TINY_DIMS, out_indices=(1, 2, 3),
                 pallas: str = "auto", in_ch: int = 3, block_bwd: str = "auto"):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.out_indices = tuple(out_indices)
        for i, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            if i == 0:
                self.stem_conv = PatchifyConv(in_ch, dim, 4)
                self.stem_norm = LayerNorm(dim)
            else:
                self.add_module(f"downsample_norm{i}", LayerNorm(self.dims[i - 1]))
                self.add_module(f"downsample_conv{i}",
                                PatchifyConv(self.dims[i - 1], dim, 2))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}",
                                ConvNeXtBlock(dim, pallas=pallas, block_bwd=block_bwd))

    def forward(self, x, train: bool = False):
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm(self.stem_conv(x))
            else:
                x = getattr(self, f"downsample_conv{i}")(
                    getattr(self, f"downsample_norm{i}")(x)
                )
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, train)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class ConvNeXtTiny(nn.Module):
    """ConvNeXt features (strides 8/16/32) + C2f adapters to (256, 384, 512)."""

    def __init__(self, pallas: str = "auto", depths: Sequence[int] = TINY_DEPTHS,
                 dims: Sequence[int] = TINY_DIMS, bn_momentum: float = BN_MOMENTUM_BODY,
                 block_bwd: str = "auto"):
        super().__init__()
        self.trunk = ConvNeXtFeatures(depths, dims, pallas=pallas, block_bwd=block_bwd)
        self.c2f_p3 = C2f(dims[1], 256, bn_momentum=bn_momentum)
        self.c2f_p4 = C2f(dims[2], 384, bn_momentum=bn_momentum)
        self.c2f_p5 = C2f(dims[3], 512, bn_momentum=bn_momentum)

    def forward(self, x, train: bool = False):
        p3, p4, p5 = self.trunk(x, train)
        return (self.c2f_p3(p3, train), self.c2f_p4(p4, train),
                self.c2f_p5(p5, train))
