"""Shared conv building blocks (counterpart of the JAX ``models/common.py``).

Activations are NCHW tensors in ``channels_last`` memory. Submodules carry the
Flax scope names (``ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ...), so a torch
``state_dict`` key is the Flax parameter path joined with dots
(``bridge.py``).

Only the inference form exists in this port so far: every BatchNorm uses its
running statistics, in fp32, and the result is cast back to the compute dtype.
Batch-statistics (train-mode) BN raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS_BODY = 4e-5
BN_EPS_HEAD = 1e-3


def autopad(k: int, d: int = 1) -> int:
    """'same' padding for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2


def require_eval(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "the port runs inference only: batch-statistics BatchNorm "
            "(train=True / mode='train') is not ported yet"
        )


def bn_eval_fp32(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm with running statistics, computed in fp32."""
    return F.batch_norm(
        x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=False, eps=bn.eps,
    )


def conv2d(x: torch.Tensor, conv: nn.Conv2d, weight: torch.Tensor | None = None) -> torch.Tensor:
    """``conv`` applied in the compute dtype of ``x`` (params stay fp32)."""
    w = conv.weight if weight is None else weight
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(
        x, w.to(x.dtype), b, conv.stride, conv.padding, conv.dilation, conv.groups
    )


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "elu":
        return F.elu(x)
    if act == "none":
        return x
    raise ValueError(f"unknown act {act!r}")


class ConvBN(nn.Module):
    """Conv2d (+bias opt) -> BatchNorm (fp32) -> activation."""

    def __init__(self, cin, features, kernel_size=1, strides=1, groups=1,
                 dilation=1, use_bias=True, act="silu", bn_eps=BN_EPS_BODY):
        super().__init__()
        p = autopad(kernel_size, dilation)
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, strides, p, dilation,
                                groups, bias=use_bias)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=bn_eps)
        self.act = act

    def forward(self, x, train: bool = False, conv_input: bool = True):
        """``conv_input=False``: the caller already applied this conv's
        kernel (the heads' fused first conv); only BN + act run."""
        require_eval(train)
        if conv_input:
            x = conv2d(x, self.Conv_0)
        dt = x.dtype
        return _act(bn_eval_fp32(x, self.BatchNorm_0), self.act).to(dt)


class ConvBlock(nn.Module):
    """Conv + BN + SiLU with the body BN constants."""

    def __init__(self, cin, features, kernel_size=1, strides=1, groups=1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, kernel_size, strides, groups=groups)

    def forward(self, x, train: bool = False):
        return self.ConvBN_0(x, train)


class DepthwiseConvBlock(nn.Module):
    """depthwise(k=1) -> pointwise -> BN -> ELU, both convs bias-free.

    At k=1/s=1 with ``features == cin`` the pair folds exactly into one 1x1
    conv with kernel ``pw * dw_scale`` (the JAX module's fast path)."""

    def __init__(self, cin, features, kernel_size=1, strides=1):
        super().__init__()
        p = autopad(kernel_size)
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, strides, p,
                                groups=cin, bias=False)
        self.Conv_1 = nn.Conv2d(features, features, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS_BODY)
        self.fold = kernel_size == 1 and strides == 1 and features == cin

    def forward(self, x, train: bool = False):
        require_eval(train)
        dt = x.dtype
        if self.fold:
            folded = self.Conv_1.weight * self.Conv_0.weight[:, 0, 0, 0][None, :, None, None]
            x = conv2d(x, self.Conv_1, folded)
        else:
            x = conv2d(conv2d(x, self.Conv_0), self.Conv_1)
        return F.elu(bn_eval_fp32(x, self.BatchNorm_0)).to(dt)


class Bottleneck(nn.Module):
    """3x3 -> 3x3 with optional residual."""

    def __init__(self, cin, features, shortcut=True, groups=1, kernel=(3, 3), e=0.5):
        super().__init__()
        c_hidden = int(features * e)
        self.ConvBlock_0 = ConvBlock(cin, c_hidden, kernel[0])
        self.ConvBlock_1 = ConvBlock(c_hidden, features, kernel[1], groups=groups)
        self.add = shortcut and cin == features

    def forward(self, x, train: bool = False):
        y = self.ConvBlock_1(self.ConvBlock_0(x, train), train)
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP block: 1x1 in, split(2), n bottlenecks on the running tail, concat
    all (2+n) chunks, 1x1 out."""

    def __init__(self, cin, features, n=2, shortcut=False, groups=1, e=0.5):
        super().__init__()
        self.c = int(features * e)
        self.n = n
        self.ConvBlock_0 = ConvBlock(cin, 2 * self.c, 1)
        for i in range(n):
            self.add_module(
                f"Bottleneck_{i}",
                Bottleneck(self.c, self.c, shortcut, groups, kernel=(3, 3), e=1.0),
            )
        self.ConvBlock_1 = ConvBlock((2 + n) * self.c, features, 1)

    def forward(self, x, train: bool = False):
        y = self.ConvBlock_0(x, train)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1], train))
        return self.ConvBlock_1(torch.cat(parts, dim=1), train)
