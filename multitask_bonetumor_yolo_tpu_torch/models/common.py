"""Shared conv building blocks (counterpart of the JAX ``models/common.py``).

Activations are NCHW tensors in ``channels_last`` memory. Submodules carry the
Flax scope names (``ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ...), so a torch
``state_dict`` key is the Flax parameter path joined with dots
(``bridge.py``).

Every BatchNorm runs in fp32 on the compute-dtype conv output, and its result
(after the activation) is cast back. With ``train=True`` it normalises with
the batch statistics (biased variance) and moves the running statistics as
Flax does, in place: running = m * running + (1 - m) * batch, with the Flax
momentum m (the keep factor; the module's torch ``momentum`` holds 1 - m).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# Flax-convention momenta (keep factors), as in the JAX package's models/common.py
BN_MOMENTUM_BODY = 1.0 - 0.9997  # reference body blocks: running stats ~ the last batch
BN_EPS_BODY = 4e-5
BN_MOMENTUM_HEAD = 1.0 - 0.03  # ultralytics Conv default (heads)
BN_EPS_HEAD = 1e-3
BN_MOMENTUM_FROZEN = 1.0 - 0.1  # ModelConfig.eval_bn == "frozen": torch's default 0.1


def autopad(k: int, d: int = 1) -> int:
    """'same' padding for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2


def batch_norm_fp32(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """BatchNorm of ``x`` in fp32. ``train=False``: running statistics.
    ``train=True``: batch statistics over (N, H, W) with the biased variance,
    and the running statistics updated in place (not recorded by autograd):
    running += (1 - m) * (batch - running), where ``bn.momentum`` = 1 - m."""
    xf = x.float()
    if not train:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return F.batch_norm(xf, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)


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


def _bn(features: int, eps: float, momentum: float) -> nn.BatchNorm2d:
    """A BatchNorm2d holding the Flax momentum ``momentum`` in torch's form."""
    return nn.BatchNorm2d(features, eps=eps, momentum=1.0 - momentum)


class ConvBN(nn.Module):
    """Conv2d (+bias opt) -> BatchNorm (fp32) -> activation."""

    def __init__(self, cin, features, kernel_size=1, strides=1, groups=1,
                 dilation=1, use_bias=True, act="silu", bn_eps=BN_EPS_BODY,
                 bn_momentum=BN_MOMENTUM_BODY):
        super().__init__()
        p = autopad(kernel_size, dilation)
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, strides, p, dilation,
                                groups, bias=use_bias)
        self.BatchNorm_0 = _bn(features, bn_eps, bn_momentum)
        self.act = act

    def forward(self, x, train: bool = False, conv_input: bool = True):
        """``conv_input=False``: the caller already applied this conv's
        kernel (the heads' fused first conv, the Proto phases); only BN +
        act run."""
        if conv_input:
            x = conv2d(x, self.Conv_0)
        dt = x.dtype
        return _act(batch_norm_fp32(x, self.BatchNorm_0, train), self.act).to(dt)


class ConvBlock(nn.Module):
    """Conv + BN + SiLU with the body BN constants."""

    def __init__(self, cin, features, kernel_size=1, strides=1, groups=1,
                 bn_momentum=BN_MOMENTUM_BODY):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, kernel_size, strides, groups=groups,
                               bn_momentum=bn_momentum)

    def forward(self, x, train: bool = False):
        return self.ConvBN_0(x, train)


class DepthwiseConvBlock(nn.Module):
    """depthwise(k=1) -> pointwise -> BN -> ELU, both convs bias-free.

    At k=1/s=1 with ``features == cin`` the pair folds exactly into one 1x1
    conv with kernel ``pw * dw_scale`` (the JAX module's fast path, taken in
    training too: the gradients flow through the fold)."""

    def __init__(self, cin, features, kernel_size=1, strides=1, bn_momentum=BN_MOMENTUM_BODY):
        super().__init__()
        p = autopad(kernel_size)
        self.Conv_0 = nn.Conv2d(cin, features, kernel_size, strides, p,
                                groups=cin, bias=False)
        self.Conv_1 = nn.Conv2d(features, features, 1, bias=False)
        self.BatchNorm_0 = _bn(features, BN_EPS_BODY, bn_momentum)
        self.fold = kernel_size == 1 and strides == 1 and features == cin

    def forward(self, x, train: bool = False):
        dt = x.dtype
        if self.fold:
            folded = self.Conv_1.weight * self.Conv_0.weight[:, 0, 0, 0][None, :, None, None]
            x = conv2d(x, self.Conv_1, folded)
        else:
            x = conv2d(conv2d(x, self.Conv_0), self.Conv_1)
        return F.elu(batch_norm_fp32(x, self.BatchNorm_0, train)).to(dt)


class Bottleneck(nn.Module):
    """3x3 -> 3x3 with optional residual."""

    def __init__(self, cin, features, shortcut=True, groups=1, kernel=(3, 3), e=0.5,
                 bn_momentum=BN_MOMENTUM_BODY):
        super().__init__()
        c_hidden = int(features * e)
        self.ConvBlock_0 = ConvBlock(cin, c_hidden, kernel[0], bn_momentum=bn_momentum)
        self.ConvBlock_1 = ConvBlock(c_hidden, features, kernel[1], groups=groups,
                                     bn_momentum=bn_momentum)
        self.add = shortcut and cin == features

    def forward(self, x, train: bool = False):
        y = self.ConvBlock_1(self.ConvBlock_0(x, train), train)
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP block: 1x1 in, split(2), n bottlenecks on the running tail, concat
    all (2+n) chunks, 1x1 out."""

    def __init__(self, cin, features, n=2, shortcut=False, groups=1, e=0.5,
                 bn_momentum=BN_MOMENTUM_BODY):
        super().__init__()
        self.c = int(features * e)
        self.n = n
        self.ConvBlock_0 = ConvBlock(cin, 2 * self.c, 1, bn_momentum=bn_momentum)
        for i in range(n):
            self.add_module(
                f"Bottleneck_{i}",
                Bottleneck(self.c, self.c, shortcut, groups, kernel=(3, 3), e=1.0,
                           bn_momentum=bn_momentum),
            )
        self.ConvBlock_1 = ConvBlock((2 + n) * self.c, features, 1, bn_momentum=bn_momentum)

    def forward(self, x, train: bool = False):
        y = self.ConvBlock_0(x, train)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1], train))
        return self.ConvBlock_1(torch.cat(parts, dim=1), train)
