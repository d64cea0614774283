"""The plain reference of the multitask model, in fp32.

ConvNeXt-Tiny trunk (timm ``convnext_tiny``: stem 4x4/4 + LN, stages of
depths 3/3/9/3 at widths 96/192/384/768, 2x2/2 downsamples after an LN;
block = 7x7 depthwise -> LN -> Linear 4C -> exact GELU -> Linear C ->
layer-scale -> residual), C2f adapters to (256, 384, 512), a BiFPN of
``bifpn_num_layers`` units at ``bifpn_feature_size`` (ELU-normalised fusion
weights, bilinear 2x / 0.5x, DepthwiseConv + C2f per fused map), the
ultralytics Segment head (box, class and coefficient towers, Proto on P3),
for v1 a separate Detect head, the pooled-P5 image classifier, and a 1x1
projection of the prototypes to a semantic mask upsampled to the input
(upstream ``src/main_model.py:300-393``, ``src/main_modelv2.py``).

Written from that description in plain ``torch``: every convolution is one
``F.conv2d``, the transposed convolution one ``F.conv_transpose2d``, the
depthwise + pointwise pair two convolutions, each tower conv its own call,
everything in fp32 in NCHW. The parameter names are the state-dict keys
the benchmark hands to both sides. BatchNorm in training normalises with
the batch's statistics (biased variance) and moves its running statistics
by ``running += m * (batch - running)``, ``m`` the module's momentum.

``Precision`` (``precision.py``) rounds the operands of every product, so
the same code is the lower-precision control. ``checkpoint=True`` recomputes
each block in the backward pass instead of keeping its activations, so
that a batch of 32 at 640^2 fits on one card in fp32; the result is the
same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import FP32, Precision

STRIDES = (8, 16, 32)
BN_EPS_BODY, BN_EPS_HEAD = 4e-5, 1e-3
# torch-convention momenta (the share of the batch statistic taken per step)
BN_M_BODY = {"reference": 0.9997, "frozen": 0.1}
BN_M_HEAD = 0.03


@dataclasses.dataclass
class Ctx:
    """What every module of one model reads at run time."""

    precision: Precision = FP32
    checkpoint: bool = False
    bn_frozen: bool = False  # True while a checkpointed segment is recomputed


def conv(ctx: Ctx, x, weight, bias=None, stride=1, padding=0, groups=1):
    return F.conv2d(ctx.precision.p(x), ctx.precision.p(weight), bias, stride, padding, 1,
                    groups)


def linear(ctx: Ctx, x, weight, bias=None):
    return F.linear(ctx.precision.p(x), ctx.precision.p(weight), bias)


def batch_norm(ctx: Ctx, x, bn: nn.BatchNorm2d, train: bool):
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)
    if not ctx.bn_frozen:
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)


def run(ctx: Ctx, fn, *args):
    """``fn(*args)``, recomputed in the backward pass under checkpointing."""
    if ctx.checkpoint and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def resize(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


# ------------------------------------------------------------------ trunk
class PatchifyConv(nn.Module):
    def __init__(self, ctx, cin, features, patch):
        super().__init__()
        self.ctx, self.patch = ctx, patch
        self.weight = nn.Parameter(torch.empty(features, cin, patch, patch))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        k = self.patch
        h, w = x.shape[-2:]
        x = x[..., : h - h % k, : w - w % k]
        return conv(self.ctx, x, self.weight, self.bias, stride=k)


class LayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW map, eps 1e-6."""

    def __init__(self, dim):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        ln = self.LayerNorm_0
        return F.layer_norm(x.permute(0, 2, 3, 1), ln.normalized_shape, ln.weight, ln.bias,
                            ln.eps).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, ctx, c):
        super().__init__()
        self.ctx = ctx
        self.dw_kernel = nn.Parameter(torch.empty(c, 1, 7, 7))
        self.dw_bias = nn.Parameter(torch.empty(c))
        self.ln_scale = nn.Parameter(torch.empty(c))
        self.ln_bias = nn.Parameter(torch.empty(c))
        self.w1 = nn.Parameter(torch.empty(4 * c, c))
        self.b1 = nn.Parameter(torch.empty(4 * c))
        self.w2 = nn.Parameter(torch.empty(c, 4 * c))
        self.b2 = nn.Parameter(torch.empty(c))
        self.gamma = nn.Parameter(torch.empty(c))

    def _forward(self, x):
        c = x.shape[1]
        y = conv(self.ctx, x, self.dw_kernel, self.dw_bias, padding=3, groups=c)
        y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), self.ln_scale, self.ln_bias, 1e-6)
        h = F.gelu(linear(self.ctx, y, self.w1, self.b1))
        o = linear(self.ctx, h, self.w2, self.b2) * self.gamma
        return x + o.permute(0, 3, 1, 2)

    def forward(self, x):
        return run(self.ctx, self._forward, x)


class ConvNeXtFeatures(nn.Module):
    def __init__(self, ctx, depths, dims):
        super().__init__()
        self.depths = tuple(depths)
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i == 0:
                self.stem_conv = PatchifyConv(ctx, 3, dim, 4)
                self.stem_norm = LayerNorm(dim)
            else:
                self.add_module(f"downsample_norm{i}", LayerNorm(dims[i - 1]))
                self.add_module(f"downsample_conv{i}", PatchifyConv(ctx, dims[i - 1], dim, 2))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", ConvNeXtBlock(ctx, dim))

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm(self.stem_conv(x))
            else:
                x = getattr(self, f"downsample_conv{i}")(getattr(self, f"downsample_norm{i}")(x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i >= 1:
                outs.append(x)
        return outs


# ---------------------------------------------------------- conv blocks
def _bn(features, eps, momentum):
    return nn.BatchNorm2d(features, eps=eps, momentum=momentum)


class ConvBN(nn.Module):
    """conv (+ bias) -> BatchNorm -> activation ("silu" or "none")."""

    def __init__(self, ctx, cin, features, k=1, groups=1, use_bias=True, act="silu",
                 eps=BN_EPS_BODY, momentum=0.1):
        super().__init__()
        self.ctx, self.act = ctx, act
        self.Conv_0 = nn.Conv2d(cin, features, k, 1, k // 2, groups=groups, bias=use_bias)
        self.BatchNorm_0 = _bn(features, eps, momentum)

    def forward(self, x, train):
        c = self.Conv_0
        y = conv(self.ctx, x, c.weight, c.bias, padding=c.padding, groups=c.groups)
        y = batch_norm(self.ctx, y, self.BatchNorm_0, train)
        return F.silu(y) if self.act == "silu" else y


class ConvBlock(nn.Module):
    def __init__(self, ctx, cin, features, k=1, momentum=0.1):
        super().__init__()
        self.ConvBN_0 = ConvBN(ctx, cin, features, k, momentum=momentum)

    def forward(self, x, train):
        return self.ConvBN_0(x, train)


class DepthwiseConvBlock(nn.Module):
    """1x1 depthwise -> 1x1 pointwise (both bias-free) -> BN -> ELU."""

    def __init__(self, ctx, c, momentum):
        super().__init__()
        self.ctx = ctx
        self.Conv_0 = nn.Conv2d(c, c, 1, groups=c, bias=False)
        self.Conv_1 = nn.Conv2d(c, c, 1, bias=False)
        self.BatchNorm_0 = _bn(c, BN_EPS_BODY, momentum)

    def forward(self, x, train):
        y = conv(self.ctx, x, self.Conv_0.weight, groups=x.shape[1])
        y = conv(self.ctx, y, self.Conv_1.weight)
        return F.elu(batch_norm(self.ctx, y, self.BatchNorm_0, train))


class Bottleneck(nn.Module):
    def __init__(self, ctx, c, momentum):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(ctx, c, c, 3, momentum)
        self.ConvBlock_1 = ConvBlock(ctx, c, c, 3, momentum)

    def forward(self, x, train):
        return self.ConvBlock_1(self.ConvBlock_0(x, train), train)


class C2f(nn.Module):
    """1x1 to 2c, split, two bottlenecks on the running tail (no shortcut),
    concat the four chunks, 1x1 out."""

    def __init__(self, ctx, cin, features, momentum, n=2):
        super().__init__()
        self.ctx, self.c, self.n = ctx, features // 2, n
        self.ConvBlock_0 = ConvBlock(ctx, cin, 2 * self.c, 1, momentum)
        for i in range(n):
            self.add_module(f"Bottleneck_{i}", Bottleneck(ctx, self.c, momentum))
        self.ConvBlock_1 = ConvBlock(ctx, (2 + n) * self.c, features, 1, momentum)

    def _forward(self, x, train):
        y = self.ConvBlock_0(x, train)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"Bottleneck_{i}")(parts[-1], train))
        return self.ConvBlock_1(torch.cat(parts, 1), train)

    def forward(self, x, train):
        return run(self.ctx, self._forward, x, train)


class ConvNeXtTiny(nn.Module):
    def __init__(self, ctx, depths, dims, momentum):
        super().__init__()
        self.trunk = ConvNeXtFeatures(ctx, depths, dims)
        self.c2f_p3 = C2f(ctx, dims[1], 256, momentum)
        self.c2f_p4 = C2f(ctx, dims[2], 384, momentum)
        self.c2f_p5 = C2f(ctx, dims[3], 512, momentum)

    def forward(self, x, train):
        p3, p4, p5 = self.trunk(x)
        return [self.c2f_p3(p3, train), self.c2f_p4(p4, train), self.c2f_p5(p5, train)]


# ------------------------------------------------------------------- neck
class BiFPNUnit(nn.Module):
    NAMES = ("p4_td", "p3_td", "p4_out", "p5_out")

    def __init__(self, ctx, fs, momentum):
        super().__init__()
        self.ctx = ctx
        self.w1 = nn.Parameter(torch.empty(2, 2))
        self.w2 = nn.Parameter(torch.empty(3, 2))
        for name in self.NAMES:
            self.add_module(f"{name}_conv", DepthwiseConvBlock(ctx, fs, momentum))
            self.add_module(f"{name}_cf", C2f(ctx, fs, fs, momentum))

    @staticmethod
    def _norm(w):
        w = F.elu(w)
        return w / (w.sum(0, keepdim=True) + 1e-4)

    def _fuse(self, name, x, train):
        x = run(self.ctx, getattr(self, f"{name}_conv"), x, train)
        return getattr(self, f"{name}_cf")(x, train)

    def forward(self, feats, train):
        p3, p4, p5 = feats
        w1, w2 = self._norm(self.w1), self._norm(self.w2)
        up = lambda t: resize(t, 2 * t.shape[-2], 2 * t.shape[-1])  # noqa: E731
        down = lambda t: resize(t, t.shape[-2] // 2, t.shape[-1] // 2)  # noqa: E731
        p4_td = self._fuse("p4_td", w1[0, 0] * p4 + w1[1, 0] * up(p5), train)
        p3_td = self._fuse("p3_td", w1[0, 1] * p3 + w1[1, 1] * up(p4_td), train)
        p4_out = self._fuse("p4_out", w2[0, 0] * p4 + w2[1, 0] * p4_td
                            + w2[2, 0] * down(p3_td), train)
        p5_out = self._fuse("p5_out", w2[0, 1] * p5 + w2[1, 1] * p5
                            + w2[2, 1] * down(p4_out), train)
        return [p3_td, p4_out, p5_out]


class BiFPN(nn.Module):
    def __init__(self, ctx, fs, num_layers, momentum):
        super().__init__()
        self.num_layers = num_layers
        for name, cin in zip(("p3_proj", "p4_proj", "p5_proj"), (256, 384, 512)):
            self.add_module(name, ConvBlock(ctx, cin, fs, 1, momentum))
        for i in range(num_layers):
            self.add_module(f"unit{i}", BiFPNUnit(ctx, fs, momentum))

    def forward(self, feats, train):
        feats = [self.p3_proj(feats[0], train), self.p4_proj(feats[1], train),
                 self.p5_proj(feats[2], train)]
        for i in range(self.num_layers):
            feats = getattr(self, f"unit{i}")(feats, train)
        return feats


# ------------------------------------------------------------------ heads
class HeadConv(nn.Module):
    """conv (bias-free) -> BN (eps 1e-3) -> SiLU."""

    def __init__(self, ctx, cin, features, k):
        super().__init__()
        self.ConvBN_0 = ConvBN(ctx, cin, features, k, use_bias=False, eps=BN_EPS_HEAD,
                               momentum=BN_M_HEAD)

    def forward(self, x, train):
        return self.ConvBN_0(x, train)


class DetectTowers(nn.Module):
    """Per level a box tower (3x3, 3x3, 1x1 to 4 reg_max) and a class tower
    (3x3, 3x3, 1x1 to nc); widths c2 = max(16, ch0 / 4, 4 reg_max), c3 =
    max(ch0, min(nc, 100))."""

    def __init__(self, ctx, nc, ch0, reg_max):
        super().__init__()
        self.ctx = ctx
        c2, c3 = max(16, ch0 // 4, 4 * reg_max), max(ch0, min(nc, 100))
        for i in range(len(STRIDES)):
            self.add_module(f"cv2_{i}_0", HeadConv(ctx, ch0, c2, 3))
            self.add_module(f"cv2_{i}_1", HeadConv(ctx, c2, c2, 3))
            self.add_module(f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cv3_{i}_0", HeadConv(ctx, ch0, c3, 3))
            self.add_module(f"cv3_{i}_1", HeadConv(ctx, c3, c3, 3))
            self.add_module(f"cv3_{i}_2", nn.Conv2d(c3, nc, 1))

    def _level(self, i, x, train):
        b = getattr(self, f"cv2_{i}_1")(getattr(self, f"cv2_{i}_0")(x, train), train)
        c = getattr(self, f"cv3_{i}_1")(getattr(self, f"cv3_{i}_0")(x, train), train)
        b2, c2 = getattr(self, f"cv2_{i}_2"), getattr(self, f"cv3_{i}_2")
        return torch.cat([conv(self.ctx, b, b2.weight, b2.bias),
                          conv(self.ctx, c, c2.weight, c2.bias)], 1)

    def forward(self, feats, train):
        return [run(self.ctx, self._level, i, x, train) for i, x in enumerate(feats)]


class DetectHead(nn.Module):
    def __init__(self, ctx, nc, ch0, reg_max):
        super().__init__()
        self.towers = DetectTowers(ctx, nc, ch0, reg_max)

    def forward(self, feats, train):
        return self.towers(feats, train)


class Proto(nn.Module):
    """cv1 3x3 -> ConvTranspose 2x2/2 -> cv2 3x3 -> cv3 1x1 to nm."""

    def __init__(self, ctx, cin, npr, nm):
        super().__init__()
        self.ctx = ctx
        self.cv1 = HeadConv(ctx, cin, npr, 3)
        self.upsample = nn.ConvTranspose2d(npr, npr, 2, stride=2, bias=True)
        self.cv2 = HeadConv(ctx, npr, npr, 3)
        self.cv3 = HeadConv(ctx, npr, nm, 1)

    def _forward(self, x, train):
        p = self.ctx.precision
        x = self.cv1(x, train)
        x = F.conv_transpose2d(p.p(x), p.p(self.upsample.weight), self.upsample.bias, stride=2)
        return self.cv3(self.cv2(x, train), train)

    def forward(self, x, train):
        return run(self.ctx, self._forward, x, train)


class SegmentHead(nn.Module):
    def __init__(self, ctx, nc, nm, npr, ch0, reg_max):
        super().__init__()
        self.ctx, self.nm = ctx, nm
        c4 = max(ch0 // 4, nm)
        self.proto = Proto(ctx, ch0, npr, nm)
        self.towers = DetectTowers(ctx, nc, ch0, reg_max)
        for i in range(len(STRIDES)):
            self.add_module(f"cv4_{i}_0", HeadConv(ctx, ch0, c4, 3))
            self.add_module(f"cv4_{i}_1", HeadConv(ctx, c4, c4, 3))
            self.add_module(f"cv4_{i}_2", nn.Conv2d(c4, nm, 1))

    def _coeffs(self, i, x, train):
        m = getattr(self, f"cv4_{i}_1")(getattr(self, f"cv4_{i}_0")(x, train), train)
        c = getattr(self, f"cv4_{i}_2")
        m = conv(self.ctx, m, c.weight, c.bias)
        return m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, self.nm)

    def forward(self, feats, train):
        protos = self.proto(feats[0], train)
        coeffs = torch.cat([run(self.ctx, self._coeffs, i, x, train)
                            for i, x in enumerate(feats)], 1)
        return self.towers(feats, train), coeffs, protos


# ------------------------------------------------------------------ model
def anchors(img_size: int, device):
    """Anchor centres (A, 2) in grid units and strides (A, 1), levels
    stride-ascending, each row-major over (H, W)."""
    pts, strs = [], []
    for s in STRIDES:
        n = img_size // s
        r = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        ys, xs = torch.meshgrid(r, r, indexing="ij")
        pts.append(torch.stack([xs, ys], -1).reshape(-1, 2))
        strs.append(torch.full((n * n, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl_decode(logits):
    """(..., 4, reg_max) -> (..., 4): the expectation of the softmax over
    the bins."""
    probs = torch.softmax(logits, -1)
    return (probs * torch.arange(logits.shape[-1], dtype=probs.dtype,
                                 device=probs.device)).sum(-1)


def flatten_levels(levels: Sequence[torch.Tensor]):
    """NHWC levels [B, H, W, D] -> [B, A, D]."""
    b = levels[0].shape[0]
    return torch.cat([lv.reshape(b, -1, lv.shape[-1]) for lv in levels], 1)


def decode(levels, nc, img_size, reg_max):
    """Raw NHWC levels -> [B, A, 4 + nc]: xywh boxes in pixels, sigmoid
    class scores."""
    x = flatten_levels(levels)
    b, a = x.shape[:2]
    ltrb = dfl_decode(x[..., : 4 * reg_max].reshape(b, a, 4, reg_max))
    pts, strd = anchors(img_size, x.device)
    x1y1, x2y2 = pts - ltrb[..., :2], pts + ltrb[..., 2:]
    xywh = torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], -1) * strd
    return torch.cat([xywh, torch.sigmoid(x[..., 4 * reg_max:])], -1)


class MultitaskModel(nn.Module):
    """``cfg``: the configuration file's model fields (a dict)."""

    def __init__(self, cfg: Dict, precision: Precision = FP32):
        super().__init__()
        self.cfg = dict(cfg)
        self.ctx = Ctx(precision=precision)
        ctx, fs = self.ctx, cfg["bifpn_feature_size"]
        m = BN_M_BODY[cfg.get("eval_bn", "reference")]
        self.backbone = ConvNeXtTiny(ctx, cfg["backbone_depths"], cfg["backbone_dims"], m)
        self.neck = BiFPN(ctx, fs, cfg["bifpn_num_layers"], m)
        self.segment = SegmentHead(ctx, cfg["nc_det"], cfg["proto_ch"], fs, fs, cfg["reg_max"])
        if not cfg["single_head"]:
            self.detect = DetectHead(ctx, cfg["nc_det"], fs, cfg["reg_max"])
        self.cls_fc = nn.Linear(fs, cfg["nc_img"])
        self.seg_proto_projector = nn.Conv2d(cfg["proto_ch"], 1, 1)

    def features(self, x, train: bool = False) -> List[torch.Tensor]:
        """The neck's three maps (NCHW) of NHWC [B, S, S, 3] images in [0, 1]."""
        x = x.float().permute(0, 3, 1, 2).contiguous()
        return self.neck(self.backbone(x, train), train)

    def heads(self, feats, mode: str = "infer") -> Dict[str, torch.Tensor]:
        """The heads' outputs on the neck's maps; head BN follows ``mode ==
        "train"``."""
        cfg, ctx = self.cfg, self.ctx
        s, nc, rm = cfg["img_size"], cfg["nc_det"], cfg["reg_max"]
        head_train = mode == "train"
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        feats = [f.float() for f in feats]
        seg_det, coeffs, protos = self.segment(feats, head_train)
        det = seg_det if cfg["single_head"] else self.detect(feats, head_train)
        cls_logits = linear(ctx, feats[2].mean((2, 3)), self.cls_fc.weight, self.cls_fc.bias)
        out = {"det_feats": [nhwc(t) for t in det], "seg_coeffs": coeffs,
               "protos": nhwc(protos), "seg_logits": self.project(nhwc(protos)),
               "cls_logits": cls_logits}
        if mode == "train":
            return out
        seg_preds = torch.cat([decode([nhwc(t) for t in seg_det], nc, s, rm), coeffs], -1)
        det_preds = seg_preds[..., : 4 + nc] if cfg["single_head"] else \
            decode(out["det_feats"], nc, s, rm)
        out.update(det_preds=det_preds, seg_preds=seg_preds,
                   cls_probs=torch.softmax(cls_logits, -1),
                   seg_prob=torch.sigmoid(out["seg_logits"]))
        return out

    def project(self, protos_nhwc) -> torch.Tensor:
        """The semantic-mask logits [B, S, S, 1] of NHWC prototypes: a 1x1
        projection, bilinear to the input size."""
        s, pr = self.cfg["img_size"], self.seg_proto_projector
        y = conv(self.ctx, protos_nhwc.float().permute(0, 3, 1, 2), pr.weight, pr.bias)
        return resize(y, s, s).permute(0, 2, 3, 1)

    def forward(self, x, train: bool = False, mode: str = "infer") -> Dict[str, torch.Tensor]:
        """``x``: NHWC [B, S, S, 3] images in [0, 1]. Body BN follows
        ``train``, head BN ``mode == "train"``."""
        if mode not in ("train", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        return self.heads(self.features(x, train), mode)


def class_bias_names(cfg: Dict) -> List[str]:
    """The class-logit biases of the head whose boxes NMS takes."""
    head = "segment" if cfg["single_head"] else "detect"
    return [f"{head}.towers.cv3_{i}_2.bias" for i in range(len(STRIDES))]


def detect_bias_prior(nc: int, stride: int) -> float:
    """ultralytics ``Detect.bias_init``'s class bias at a stride."""
    return math.log(5.0 / nc / (640.0 / stride) ** 2)
