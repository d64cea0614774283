"""The work a step needs, counted from shapes, whatever implements it.

* :func:`model_flops`: the model's operations per image, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
  the meta device: the forward for serving; forward and backward for
  training (the gradients that the loss's inputs, the detection maps, the
  mask logits and the image logits, need: of every parameter and of every
  activation that one depends on, not of the image; nothing recomputed).
  It counts
  the products (convolutions, matrix products), 2 operations per
  multiply-add, as MFU does.
* :func:`k1_bound` / :func:`k2_bound`: the least time of one launch of
  the ConvNeXt-block kernels on an H100, from the bytes they must move and
  the products they must compute (the arithmetic of the program's
  ``chip_smoke.py``, copied so that the yardstick stays fixed).

Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Dict, Tuple

import torch

PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
STEM, DOWN = 4, 2


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None) -> int:
    """Each gradient of a convolution costs its forward: 2 operations per
    output element (per input element when transposed) per weight of one
    group. ``FlopCounterMode``'s own formula ignores the groups and counts
    a depthwise convolution's backward C times over."""
    fwd = 2 * math.prod(x_shape if transposed else grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_json: str, train: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.model import MultitaskModel

    cfg = json.loads(cfg_json)
    s = cfg["img_size"]
    with torch.device("meta"):
        model = MultitaskModel(cfg)
        x = torch.empty(1, s, s, 3)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        if train:
            out = model(x, train=True, mode="train")
            loss = sum(t.sum() for t in [*out["det_feats"], out["seg_logits"],
                                         out["cls_logits"]])
            loss.backward()
        else:
            with torch.no_grad():
                model(x, train=False, mode="infer")
    return int(counter.get_total_flops())


def model_flops(cfg: Dict, train: bool) -> int:
    """Operations per image of ``cfg``'s model (the configuration file's
    model fields)."""
    keys = ("nc_det", "nc_img", "proto_ch", "bifpn_feature_size", "bifpn_num_layers",
            "img_size", "reg_max", "single_head", "backbone_depths", "backbone_dims", "eval_bn")
    return _model_flops(json.dumps({k: cfg[k] for k in keys}, sort_keys=True), train)


def stages(cfg: Dict):
    """(C, H, W, depth) of each trunk stage at ``cfg``'s input size."""
    s = cfg["img_size"] // STEM
    out = []
    for i, (c, d) in enumerate(zip(cfg["backbone_dims"], cfg["backbone_depths"])):
        h = s // DOWN ** i
        out.append((c, h, h, d))
    return out


def bound(nbytes: float, flops_bf16: float, flops_fp32: float) -> Tuple[float, str]:
    """(seconds, what bounds it) of one launch: the largest of the bytes
    over the memory rate, the products over the bf16 tensor-core peak and
    the 7x7 taps over the fp32 peak."""
    parts = {"bytes": nbytes / PEAK_BYTES, "products": flops_bf16 / PEAK_BF16,
             "taps": flops_fp32 / PEAK_FP32}
    by = max(parts, key=parts.get)
    return parts[by], by


def k1_bound(b: int, h: int, w: int, c: int, saving: bool = False) -> Tuple[float, str]:
    """K1 in bf16: x in, out (and y) out, fp32 raw parameters in; 16 C^2
    operations per pixel in the two products, 98 C in the 7x7 taps."""
    p = b * h * w
    nbytes = 2 * p * c * (3 if saving else 2) + 4 * (8 * c * c + 49 * c + 9 * c)
    return bound(nbytes, 16 * c * c * p, 98 * c * p)


def k2_bound(b: int, h: int, w: int, c: int) -> Tuple[float, str]:
    """K2 in bf16: x, y, g in and dx out; fp32 raw parameters in and their
    gradients out; the five products the block's backward needs, 8 C^2
    operations per pixel each, and two 7x7 passes of 98 C."""
    p = b * h * w
    nbytes = 2 * p * c * 4 + 2 * 4 * (8 * c * c + 49 * c + 9 * c)
    return bound(nbytes, 40 * c * c * p, 2 * 98 * c * p)


def launched_stages(cfg: Dict, launches: float):
    """The stages a kernel that runs on the first stages of the trunk
    covers with ``launches`` launches per call (one per block), or None
    when no run of leading stages has that many blocks."""
    total = 0
    for i, (_, _, _, d) in enumerate(stages(cfg)):
        total += d
        if launches == total:
            return stages(cfg)[: i + 1]
    return None
