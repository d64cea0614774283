"""Seeded weights, made on the device in a few large calls.

Both sides get the same state dict. Every product's weight (convolutions,
linear layers, the transposed convolution, the ConvNeXt blocks' depthwise
taps and MLP) is He-normal, N(0, 2 / fan_in). Every other parameter is its
module's usual starting value plus 0.05 N(0, 1): norms' scales and the
BiFPN fusion weights 1, biases 0, the ConvNeXt layer-scale 0 (its 1e-6
start would hide the MLP), the detection box and class biases the
ultralytics priors; BN running means 0.05 N(0, 1), running variances U(0.7,
1.4). So every parameter and statistic takes part, as in a trained model,
and the activations stay of order 1 through the 640^2 network.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .reference.model import (STRIDES, ConvNeXtBlock, MultitaskModel, PatchifyConv,
                              class_bias_names, detect_bias_prior)

NOISE = 0.05


def _leaves(model: nn.Module) -> List[Tuple[str, torch.Size, str, float]]:
    """(name, shape, kind, value) per state-dict entry: kind "he" (value =
    std), "var", "count", or "base" (value = the base that 0.05 N(0,1) is
    added to)."""
    std = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear, PatchifyConv)):
            std[pre + "weight"] = math.sqrt(2.0 / mod.weight[0].numel())
        elif isinstance(mod, nn.ConvTranspose2d):
            std[pre + "weight"] = math.sqrt(2.0 / mod.weight[:, 0].numel())
        elif isinstance(mod, ConvNeXtBlock):
            c = mod.dw_kernel.shape[0]
            std[pre + "dw_kernel"] = math.sqrt(2.0 / 49)
            std[pre + "w1"] = math.sqrt(2.0 / c)
            std[pre + "w2"] = math.sqrt(2.0 / (4 * c))
    nc = model.cfg["nc_det"]
    out = []
    for name, t in model.state_dict().items():
        if name in std:
            out.append((name, t.shape, "he", std[name]))
        elif name.endswith("running_var"):
            out.append((name, t.shape, "var", 0.0))
        elif name.endswith("num_batches_tracked"):
            out.append((name, t.shape, "count", 0.0))
        else:
            base = 0.0
            level = re.search(r"towers\.cv([23])_(\d)_2\.bias$", name)
            if level:
                base = 1.0 if level.group(1) == "2" else \
                    detect_bias_prior(nc, STRIDES[int(level.group(2))])
            elif re.search(r"(LayerNorm_0|BatchNorm_0)\.weight$|ln_scale$|unit\d+\.w[12]$", name):
                base = 1.0
            out.append((name, t.shape, "base", base))
    return out


def make_state(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model_cfg``'s model for ``seed``, on ``device``."""
    with torch.device("meta"):
        meta = MultitaskModel(model_cfg)
    leaves = _leaves(meta)
    sizes = [math.prod(s) for _, s, _, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    n = torch.tensor(sizes, device=device)
    he = torch.tensor([v if k == "he" else 0.0 for _, _, k, v in leaves], device=device)
    base = torch.tensor([v if k == "base" else 0.0 for _, _, k, v in leaves], device=device)
    noise = torch.tensor([NOISE if k == "base" else 0.0 for _, _, k, _ in leaves],
                         device=device)
    is_var = torch.tensor([k == "var" for _, _, k, _ in leaves], device=device)
    flat = normal * torch.repeat_interleave(he + noise, n) + torch.repeat_interleave(base, n)
    flat = torch.where(torch.repeat_interleave(is_var, n), uniform * 0.7 + 0.7, flat)
    state = {}
    for (name, shape, kind, _), part in zip(leaves, flat.split(sizes)):
        state[name] = torch.zeros(shape, dtype=torch.long, device=device) if kind == "count" \
            else part.view(shape)
    return state


def shift_class_bias(state: Dict[str, torch.Tensor], model_cfg: Dict, delta: float) -> None:
    """Add ``delta`` to every class logit of the head whose boxes NMS
    takes (in place)."""
    for name in class_bias_names(model_cfg):
        state[name] += delta
