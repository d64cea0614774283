"""The work counts the rooflines and MFU divide by: the model's operations
against a count by hand, v1 against v2 by the Detect head, and the
ConvNeXt-block kernels' bounds against ``chip_smoke.py``'s.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from h100_bench import work
from h100_bench.reference.model import Ctx, DetectHead

ROOT = Path(__file__).resolve().parents[2]
V1 = json.loads((ROOT / "h100_bench/configs/btxrd_v1_640.json").read_text())
V2 = json.loads((ROOT / "h100_bench/configs/btxrd_v2_640.json").read_text())


def _conv(h, w, cin, cout, k, groups=1):
    return 2 * h * w * cout * (cin // groups) * k * k


def test_convnext_blocks_by_hand():
    """The 18 ConvNeXt blocks (7x7 depthwise, Linear C -> 4C, Linear 4C ->
    C at each stage's shape) by hand, against the counter's difference
    between the model and the same model with no blocks."""
    hand = sum(d * (_conv(h, w, c, c, 7, groups=c) + 2 * 2 * h * w * c * 4 * c)
               for c, h, w, d in work.stages(V1))
    no_blocks = dict(V1, backbone_depths=[0, 0, 0, 0])
    assert work.model_flops(V1, train=False) - work.model_flops(no_blocks, train=False) == hand


def test_v2_differs_from_v1_by_the_detect_head():
    """In serving by the Detect head's forward, counted alone and by hand."""
    s, fs = V1["img_size"], V1["bifpn_feature_size"]
    with torch.device("meta"):
        head = DetectHead(Ctx(), V1["nc_det"], fs, V1["reg_max"])
        feats = [torch.empty(1, fs, s // st, s // st) for st in (8, 16, 32)]
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        head(feats, False)
    c2, c3 = max(16, fs // 4, 4 * V1["reg_max"]), max(fs, min(V1["nc_det"], 100))
    hand = sum(_conv(s // st, s // st, fs, c2, 3) + _conv(s // st, s // st, c2, c2, 3)
               + _conv(s // st, s // st, c2, 4 * V1["reg_max"], 1)
               + _conv(s // st, s // st, fs, c3, 3) + _conv(s // st, s // st, c3, c3, 3)
               + _conv(s // st, s // st, c3, V1["nc_det"], 1) for st in (8, 16, 32))
    diff = work.model_flops(V1, train=False) - work.model_flops(V2, train=False)
    assert diff == counter.get_total_flops() == hand


def test_training_counts_forward_and_backward():
    fwd, step = work.model_flops(V1, train=False), work.model_flops(V1, train=True)
    assert 2.5 * fwd < step < 3.0 * fwd  # no grad of the image; nothing counted twice


def test_grouped_convolution_backward_is_not_overcounted():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        x = torch.empty(1, 96, 160, 160, requires_grad=True)
        w = torch.empty(96, 1, 7, 7, requires_grad=True)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: work._conv_backward_flops})
    with counter:
        torch.nn.functional.conv2d(x, w, padding=3, groups=96).sum().backward()
    assert counter.get_total_flops() == 3 * _conv(160, 160, 96, 96, 7, groups=96)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("stage", range(4))
def test_kernel_bounds_equal_chip_smoke(chip_smoke, stage):
    c, h, w, _ = work.stages(V1)[stage]
    for b in (8, 16, 32):
        for ours, theirs in ((work.k1_bound(b, h, w, c), chip_smoke.k1_bound(b, h, w, c)),
                             (work.k1_bound(b, h, w, c, True),
                              chip_smoke.k1_bound(b, h, w, c, saving=True)),
                             (work.k2_bound(b, h, w, c), chip_smoke.k2_bound(b, h, w, c))):
            assert ours[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)
