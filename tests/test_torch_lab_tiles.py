"""The kernel lab's (K5) route on the CPU (torch only, no JAX): its tiles
follow K1's route, its Hopper operands are K1's fold at unit LN and unit
gamma, the entry point's header and ``--rc`` follow the tiles, and the
first design's lab (``lab_variant_v0``) takes the plain route on the CPU.
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import re

import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as k1
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import kernel_lab as lab
from multitask_bonetumor_yolo_tpu_torch.tools import kernel_lab as tools


# C: (K1's tile, the lab's tiles, the first design's tile, its lab's tiles)
TILES = {48: (64, (64, 128), 128, (32, 128)), 96: (64, (64, 128), 128, (32, 128)),
         192: (128, (64, 128), 64, (32, 64)), 384: (64, (64,), 64, (32, 64)),
         768: (32, (32,), 32, (32,))}


@pytest.mark.parametrize("c", sorted(TILES))
def test_tiles_follow_k1s_route(c):
    """K1's Hopper tile (64 / 64 / 128 / 64 pixels at C <= 48 / 96 / 192 /
    384) and the other where the lab has one; the first design at C = 768,
    and for the first design's lab its tile and TM = 32."""
    tm, legal, tm_v0, legal_v0 = TILES[c]
    assert lab.hopper_route(c) == (c <= 384)
    assert lab.k1_tile_pixels(c) == tm and lab.legal_tiles(c) == legal
    assert lab.k1_tile_pixels(c, v0=True) == tm_v0 and lab.legal_tiles(c, v0=True) == legal_v0
    assert lab.check_tile(c, 0) == tm and lab.check_tile(c, 0, v0=True) == tm_v0
    for t in legal:
        assert lab.check_tile(c, t) == t


@pytest.mark.parametrize("c,tm,v0,legal", [(96, 32, False, "(64, 128)"),
                                           (384, 128, False, "(64,)"),
                                           (768, 64, False, "(32,)"),
                                           (96, 64, True, "(32, 128)")])
def test_check_tile_names_the_legal_tiles(c, tm, v0, legal):
    with pytest.raises(ValueError, match="legal: " + re.escape(legal)):
        lab.check_tile(c, tm, v0)


@pytest.mark.parametrize("c", [48, 96])
def test_hopper_operands_are_k1s_fold(c):
    """The lab's Hopper operands are the two transposes, bit for bit, and
    what K1's own fold makes at unit LN scale and unit gamma (its raw fold
    and its wrapper's operands for the Hopper design)."""
    gen = torch.Generator().manual_seed(c)
    w1 = (torch.randn(c, 4 * c, generator=gen) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn(4 * c, c, generator=gen) * 0.02).to(torch.bfloat16)
    w1t, w2t = lab.hopper_operands(w1, w2)
    assert w1t.dtype == w2t.dtype == torch.bfloat16 and w1t.is_contiguous() and w2t.is_contiguous()
    assert torch.equal(w1t, w1.t()) and torch.equal(w2t, w2.t())
    ones, zeros = torch.ones(c), torch.zeros(c)
    f1, f2 = k1.fold_block_weights_t(ones, w1.t(), w2.t(), ones)
    assert torch.equal(f1.to(torch.bfloat16), w1t) and torch.equal(f2.to(torch.bfloat16), w2t)
    params = (torch.zeros(c, 1, 7, 7), zeros, ones, zeros, w1.t().float(), torch.zeros(4 * c),
              w2.t().float(), zeros, ones)
    ops = k1.kernel_operands(params, torch.bfloat16, hopper=True)
    assert torch.equal(ops["w1f_t"], w1t) and torch.equal(ops["w2f_t"], w2t)


def test_fold_makes_the_operands_of_the_route():
    """``tools.fold`` makes the Hopper operands where the lab runs K1's
    Hopper design, and none at C = 768."""
    for c, hw in ((96, 3), (768, 1)):
        x, dw, w1, w2 = tools.lab_inputs(1, hw, hw, c, device="cpu")
        taps, w1k, w2k, zeros, wt = tools.fold(dw, w1, w2, c)
        assert tuple(taps.shape) == (7, 7, c) and zeros.numel() == 4 * c
        if c <= 384:
            assert all(torch.equal(a, b) for a, b in zip(wt, lab.hopper_operands(w1k, w2k)))
        else:
            assert wt is None


@pytest.mark.parametrize("stage,rc,tm", [(0, 0, 64), (0, 128, 128), (1, 0, 128), (1, 64, 64)])
def test_main_header_shows_the_tile(capsys, stage, rc, tm):
    """``main``'s header names the tile it runs (K1's by default, the other
    with ``--rc``); an illegal ``--rc`` raises and names the legal tiles."""
    tools.main(["--device", "cpu", "--img", "32", "--batch", "1", "--iters", "1", "--stage",
                str(stage), "--variants", "copy", "--rc", str(rc)])
    assert f" TM={tm} " in capsys.readouterr().out.splitlines()[0]
    with pytest.raises(ValueError, match=r"legal: \(64, 128\)"):
        tools.main(["--device", "cpu", "--img", "32", "--stage", str(stage), "--rc", "32"])


def test_lab_variant_v0_takes_the_plain_route_on_the_cpu():
    """The first design's lab on a CPU tensor is the plain version and counts
    no launch of either lab."""
    x, dw, w1, w2 = tools.lab_inputs(1, 5, 6, 32, device="cpu")
    ops = tools.fold(dw, w1, w2, 32)[:3]
    before = (lab.lab_variant.launches, lab.lab_variant_v0.launches)
    for name in ("copy", "dwln", "mlpgelu", "full"):
        torch.testing.assert_close(lab.lab_variant_v0(name, x, *ops),
                                   lab.lab_variant_plain(name, x, *ops), rtol=0, atol=0)
    assert (lab.lab_variant.launches, lab.lab_variant_v0.launches) == before
    with pytest.raises(ValueError, match="unknown variant"):
        lab.lab_variant_v0("dwfast", x, *ops)
