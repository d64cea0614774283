"""K3's Hopper design on the CPU (torch and numpy only, no JAX): the Python
mirror of its plan (``ops/kernels/dwconv.py::dwconv7_plan``) covers every
output once, fits in shared memory and wastes few lanes at the stage shapes,
and a numpy emulation of the kernel's walk (persistent CTAs over work units,
the TMA ring of 7-row bands, the 7 rolling accumulator rows, the guarded
bands) gives ``dwconv7_plain``'s sums. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py), where the library's plan is
held against this mirror."""

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.ops.kernels import dwconv as k3

STAGES = [(160, 96), (80, 192), (40, 384), (20, 768)]  # H = W, C of the 640^2 trunk
ODD = [(1, 13, 21, 96), (3, 7, 5, 48), (2, 23, 19, 48)]  # the last: H not a multiple of 7
SHAPES = [(b, s, s, c) for b in (8, 16) for s, c in STAGES] + ODD


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cta_units(plan):
    """Each CTA's units in the kernel's order: unit u = cta + n * grid."""
    return [list(range(cta, plan["units"], plan["grid"])) for cta in range(plan["grid"])]


def unit_origin(plan, u):
    """(b, c0, w0, h0) of unit u, the kernel's decode: segment fastest."""
    h0 = (u % plan["segs"]) * plan["seg_rows"]
    u //= plan["segs"]
    w0 = (u % plan["strips"]) * plan["tw"]
    u //= plan["strips"]
    return u // plan["chunks"], (u % plan["chunks"]) * k3.CHUNK, w0, h0


def test_plan_covers_every_output_once():
    """Every (image, row, column, channel) in exactly one unit, every unit in
    exactly one CTA, and no CTA with more than its share of units."""
    for b, h, w, c in SHAPES:
        for itemsize in (2, 4):
            plan = k3.dwconv7_plan(b, h, w, c, itemsize)
            owned = sorted(u for units in cta_units(plan) for u in units)
            assert owned == list(range(plan["units"]))
            assert max(map(len, cta_units(plan))) == -(-plan["units"] // plan["grid"])
            assert plan["units"] == b * plan["chunks"] * plan["strips"] * plan["segs"]
            assert (plan["chunks"] - 1) * k3.CHUNK < c <= plan["chunks"] * k3.CHUNK
            count = np.zeros((b, h, w, plan["chunks"]), np.int16)
            for u in range(plan["units"]):
                bi, c0, w0, h0 = unit_origin(plan, u)
                count[bi, h0:h0 + plan["seg_rows"], w0:w0 + plan["tw"], c0 // k3.CHUNK] += 1
            assert (count == 1).all(), (b, h, w, c, itemsize, plan)


def test_plan_fits_shared_memory_and_the_card():
    """The ring, barriers and alignment slack within the 227 KB a CTA may
    use; a TMA box of at most 256 pixels; at most MAX_WARPS warps."""
    for b, h, w, c in SHAPES:
        for itemsize in (2, 4):
            plan = k3.dwconv7_plan(b, h, w, c, itemsize)
            assert plan["smem"] <= 227 * 1024
            assert plan["smem"] >= plan["ring"] * plan["stage_bytes"]
            assert plan["stage_bytes"] >= k3.BAND * (plan["tw"] + 6) * k3.CHUNK * itemsize
            assert plan["stage_bytes"] % 128 == 0 and plan["tw"] + 6 <= 256
            assert 1 <= plan["warps"] <= k3.MAX_WARPS and plan["px"] == k3.PX
            assert plan["unit_stages"] * k3.BAND >= plan["seg_rows"] + 6


def test_plan_wastes_few_lanes_at_the_stages():
    """At most 10 % of the lanes' outputs outside the image at the four stage
    shapes, batch 8 and 16 (the strip width divides W; C is a multiple of
    32); rows past H are never computed."""
    for b, h, w, c in SHAPES[:8]:
        for itemsize in (2, 4):
            plan = k3.dwconv7_plan(b, h, w, c, itemsize)
            assert k3.wasted_lanes(plan, w, c) <= 0.10, (b, h, w, c, plan)
            assert plan["seg_rows"] * plan["segs"] < h + plan["seg_rows"]


def emulate(x, taps, plan):
    """The kernel's walk in numpy: each CTA's flat stages g through ring slot
    g % ring (a stage is a box of 7 input rows x (tw + 6) pixels x 32
    channels, zero outside the image, issued ring stages ahead and refilled
    after the CTA has passed it), input row k of a unit feeding the
    accumulator rows (k - i) mod 7 at tap rows i, guarded bands skipping the
    pairs outside the unit, output row k - 6 stored after input row k. The
    accumulators start as NaN in each CTA, so a read of one that no chain
    started shows."""
    b, h, w, c = x.shape
    p, nw, tw, ring, stages = (plan[k] for k in ("px", "warps", "tw", "ring", "unit_stages"))
    rows_pad = plan["segs"] * plan["seg_rows"] + stages * k3.BAND + 6
    xp = np.zeros((b, rows_pad, plan["strips"] * tw + 6, plan["chunks"] * k3.CHUNK), np.float32)
    xp[:, 3:3 + h, 3:3 + w, :c] = x
    tp = np.zeros((49, plan["chunks"] * k3.CHUNK), np.float32)
    tp[:, :c] = taps.reshape(49, c)
    out = np.full((b, h, w, c), np.nan, np.float32)
    cols = (np.arange(nw)[:, None] * p + np.arange(p + 6)[None, :])  # [warp, j]: pixel in the row

    def box(units, g):  # the TMA load of flat stage g
        bi, c0, w0, h0 = unit_origin(plan, units[g // stages])
        r0 = h0 - 3 + k3.BAND * (g % stages) + 3  # + 3: xp's top padding
        return g, xp[bi, r0:r0 + k3.BAND, w0:w0 + tw + 6, c0:c0 + k3.CHUNK].copy()

    for units in cta_units(plan):
        total = len(units) * stages
        slots = [box(units, g) for g in range(min(ring, total))]
        acc = np.full((k3.BAND, nw, p, k3.CHUNK), np.nan, np.float32)
        for n, u in enumerate(units):
            bi, c0, w0, h0 = unit_origin(plan, u)
            tap = tp[:, c0:c0 + k3.CHUNK]
            hs = min(plan["seg_rows"], h - h0)
            for t in range(stages):
                g = n * stages + t
                tag, band = slots[g % ring]
                assert tag == g
                guard = not (t > 0 and k3.BAND * t + k3.BAND <= hs)
                for r in range(k3.BAND):
                    k = k3.BAND * t + r
                    xs = band[r][cols]  # [warp, P + 6, lane]
                    for i in range(7):
                        if guard and not 0 <= k - i < hs:
                            continue
                        a = acc[(r - i) % 7]
                        for j in range(7):
                            prev = 0.0 if i == 0 and j == 0 else a
                            a[...] = xs[:, j:j + p] * tap[i * 7 + j] + prev
                    m = k - 6
                    if guard and not 0 <= m < hs:
                        continue
                    done = acc[(r + 1) % 7].reshape(nw * p, k3.CHUNK)
                    nc, nch = min(nw * p, w - w0), min(k3.CHUNK, c - c0)
                    out[bi, h0 + m, w0:w0 + nc, c0:c0 + nch] = done[:nc, :nch]
                if g + ring < total:
                    slots[g % ring] = box(units, g + ring)
    return out


@pytest.mark.parametrize("flip", [False, True], ids=["taps", "flipped taps"])
def test_ring_emulation_matches_plain(flip):
    """The emulated walk against ``dwconv7_plain`` at fp32 tolerance at the
    odd shapes, with the card's plan and with plans of few CTAs (long
    segments with unguarded bands, several units per CTA)."""
    rs = np.random.RandomState(31)
    seen = set()
    for shape in ODD:
        x = rs.randn(*shape).astype(np.float32)
        taps = rs.randn(7, 7, shape[-1]).astype(np.float32) * 0.1
        if flip:
            taps = taps[::-1, ::-1].copy()
        want = k3.dwconv7_plain(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
        for sms, ctas in ((132, None), (1, 2), (1, 1)):
            plan = k3.dwconv7_plan(*shape, 4, sms=sms, ctas_per_sm=ctas)
            got = emulate(x, taps, plan)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=str(plan))
            seen.add(("persistent", plan["units"] > plan["grid"]))
            seen.add(("unguarded band", plan["seg_rows"] >= 2 * k3.BAND))
    assert {("persistent", True), ("unguarded band", True)} <= seen


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 8, 8, 24, 2), (1, 8, 8, 32, 1), (0, 8, 8, 32, 2), (1, 8, 0, 32, 4)):
        with pytest.raises(ValueError):
            k3.dwconv7_plan(*args)


def test_first_design_and_bias_on_cpu_are_plain():
    """``dwconv7_v0`` and ``dwconv7`` take the plain route on a CPU tensor
    (with and without a bias) and launch nothing."""
    rs = np.random.RandomState(32)
    x = torch.from_numpy(rs.randn(1, 6, 9, 16).astype(np.float32)).to(torch.bfloat16)
    taps = torch.from_numpy(rs.randn(7, 7, 16).astype(np.float32))
    bias = torch.from_numpy(rs.randn(16).astype(np.float32))
    before = k3.dwconv7.launches, k3.dwconv7_v0.launches
    plain = k3.dwconv7_plain(x, taps)
    assert torch.equal(k3.dwconv7_v0(x, taps), plain)
    assert torch.equal(k3.dwconv7(x, taps, bias), k3.dwconv7_plain(x, taps, bias))
    torch.testing.assert_close(k3.dwconv7_v0(x, taps, bias), plain + bias)
    assert (k3.dwconv7.launches, k3.dwconv7_v0.launches) == before
