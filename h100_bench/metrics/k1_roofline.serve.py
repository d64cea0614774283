"""Kernel K1's share of its roofline in serving: the sum of the bounds of
its launches (``work.k1_bound`` at each launched block's stage shape, batch
and bf16) over the sum of its kernels' device time in the fenced profile.
K1 runs one launch per block on the leading stages of the trunk: its launch
counter per request tells which (15 under ``pallas="auto"``: stages 0-2).
Reads the kernels named in ``KERNELS``; nothing when none ran or the count
fits no run of leading stages."""

from h100_bench import work

LAYER = "kernel K1 (csrc/convnext_block.cu)"
MOVES = "serve_img_per_s"
UNIT = "%"
KERNELS = ("k1_forward_kernel", "cnb_forward_kernel")


def read(t):
    spent = sum(s for name, s in t.kernels if name.split("<")[0].split("::")[-1] in KERNELS)
    launched = work.launched_stages(t.config, t.counters.get("k1_launches", 0))
    if spent <= 0 or not launched:
        return None
    per_call = sum(d * work.k1_bound(t.rows, h, w, c)[0] for c, h, w, d in launched)
    return 100.0 * per_call * t.profile_calls / spent
