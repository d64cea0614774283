"""Kernel K1's residual-saving form's share of its roofline in training:
the sum of the bounds of its launches (``work.k1_bound(..., saving=True)``
at each launched block's stage shape, batch and bf16) over the sum of its
kernels' device time in the fenced profile. In a train step K1 runs only
in its saving form, one launch per block whose backward is K2, so K2's call
counter per step tells which stages (33 at ConvNeXt-Base when stages 0-2 are
fused, 6 when only 0-1 are). Reads the kernels named in ``KERNELS`` (its
Hopper design and its first design); nothing when none ran or the count
fits no run of leading stages."""

from h100_bench import work

LAYER = "kernel K1 (csrc/convnext_block.cu)"
MOVES = "train_img_per_s"
UNIT = "%"
KERNELS = ("k1_forward_kernel", "cnb_forward_kernel")


def read(t):
    spent = sum(s for name, s in t.kernels if name.split("<")[0].split("::")[-1] in KERNELS)
    launched = work.launched_stages(t.config, t.counters.get("k2_launches", 0))
    if spent <= 0 or not launched:
        return None
    per_call = sum(d * work.k1_bound(t.rows, h, w, c, saving=True)[0] for c, h, w, d in launched)
    return 100.0 * per_call * t.profile_calls / spent
