"""Kernel K2's share of its roofline in training: the sum of the bounds of
its calls (``work.k2_bound`` at each launched block's stage shape, batch
and bf16) over the sum of its kernels' device time in the fenced profile.
K2 runs one call (several kernels) per block on the leading stages of the
trunk: its call counter per step tells which (15 under ``block_bwd=
"auto"``: stages 0-2). Reads the kernels named in ``KERNELS`` (its Hopper
pipeline and its first design); nothing when none ran or the count fits no
run of leading stages."""

from h100_bench import work

LAYER = "kernel K2 (csrc/convnext_block_bwd.cu)"
MOVES = "train_img_per_s"
UNIT = "%"
KERNELS = ("k2_row_kernel", "k2_weight_kernel", "k2_reduce_kernel", "cnb_bwd_spatial_kernel",
           "cnb_bwd_prep_kernel", "cnb_bwd_gemm_kernel", "cnb_bwd_dy_kernel",
           "cnb_bwd_reduce_kernel")


def read(t):
    spent = sum(s for name, s in t.kernels if name.split("<")[0].split("::")[-1] in KERNELS)
    launched = work.launched_stages(t.config, t.counters.get("k2_launches", 0))
    if spent <= 0 or not launched:
        return None
    per_call = sum(d * work.k2_bound(t.rows, h, w, c)[0] for c, h, w, d in launched)
    return 100.0 * per_call * t.profile_calls / spent
