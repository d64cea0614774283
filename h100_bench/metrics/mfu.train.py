"""The whole step's share of the card's dense bf16 peak: the model's
forward and backward operations per image (``work.model_flops``, products
only, nothing recomputed) times the images trained, over the window's wall
time, over 989 TFLOP/s."""

from h100_bench import work

LAYER = "whole step"
MOVES = "train_img_per_s"
UNIT = "%"


def read(t):
    if not t.window_s:
        return None
    return 100.0 * work.model_flops(t.config, train=True) * t.calls * t.rows / t.window_s \
        / work.PEAK_BF16
