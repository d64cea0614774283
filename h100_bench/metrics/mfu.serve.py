"""The whole request's share of the card's dense bf16 peak: the model's
forward operations per image (``work.model_flops``, products only) times
the images answered, over the window's wall time, over 989 TFLOP/s."""

from h100_bench import work

LAYER = "whole request"
MOVES = "serve_img_per_s"
UNIT = "%"


def read(t):
    if not t.window_s:
        return None
    return 100.0 * work.model_flops(t.config, train=False) * t.calls * t.rows / t.window_s \
        / work.PEAK_BF16
