"""Microbenchmark: the fused ConvNeXt block kernel (K1) against the eager
block, per trunk stage, with their agreement on the same inputs.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.bench_block \\
        [--batch 16] [--img 640] [--iters 20] [--stages 0,1,2,3] [--device cuda]

Counterpart of ``scripts/bench_block.py``. For each stage (640^2: 160^2 x 96,
80^2 x 192, 40^2 x 384, 20^2 x 768) in bf16 it draws the script's inputs
with ``RandomState(stage)`` (x in [-1, 1), the depthwise taps, biases, LN,
both products and gamma = 0.5, in that order, moved into the port's torch
layouts), runs ``convnext_block`` (K1 on the card: its Hopper design up to
C = 384, its first design at 768; the plain twin on the CPU) and
``convnext_block_ref`` (the eager block, exact GELU) on them, and times
both with :func:`..utils.timing.timeloop`. The line gives both times, the
speedup, the products' share of the card's dense bf16 peak (989 TFLOP/s on
an H100 SXM; the JAX line's ``mlp-mfu`` divides by a TPU v5e's 197), the
maxdiff against ``|y|max`` and the stage's total at its depth. On the CPU
the times are the host's and no peak share is printed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.kernels.convnext_block import convnext_block, convnext_block_ref
from .common import resolve_device, timed

H100_BF16_DENSE_TFLOPS = 989.0


def stage_shapes(img: int):
    """(H = W, C, depth) of the four trunk stages at image side ``img``."""
    return [(img // 4, 96, 3), (img // 8, 192, 3), (img // 16, 384, 9), (img // 32, 768, 3)]


def block_inputs(stage: int, b: int, hw: int, c: int, device) -> tuple:
    """The JAX script's draws for ``stage`` (``RandomState(stage)``) as torch
    tensors: x bf16 NHWC, then the block's parameters in the port's layouts
    (``dw_kernel [C, 1, 7, 7]``, ``w1 [4C, C]``, ``w2 [C, 4C]``), fp32."""
    rng = np.random.RandomState(stage)
    x = rng.rand(b, hw, hw, c) * 2 - 1
    dw = rng.randn(7, 7, 1, c) * 0.1
    dw_bias = rng.randn(c) * 0.05
    ln_scale = 1 + rng.randn(c) * 0.05
    ln_bias = rng.randn(c) * 0.05
    w1 = rng.randn(c, 4 * c) * 0.02
    b1 = rng.randn(4 * c) * 0.02
    w2 = rng.randn(4 * c, c) * 0.02
    b2 = rng.randn(c) * 0.02
    gamma = np.full(c, 0.5)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return (t(x, torch.bfloat16), t(dw.transpose(3, 2, 0, 1)), t(dw_bias), t(ln_scale),
            t(ln_bias), t(w1.T), t(b1), t(w2.T), t(b2), t(gamma))


def main(argv=None) -> dict:
    """Print one line per stage; returns {stage: {k1_ms, eager_ms, maxdiff,
    scale, launches}}."""
    ap = argparse.ArgumentParser(description="K1 against the eager block, per stage")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--stages", type=str, default="0,1,2,3")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, S = args.batch, args.img

    shapes = stage_shapes(S)
    sel = [int(s) for s in args.stages.split(",")]
    print(f"batch={B} img={S} device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    out = {}
    with torch.inference_mode():
        for si in sel:
            hw, c, depth = shapes[si]
            x, *w = block_inputs(si, B, hw, c, device)
            got = convnext_block(x, *w).float()
            want = convnext_block_ref(x, *w).float()
            maxdiff = (got - want).abs().max().item()
            scale = want.abs().max().item()
            del got, want

            k1, launches = timed(lambda: convnext_block(x, *w), args.iters, device)
            ref, _ = timed(lambda: convnext_block_ref(x, *w), args.iters, device)
            mlp_gf = 2 * B * hw * hw * c * 8 * c / 1e9
            peak = (f"  mlp-mfu {mlp_gf / k1 / H100_BF16_DENSE_TFLOPS:5.1%} of "
                    f"{H100_BF16_DENSE_TFLOPS:g} TFLOP/s bf16 dense (H100)"
                    if device.type == "cuda" else "")
            print(
                f"stage{si} {hw}x{hw}x{c}: k1 {k1:7.3f} ms  eager {ref:7.3f} ms"
                f"  speedup {ref / k1:4.2f}x{peak}"
                f"  maxdiff {maxdiff:.4f} (|y|max {scale:.1f})"
                f"  -> stage total {min(k1, ref) * depth:.2f} ms", flush=True
            )
            out[si] = {"k1_ms": k1, "eager_ms": ref, "maxdiff": maxdiff, "scale": scale,
                       "launches": launches}
    return out


if __name__ == "__main__":
    main()
