"""The kernel lab's entry point: where the time of the fused ConvNeXt block
kernel (K1) goes, phase by phase, on the card.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.kernel_lab \\
        [--stage 0] [--batch 16] [--img 640] [--iters 20] \\
        [--variants copy,dw,dwln,mlp,mlpgelu,full] [--rc 0] [--padded-io] \\
        [--device cuda]

Counterpart of ``scripts/kernel_lab.py`` (same flags, same draws, same
lines): builds each variant of ``ops/kernels/kernel_lab.py`` at one 640^2
stage shape and prints its time per call (:func:`..utils.timing.timeloop`,
the slope between n and 3n back-to-back calls).

  * ``--rc`` keeps its name with the card's meaning: the CTA's pixel tile TM
    (on the TPU, the row chunk: how much of the image one program instance
    holds). 0 is K1's tile (64 pixels at stages 0 and 2, 128 at stage 1,
    32 at stage 3); the lab also has the other Hopper tile, 128 at stage 0
    and 64 at stage 1. Any other value raises and names the legal ones. The
    JAX lab's VMEM row-chunk picker has no counterpart.
  * ``--padded-io`` keeps its purpose, telling the kernel's time from the
    layout work around it: without it, each call slices the lab's
    cpad-wide weights to C and folds them into the kernel's layout (taps
    ``[7, 7, C]``, ``w1 [C, 4C]``, ``w2 [4C, C]``, the zero biases, and up to
    C = 384 K1's Hopper operands ``w1'^T`` and ``w2'^T`` by K1's own fold)
    before the launch, as a caller would; with it the operands are
    made once, outside the timed loop, and the launch is timed alone. The
    card's kernel reads NHWC with a zero-filled halo, so x is never padded,
    and the output is ``[b, h, w, c]`` in both modes (the JAX lab's cpad-wide
    output columns are TPU layout).
  * ``--device`` is the card by default, and raises without one; ``cpu``
    runs the plain versions (host clock), for tests.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.kernels import kernel_lab as lab
from ..utils.timing import timeloop

DEFAULT_VARIANTS = "copy,dw,dwln,mlp,mlpgelu,full"


def stage_shape(stage: int, img: int = 640) -> tuple[int, int]:
    """(H = W, C) of the trunk stage at image side ``img``."""
    return [(img // 4, 96), (img // 8, 192), (img // 16, 384), (img // 32, 768)][stage]


def lab_inputs(b, h, w, c, device="cuda"):
    """The JAX lab's draws (``RandomState(0)``: x, then dw ``[8, 8, cpad]``,
    w1 ``[cpad, 4c]``, w2 ``[4c, cpad]``, cpad = ceil(c / 128) * 128) as
    torch tensors: x bf16, dw fp32, w1 and w2 bf16."""
    cpad = -(-c // 128) * 128
    rng = np.random.RandomState(0)
    x = rng.rand(b, h, w, c) * 2 - 1
    dw = rng.randn(8, 8, cpad) * 0.1
    w1 = rng.randn(cpad, 4 * c) * 0.02
    w2 = rng.randn(4 * c, cpad) * 0.02

    def t(a, dt):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return t(x, torch.bfloat16), t(dw, torch.float32), t(w1, torch.bfloat16), t(w2, torch.bfloat16)


def fold(dw, w1, w2, c):
    """The lab's cpad-wide weights in the kernel's layout: taps ``[7, 7, C]``,
    w1 ``[C, 4C]``, w2 ``[4C, C]`` (contiguous), an fp32 zero vector of 4C
    values (the biases), and where the lab runs K1's Hopper design (C <=
    384) its operands ``(w1'^T, w2'^T)`` (:func:`~..ops.kernels.kernel_lab.
    hopper_operands`), else None."""
    taps, w1k, w2k = dw[:7, :7, :c].contiguous(), w1[:c].contiguous(), w2[:, :c].contiguous()
    wt = lab.hopper_operands(w1k, w2k) if lab.hopper_route(c) else None
    return taps, w1k, w2k, torch.zeros(4 * c, dtype=torch.float32, device=dw.device), wt


def build_variant(variant, b, h, w, c, rc, dt, padded_io=False, device="cuda"):
    """``(run, x)``: ``run(x)`` computes ``variant`` on the lab's seeded
    inputs at tile ``rc`` (TM; 0 for K1's). ``dt`` must be bfloat16 (the lab
    is bf16 only). Given x, ``run(x)`` equals the JAX lab's output on
    ``[..., :c]``."""
    if dt != torch.bfloat16:
        raise TypeError(f"kernel lab: bf16 only, got {dt}")
    if variant not in lab.VARIANTS:
        raise ValueError(f"kernel lab: unknown variant {variant!r}")
    lab.check_tile(c, rc)
    x, dw, w1, w2 = lab_inputs(b, h, w, c, device)
    if padded_io:
        ops = fold(dw, w1, w2, c)

        def run(xin):
            return lab.lab_variant(variant, xin, *ops[:3], tm=rc, zeros=ops[3], wt=ops[4])
    else:
        def run(xin):
            taps, w1k, w2k, zeros, wt = fold(dw, w1, w2, c)
            return lab.lab_variant(variant, xin, taps, w1k, w2k, tm=rc, zeros=zeros, wt=wt)

    return run, x


def main(argv=None) -> dict:
    """Print the header and one line per variant; return {variant: ms}."""
    ap = argparse.ArgumentParser(description="Time K1's phases (the kernel lab)")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--rc", type=int, default=0,
                    help="the CTA's pixel tile TM (0: K1's; a refused value names the legal "
                         "ones)")
    ap.add_argument("--padded-io", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")
    hw, c = stage_shape(args.stage, args.img)
    variants = args.variants.split(",")
    for v in variants:
        if v not in lab.VARIANTS:
            raise ValueError(f"kernel lab: unknown variant {v!r}; known: {', '.join(lab.VARIANTS)}")
    tm = lab.check_tile(c, args.rc)
    if device.type == "cuda":
        _, th, tw, _ = lab.lab_tile("full", c, tm)
        tile = f"TM={tm} ({th}x{tw} pixels per CTA)"
    else:
        tile = f"TM={tm} (plain versions on the CPU)"
    print(f"stage{args.stage} {hw}x{hw}x{c} {tile} batch={args.batch} "
          f"padded_io={args.padded_io}")
    times = {}
    for variant in variants:
        run, x = build_variant(variant, args.batch, hw, hw, c, tm, torch.bfloat16,
                               padded_io=args.padded_io, device=args.device)
        ms = timeloop(lambda: run(x), args.iters, device=device.type)
        times[variant] = ms
        notes = []
        if device.type == "cuda":
            notes.append(f"{lab.lab_tile(variant, c, tm)[3]} CTAs/SM")
        if variant in lab.SHARES:
            on = " on this card" if device.type == "cuda" else ""
            notes.append(f"= {lab.SHARES[variant]}{on}")
        print(f"  {variant:<8s} {ms:7.3f} ms" + (f"  ({'; '.join(notes)})" if notes else ""))
    return times


if __name__ == "__main__":
    main()
