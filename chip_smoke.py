"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py                    # every phase: the full check
    python3 chip_smoke.py --only k2,k2-split # some phases, in order, for bring-up:
                                             # no kernels line and no result line

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):
  1. record the card (``nvidia-smi`` name and power limit);
  2. build the kernels from ``csrc/``, one nvcc per source, all at once: the
     ConvNeXt-block forward (K1), the block backwards (K2 and K4, one
     source), the standalone depthwise 7x7 (K3), the JPEG decode (K6: its
     host entropy decoder, K6a and K6b), eval BN + act + cast (K7) and the
     kernel lab (K5, and its
     first design's lab, the "before");
     time the builds, print registers and spills, and the shared memory and
     CTAs per SM of K1's Hopper design and K2's Hopper row pass at each of
     their widths;
  3. K1 against its plain twin at the four 640^2 stage shapes (batch 2 and
     batch 16), an odd non-square shape and a narrow (C=48) one, in bf16
     (atol/rtol 3e-2) and fp32 (atol/rtol 1e-2: the kernel's products run in
     TF32, the twin in full fp32). In bf16 both forms and both designs (the
     route's, and the first design through ``convnext_block_v0``): two calls
     equal bit for bit, the saving form's out equal to the inference form's
     and its y to the first design's. Then "[k1-time]": the routed design,
     the first design, the twin and the eager block timed with CUDA events
     in turns at the batch-16 shapes the model gives K1;
  4. the full-width v1 model (ConvNeXt-Tiny 3/3/9/3, BiFPN 256x2, 640^2,
     bf16) with seeded random weights, every parameter and BN statistic
     perturbed (``randomize``), serves 3 batches of 16 and 1 single image
     through ``infer_batch``; K1 must have launched exactly 18 times per
     forward and K7 (eval BN + act + cast) 110 times, outputs must be
     finite with the right shapes, and
     ``cls_probs``, ``seg_prob`` and the pre-NMS ``det_preds`` (boxes in
     units of the image side) must agree with the same weights under
     ``pallas="off"`` and on the eager BN chain, no K1 and no K7 (atol/rtol
     3e-2), and be no farther from the fp32 eager model (no K1, no K7) than
     2x the bf16 eager path is. Random weights score no anchor
     above the CLI's 0.25, so requests are served at the confidence that
     passes ~250 anchors per image, with NMS and instance masks; NMS at that
     confidence and over all 16 x 8400 anchors (conf 0) must keep on the
     card what it keeps on the CPU;
  5. NMS and whole-request times (host clock); the same weights under
     ``pallas="auto"`` (K1 at stages 0-2, the eager block at C = 768): 15 K1
     launches per forward, outputs against ``"on"``; batch-16 forward times
     with ``pallas="off"``, ``"on"`` and ``"auto"`` (CUDA events, two turns,
     and profiler device time; "[model-time]");
     "[infer-cli]": the served weights written as a checkpoint
     (``torch_to_flax`` + ``save_npz``) and two PNGs (512x384, 400x400),
     ``cli.infer.main`` run in process at the serving confidence, each
     record equal to ``infer_batch``'s on the same canvas;
  6. K1's residual-saving form (``out`` and the saved ``y``) and K2 against
     their plain versions at the stage shapes (batch 2), the odd shape and
     C=48, and for K2 batch 1 at 13x11 at C = 48 / 96 / 192 / 384, bf16 and
     fp32 (tolerances as in phase 3; K2's parameter gradients, sums over up
     to 204 800 pixels, judged against their own scale: max |got - want| <=
     tol * max |want|; two K2 calls equal bit for bit); then at the batch-8
     stage shapes of the train path, the same checks in bf16, and K2 (on
     the operands that the forward folded), its plain version, the eager
     block's autograd backward timed with CUDA events, K2 beside its time
     before the Hopper pipeline (the first design's, PERF.md §6); and the
     saving form of K1's routed design beside its first design's in turns,
     the twin's and the eager block's forward ("[k1-time] saving form");
     "[k2-split]": K2's device time per launch by kernel at the three
     batch-8 stage shapes (``torch.profiler``), at most five launches
     per call in bf16; the same in fp32, which runs K2's first design;
  7. the full-width v1 train step (batch 8, 640^2, bf16, seeded random
     weights as in phase 4, a synthetic seeded batch: 3 boxes per image,
     box-shaped masks, random image classes) through ``make_train_step``: 3
     steps under ``block_bwd="auto"`` with exactly 15 launches of K1's saving
     form and 15 of K2 per step (stages 0-2), 1 step under ``"fused"`` with 18
     and 18; finite losses and gradient norm, no skipped step, BN running
     statistics moved;
  8. the loss gradient at one set of weights and batch three ways: (a) K1 +
     K2 on every stage, bf16; (b) ``pallas="off"``, bf16; (c) ``pallas="off"``,
     fp32 with TF32 off; every anchor positive (``iou_match_thresh`` -1), so
     that the three precisions train the same loss terms. For the trunk
     blocks' parameters and for the whole flattened gradient, |a - c| / |c|
     may be at most 2x |b - c| / |c| + 1e-3;
  9. train-step times, CUDA events, six alternating turns of 10 steps with
     ``pallas="off"`` and ``"auto"`` (K1 + K2), with images/s at the median
     turn and peak memory; then each side under ``torch.profiler`` over 3
     steps: device kernel time per step by category, kernels per step and
     the device's idle share ("[profile]");
 10. K3 (its Hopper design, ``csrc/dwconv.cuh``) against ``F.conv2d(groups=C)``
     on the fp32 input (TF32 off) with the taps, the flipped taps (the
     explicit backward's two calls) and with a bias (the library's bias
     pointer, as K4's recompute passes it), at the stage shapes at batch 2
     and 8, the odd shape, C=48, C=16 and batch 32 at 20^2 x 768 (more work
     units than CTAs), bf16 (atol/rtol 3e-2) and fp32 (1e-2), and bit for
     bit against its first design (``dwconv7_v0``); the library's plan
     against its Python mirror; both designs' registers (ptxas) and SASS
     instructions per output value (``cuobjdump``); then "[k3-time]": the
     Hopper design and the first design in turns (CUDA events, and each
     kernel alone under ``torch.profiler``), the bound, the plain version
     and cuDNN's depthwise convolution at the batch-8 stage shapes;
 11. K4 against its plain version on both of its designs, its route (in
     bf16 up to C = 384 K2's Hopper pipeline under V1) and its first design
     (``convnext_block_bwd_v1_v0``), at the shapes of phase 6 and at batch 8
     at all four stages (K2's tolerances); two calls of the route equal bit
     for bit; both wrappers refuse a cotangent of another dtype or layout;
     then "[k4-time]": the route, the first design, the plain version and
     the eager block's autograd backward timed in turns at the batch-8 stage
     shapes; "[k4-split]": K4's device time per launch by kernel at the
     batch-8 shapes of stages 0-2 (at most five launches per call on the
     route), the first design's beside it;
 12. "[block-fwdbwd]", one block's forward plus backward at the batch-8
     stage shapes, bf16, x and every parameter requiring grad, under the
     five routes ``"ref"``, eager autograd, ``"fused"``, ``"fused_v1"`` and
     ``"explicit"``: the launches per block over a pass of the trunk's 18
     blocks (1 of K1 and 1 of K4 under "fused_v1", 1 of K1 and 2 of K3 under
     "explicit"), CUDA-event times in two turns and trunk totals weighted by
     the depths 3/3/9/3; then the gradients of "fused_v1" and "explicit" at
     batch 2 in fp32 against fp32 eager autograd (dx atol/rtol 5e-3,
     parameter gradients 2e-2 of their scale: the tanh/erf GELU gap).
 13. "[lab]", the kernel lab (K5, K1 cut down phase by phase; in bf16 up to
     C = 384 K1's Hopper design, at C = 768 its first design): each of its
     14 variants against its plain version at every legal tile (K1's, and
     the other Hopper tile at C <= 192), at the batch-16 stage shapes and at
     (2, 13, 21, 48) (copy bit-exact; the dw family, dwbf16, dwln and
     mlpgelubf16 within one bf16 step, rtol 2^-7 atol 1e-3; the other
     products' phases atol/rtol 3e-2), ``full`` at K1's tile bit for bit
     against K1 (``convnext_block``) and at the other tile within one bf16
     step of it, the first design's lab (``lab_variant_v0``) against the
     plain versions at stages 0-2; each variant timed
     (``utils/timing.py::timeloop``) with and without ``padded_io`` beside
     its bound, its plain version and ``x.clone()`` / cuDNN's depthwise
     convolution where one call computes it, and the first design's lab
     launch alone at stages 0-2, the "before" ("[lab-time]"); K1's time
     split by phase per stage at both tiles, the first design's beside it
     ("[lab-split]"); then the entry point
     ``tools.kernel_lab.main(["--stage", "0"])``, the lab's main path.
 14. "eval" (run after phase 5's "[infer-cli]", on phase 4's model): a
     synthetic BTXRD dataset of 40 PNGs (320-960 px, ``rich``) written with
     the port's ``make_synthetic_btxrd``; the served weights with the Detect
     head's class biases shifted so that the eval forward scores ~250
     anchors per image above 0.05 (``condition_for_eval``), saved with
     ``CheckpointManager`` and a ``config.json`` sidecar (model, TAL loss,
     data); one batch-16 eval step (``make_eval_step``) under ``"auto"``
     (15 K1 launches) and ``"off"`` (none): losses, class logits and the
     pre-NMS predictions within 3e-2, the seg probabilities no farther from
     the fp32 eager forward than 2x the bf16 eager path's (+1e-3), seg_counts
     apart by at most 1 % of the pixels, NMS keeping boxes and the
     confusion matrix counting, the BN running statistics bit for bit as
     they were; "[eval-time]" (CUDA events and profiler device time); then
     ``cli.evaluate.main`` in process
     (``--split all --batch-size 16 --image-ext .png --epochs 2
     --log-examples``): 90 K1 launches, the JAX CLI's key set, finite
     values, pass 2 (replayed from the device cache) equal to pass 1, the
     overlays read back; "[evaluate]" gives both passes' times, the host's
     work of pass 1 timed alone, and the peak device memory.
 15. "trainer" (after "eval"): a synthetic split of 48 PNGs (320-960 px,
     ``rich``; 38 train, 4 steps of 8, and 10 val); ``cli.train.main`` in
     process on the full-width v1 model made from its seed (640^2, bf16,
     batch 8, ``pallas`` and ``block_bwd`` "auto", HSV 0.015 / 0.7 / 0.4 and
     flip 0.5, ``--log-every 1``) for 2 epochs: every train step launches
     K1's saving form and K2 15 times and K1 never, every validation forward
     K1 15 times (the steps' launch counters read around each call); every
     logged loss finite, no step skipped, ``config.json``, the index and the
     last checkpoint written; then ``--resume auto --epochs 3`` continues
     from step 8 with epoch 2 and ends at step 12; ``cli.evaluate.main`` on
     that checkpoint over the val split gives the trainer's last validation
     (mAP50, Dice, image accuracy, loss) within 1e-6; and ``augment_batch``
     with mosaic, HSV and flip on the card against the CPU on fixed draws
     (boxes, valid, masks, labels equal, images within 1e-5). "[trainer]"
     gives each epoch's ``PhaseTimer`` split, "[trainer-time]" the train
     img/s over epoch 1, the validation seconds of epoch 0 (primed) and 1
     (replayed), the checkpoint seconds and the peak device memory.
 16. "ddp" (after "trainer"): data parallelism, N ranks against 1: NCCL
     over every card when there are at least 2, else two ranks on the one
     card over gloo (the route is printed). N ranks spawned by
     ``parallel.dist.spawn`` (each joins the group; the CLIs run as its
     rank, torchrun's route) each run ``cli.train.main`` for one epoch over
     phase 15's split (per-rank batch 8 / N; finished, finite, checkpointed;
     "[ddp-train]": the epoch's img/s beside phase 15's one rank); then two
     train steps of the full-width v1 model (``randomize``'s weights from
     SEED; 640^2, HSV + flip, ``pallas`` and ``block_bwd`` "auto") on their
     rows of a global batch of 8, in bf16 and again in fp32 (TF32 off), and
     ``cli.evaluate.main`` on the trained checkpoint (fp32, split all),
     against the same in this process on one rank: bf16, the loss per step
     within 1e-2, grad_norm at step 1 within 3e-2, the BN statistics
     within 1e-2 (p2 - p0 is printed beside one rank's own spread: the
     trunk's gradient is mostly bf16 noise behind the neck's train-mode
     BNs); fp32, the loss within 1e-4, grad_norm 1e-3, p2 - p0 within 3e-2
     relative norm on the elements whose gradient is at least 0.3 x its
     tensor's RMS at both steps, the conv biases in front of a train-mode
     BN by their gradients (1e-3 of the largest element), the BN
     statistics 1e-3; the ranks' states equal bit for bit; K1's saving
     form and K2 15 launches per step on every rank, K1 15 per evaluation
     forward on every rank; the evaluation's every key within 3e-2 of
     max(1, |value|) ("[ddp]", "[ddp-evaluate]"); "[ddp-time]": per rank
     the bf16 step (CUDA events), the upload of its rows and the gradient
     all-reduce (its bytes counted).
 17. "raw" (after "ddp"): the first day from raw BTXRD. 24 labelme
     JSONs + JPEGs of 300-600 px (``make_synthetic_raw``, the port's JPEG
     writer) and two 2560x2048 JPEGs (colour 4:2:0, grey); ``cli.prepare_data``
     (``--emit-seg-polygons``), ``cli.wrangle``, ``cli.show_sample`` ("[prepare]");
     K6 against its plain version (``jpeg_idct_plain``, ``jpeg_color_plain``,
     on the card) on the same coefficients and through the whole card route,
     on every image in colour and grey reads: 0 differing bytes; the C
     entropy decoder against the Python one on two images; an Exif
     orientation ("[jpeg-check]"); "[jpeg]": a read by parts (parse,
     entropy, upload, kernels, download; median of 5) at both sizes, K6a and
     K6b by events and device time beside their bounds and plain versions;
     "[raw-loader]": ``BTXRD.__getitem__`` img/s over the converted JPEGs
     against the same pixels as PNG, in turns; then the full-width v1 model
     (seeded random weights, conditioned as phase 14 does) through
     ``cli.infer.main`` with overlays over the 24 converted JPEGs at the
     confidence that passes ~250 anchors per image (as phase 4; 15 K1
     launches and one of each of K6a and K6b per image, 48 overlays read
     back; "[raw-infer]") and ``cli.evaluate.main --image-ext .jpeg`` over
     the split ("[raw-evaluate]"; the JAX CLI's keys, finite).
 18. "tools" (after "raw"): the JAX repo's profiling scripts as the port's
     tools, at full width and 640^2, through their entry points:
     ``tools.bench_block`` (batch 16; K1 against the eager block at the
     four stages, each maxdiff within the bf16 tolerance of |y|max, one K1
     launch per call), ``tools.profile_infer`` (batch 16; 15 K1 launches per
     full forward and per trunk or backbone call, 1 per stage-row call,
     none in the neck, heads, decode, NMS or resize; K7 110 per full
     forward, 18 per backbone call, 59 per neck, 21 per Segment and 12 per
     Detect head call) and
     ``tools.profile_train`` (batch 8; K1's saving form and K2 15 each per
     full step, per fwd+bwd and per backbone fwd+bwd, K1 15 per train-mode
     forward, and per stage-row call 1 of K1 under ``ref``, of K1 and K4
     under ``fused_v1``, of K1's saving form and K2 under ``fused``, none
     eager); each tool's rows are printed ("[tools]");
 19. "recipe" (after "tools"): the quality-parity recipe cut to
     ``RECIPE_IMAGES`` JPEGs and ``RECIPE_EPOCHS`` epochs at 640^2, batch
     8, TAL and frozen BN: ``tools.train_synthetic`` writes the split,
     trains through ``cli.train`` and evaluates the best checkpoint through
     ``cli.evaluate``; then ``tools.diagnose_det`` on its run directory.
     Every image read decodes on the card, one K6a and one K6b launch per
     read; every train step launches K1's saving form and K2 15 times, every
     eval forward (the trainer's validation, ``cli.evaluate``'s and the
     diagnosis's) K1 15 times; the table's metrics finite ("[recipe]").
 20. "k7" (after "fwdbwd"): K7 (``csrc/bn_act.cu``) against the eager chain
     (cuDNN's fp32 BN, the activation, the cast), both through the models'
     route ``models/common.py::bn_act`` (the eager chain under autograd), at
     the serving forward's P3 neck map (16x80x80x256; SiLU, ELU and none),
     the Proto's cv2 on its four stacked phases (64x80x80x256), the P5
     adapter's (16x20x20x256), the heads' channel slice (16x80x80, channels
     [64, 320) of a 320-channel map) and a narrow map (16x80x80x64), bf16:
     at most one bf16 step (no smaller than at 2^-12 of the map's largest
     value) on at most 1 % of the elements; "[k7-time]": K7's device time (profiler) beside its byte
     bound (4 bytes per element at 3.35 TB/s) and its share of it, with CUDA
     events beside, and the eager chain's device time as ``library_ms``
     (a NOTE where the P3 share is under 60 %).
 21. "base": ConvNeXt-Base's widths. At its kernel stages (C = 128 / 256 /
     512 at 160^2 / 80^2 / 40^2: the CP = 192 and 384 instantiations with
     the channels past C zero, and C = 512's own) K1 at batch 16 against its
     twin with phase 3's bf16 checks, K1's saving form and K2 at batch 32
     (the benchmark's Base training batch) against theirs with phase 6's,
     two K2 calls equal bit for bit; "[base-time]": each beside the eager
     block (K1 against its forward, K2 against its autograd backward, the
     fused forward + backward against eager autograd's, CUDA events in
     turns), its bound, and the MiB each route holds for the backward. Then
     the v1 model at Base's widths and depths (3/3/27/3, bf16, 640^2,
     ``randomize``'s weights) under "auto" with the tracer on: one batch-16
     ``infer_batch`` launches K1 33 times, one batch-32 train step K1's
     saving form and K2 33 times each and K1 never, both roots count 33
     blocks on the kernel route and 3 eager (``trunk.blocks.*``), the step
     finite and not skipped ("[base-model]"). In a full run the three
     kernels' entries of the kernels line carry these rows as
     ``base_widths``.
Each phase sets the launch counts to 0 right before the path it drives and
reads them right after; the K3 and K4 launches of the kernels line are
those of phase 12's pass over the trunk, K6a's and K6b's those of phase 17's
``cli.infer`` and ``cli.evaluate``. Prints the kernels' JSON line, the card's line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

SEED = 0
IMG = 640
BATCH = 16
TRAIN_BATCH = 8
STAGES = ((96, 160, 3), (192, 80, 3), (384, 40, 9), (768, 20, 3))  # C, H=W, depth
BASE_STAGES = ((128, 160, 3), (256, 80, 3), (512, 40, 27), (1024, 20, 3))  # ConvNeXt-Base
BASE_TRAIN_BATCH = 32  # the batch the benchmark trains ConvNeXt-Base at
# H100 SXM datasheet peaks (dense): bf16 tensor cores, TF32 tensor cores,
# fp32 outside the tensor cores, device memory
PEAK_BF16, PEAK_TF32, PEAK_FP32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
BF16_TOL = 3e-2
FP32_TOL = 1e-2
CANDIDATES = 250  # anchors per image above the serving confidence
# K2 per call at the batch-8 stage shapes before its Hopper pipeline, by C
# (the first design: sixteen launches, wmma; measured by an earlier version
# of this script on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md §6). Only
# the "[k2-time]" text quotes it: the kernels line holds this run's numbers.
K2_MS_BEFORE = {96: 3.202, 192: 2.049, 384: 1.679}
K2_MAX_LAUNCHES = 5  # per bf16 call of the Hopper pipeline


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key="", iters=20, launches=None) -> float:
    """Device time per call of the kernels whose name holds ``key`` (every
    kernel of the call for the empty key; ``torch.profiler``, after one
    warm-up call): the kernels alone, without the host's share of a call,
    which CUDA events around back-to-back calls take in when the host issues
    the calls slower than the device runs them. ``launches``: the keyed
    kernel's known launches per call (see :func:`kernel_split`)."""
    known = {key: launches} if launches else None
    total = sum(v["ms"] for k, v in kernel_split(fn, iters, known=known).items() if key in k)
    if total <= 0:
        raise RuntimeError(f"the profiler recorded no device time for {key or 'the call'}")
    return total


def block_args(gen, b, h, w, c, dtype, dev):
    def f(*s, scale=0.1):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    return (x, f(c, 1, 7, 7), f(c), f(c) + 1.0, f(c), f(4 * c, c), f(4 * c),
            f(c, 4 * c), f(c), f(c) * 0.5)


def host_ms(fn) -> float:
    """Host-clock ms of one call that ends in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0


def check_close(name, got, want, tol) -> float:
    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool((err > bound).any()):
        raise RuntimeError(f"{name}: max abs err {err.max().item():.3e} exceeds tol {tol}")
    return err.max().item()


def bound(nbytes, flops_bf16, flops_fp32):
    """(bound_ms, bound_by) of one launch: the largest of the bytes over the
    memory rate, the products over the bf16 tensor-core peak and the 7x7
    taps over the fp32 peak (separate units, which can overlap)."""
    parts = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": flops_bf16 / PEAK_BF16 * 1e3,
             "fp32 operations": flops_fp32 / PEAK_FP32 * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes" else "operations"


def depth_sum(per_stage, stages):
    """(bound_ms, bound_by) of a whole path: the sum over its launches of
    each launch's bound (a stage's times its depth); bound by what bounds
    most of that time."""
    total, by_ms = 0.0, {"bytes": 0.0, "operations": 0.0}
    for (ms, by), (_, _, d) in zip(per_stage, stages):
        total += d * ms
        by_ms[by] += d * ms
    return total, max(by_ms, key=by_ms.get)


def auto_blocks(cnb, stages=STAGES):
    """Blocks of a trunk of ``stages`` that run the kernels under "auto" (K1
    in a served forward, K1's saving form and K2 in a train step): those up
    to the route's ceiling, the widest C of the Hopper designs."""
    return sum(d for c, _, d in stages if c <= cnb.HOPPER_MAX_CHANNELS)


def k1_bound(b, h, w, c, saving=False):
    """K1 at bf16: x in, out (and y) out, fp32 raw parameters in; 16 C^2 flop
    per pixel in the two products, 98 C in the 7x7 taps."""
    p = b * h * w
    nbytes = 2 * p * c * (3 if saving else 2) + 4 * (8 * c * c + 49 * c + 9 * c)
    return bound(nbytes, 16 * c * c * p, 98 * c * p)


def k2_bound(b, h, w, c):
    """K2 at bf16: x, y, g in and dx out; fp32 raw parameters in and their
    gradients out; the five products the function needs, 8 C^2 flop per
    pixel each (h1, d_a, d_z2, dw1, dw2: d_z = ln_scale * d_z2, and dgamma
    comes from the dw2 product before gamma's scaling; the kernel's extra two
    are its design), and two 7x7 passes of 98 C."""
    p = b * h * w
    nbytes = 2 * p * c * 4 + 2 * 4 * (8 * c * c + 49 * c + 9 * c)
    return bound(nbytes, 40 * c * c * p, 2 * 98 * c * p)


def k3_bound(b, h, w, c):
    """K3 at bf16: x in, the fp32 output out, the fp32 taps in; 98 C flop per
    pixel on the fp32 units."""
    p = b * h * w
    return bound(2 * p * c + 4 * p * c + 4 * 49 * c, 0, 98 * c * p)


def k4_bound(b, h, w, c):
    """K4 at bf16: x and g in and dx out; fp32 raw parameters in and their
    gradients out; K2's five products of 8 C^2 flop per pixel, and three 7x7
    passes of 98 C (the recompute of y, dx and the taps' gradient)."""
    p = b * h * w
    nbytes = 2 * p * c * 3 + 2 * 4 * (8 * c * c + 49 * c + 9 * c)
    return bound(nbytes, 40 * c * c * p, 3 * 98 * c * p)


def phase_kernel(cnb, dev, gen):
    """K1 against its plain twin, both forms, on both designs where the route
    has two (bf16 up to C = 384: the Hopper design, and the first design
    through ``convnext_block_v0``); then "[k1-time]"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # + an odd non-square shape, and C=48: a partial dwconv channel chunk and,
    # in bf16, a partial hidden chunk (4C = 192 is not a multiple of 128)
    shapes = [(2, s, s, c) for c, s, _ in STAGES] + [(1, 13, 21, 96), (3, 7, 5, 48)]
    max_err = 0.0
    for shape in shapes:
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            args = block_args(gen, *shape, dt, dev)
            got = cnb.convnext_block(*args)
            want, want_y = cnb.convnext_block_plain_saving(*args)
            torch.cuda.synchronize()
            err = check_close(f"K1 {shape} {dt}", got, want, tol)
            if dt == torch.float32:
                log(f"[k1] {shape} {str(dt):15s} max_abs_err {err:.3e} (tol {tol})")
                continue
            max_err = max(max_err, err)
            max_err = max(max_err, check_k1_designs(cnb, args, got, want, want_y, shape))

    per_stage, k_total, p_total = [], 0.0, 0.0
    for c, s, depth in STAGES:
        args = block_args(gen, BATCH, s, s, c, torch.bfloat16, dev)
        got = cnb.convnext_block(*args)
        want, want_y = cnb.convnext_block_plain_saving(*args)
        err = check_close(f"K1 batch-16 {s}x{s}x{c}", got, want, BF16_TOL)
        err = max(err, check_k1_designs(cnb, args, got, want, want_y, (BATCH, s, s, c)))
        max_err = max(max_err, err)
        del got, want, want_y
        # turns: twin, first design, routed, eager, routed, first design, twin
        t_plain = cuda_ms(lambda: cnb.convnext_block_plain(*args))
        t_v0 = cuda_ms(lambda: cnb.convnext_block_v0(*args))
        t_k1 = cuda_ms(lambda: cnb.convnext_block(*args))
        t_eager = cuda_ms(lambda: cnb.convnext_block_ref(*args))
        t_k1b = cuda_ms(lambda: cnb.convnext_block(*args))
        t_v0b = cuda_ms(lambda: cnb.convnext_block_v0(*args))
        t_plainb = cuda_ms(lambda: cnb.convnext_block_plain(*args))
        k_ms, v0_ms, p_ms = (t_k1 + t_k1b) / 2, (t_v0 + t_v0b) / 2, (t_plain + t_plainb) / 2
        b_ms, b_by = k1_bound(BATCH, s, s, c)
        hopper = cnb.forward_route(torch.bfloat16, c)
        per_stage.append({"shape": [BATCH, s, s, c], "design": "hopper" if hopper else "first",
                          "ms": k_ms, "first_design_ms": v0_ms, "plain_ms": p_ms,
                          "eager_ms": t_eager, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err})
        k_total += depth * k_ms
        p_total += depth * p_ms
        log(f"[k1-time] ({BATCH},{s},{s},{c}) bf16: routed ({per_stage[-1]['design']} design) "
            f"{t_k1:.4f}/{t_k1b:.4f} ms, first design {t_v0:.4f}/{t_v0b:.4f} ms, "
            f"twin {t_plain:.4f}/{t_plainb:.4f} ms, eager erf block {t_eager:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by})")
        if hopper and k_ms > v0_ms:
            log(f"[k1-time] NOTE: at C={c} the route's Hopper design ({k_ms:.4f} ms) is slower "
                f"than the first design ({v0_ms:.4f} ms)")
    return max_err, per_stage, k_total, p_total


def check_k1_designs(cnb, args, got, want, want_y, shape):
    """bf16: a second call of K1's routed launch equal bit for bit; its saving
    form against the twin, its out equal to the inference form's and its y to
    the first design's, bit for bit; the first design against the twin.
    Returns the largest error against the twin."""
    again = cnb.convnext_block(*args)
    out, y = cnb.convnext_block_saving(*args)
    v0 = cnb.convnext_block_v0(*args)
    v0_out, v0_y = cnb.convnext_block_v0(*args, saving=True)
    torch.cuda.synchronize()
    design = "hopper" if cnb.forward_route(args[0].dtype, shape[-1]) else "first"
    if not torch.equal(got, again):
        raise RuntimeError(f"K1 {shape} bf16 ({design} design): two calls differ")
    if not torch.equal(out, got):
        raise RuntimeError(f"K1 {shape} bf16 ({design} design): the saving form's out differs "
                           f"from the inference form's")
    if not torch.equal(y, v0_y):
        raise RuntimeError(f"K1 {shape} bf16 ({design} design): the saving form's y differs "
                           f"from the first design's")
    errs = [check_close(f"K1 saving {shape} out", out, want, BF16_TOL),
            check_close(f"K1 saving {shape} y", y, want_y, BF16_TOL),
            check_close(f"K1 first design {shape}", v0, want, BF16_TOL),
            check_close(f"K1 first design saving {shape} out", v0_out, want, BF16_TOL)]
    log(f"[k1] {shape} bf16 {design} design: max_abs_err {errs[0]:.3e}, saving y "
        f"{errs[1]:.3e}; first design {errs[2]:.3e} (tol {BF16_TOL}); two calls, out of both "
        f"forms and y of both designs equal bit for bit")
    return max(errs)


@torch.no_grad()
def randomize(model, gen):
    """Seeded random weights with every parameter and BN statistic perturbed.

    Non-weight tensors (biases, norms, BN means, layer-scale gamma, fusion
    weights) get x + 0.05 N(0,1) and BN variances x U(0.7, 1.4), as the JAX
    oracle test's ``_randomize`` does: the 1e-6 gamma init would otherwise
    hide a wrong MLP. Weight tensors get He-scaled (gain sqrt 2 on the
    fan-in init) and a relative 5% perturbation: the oracle's additive 0.05
    on full-width weights (init std ~0.02 at a 3x3x256 fan-in) makes the
    network's activations grow layer after layer, until bf16 rounding alone
    moves ``seg_prob`` by ~0.05 in ANY implementation, where this setting
    keeps activations O(1) and bf16 rounding noise ~3e-3."""
    from multitask_bonetumor_yolo_tpu_torch.models.backbone import ConvNeXtBlock, PatchifyConv

    scaled = {id(m.weight) for m in model.modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                                torch.nn.ConvTranspose2d, PatchifyConv))}
    weights = scaled | {id(p) for m in model.modules() if isinstance(m, ConvNeXtBlock)
                        for p in (m.dw_kernel, m.w1, m.w2)}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        noise = torch.randn(t.shape, generator=gen, device=t.device)
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_var"):
            t.mul_(torch.rand(t.shape, generator=gen, device=t.device) * 0.7 + 0.7)
        elif id(t) in weights:
            t.mul_((2.0 ** 0.5 if id(t) in scaled else 1.0) * (1.0 + 0.05 * noise))
        else:
            t.add_(0.05 * noise)


def set_pallas(model, value):
    from multitask_bonetumor_yolo_tpu_torch.models.backbone import ConvNeXtBlock

    for m in model.modules():
        if isinstance(m, ConvNeXtBlock):
            m.pallas = value


def detached(out):
    if torch.is_tensor(out):
        return out.detach()
    if isinstance(out, (list, tuple)):
        return type(out)(detached(t) for t in out)
    if isinstance(out, dict):
        return {k: detached(v) for k, v in out.items()}
    return out


def eager_chain(model, fn):
    """``fn()``, a forward of ``model``, with every BN + act on the eager
    chain (cuDNN's fp32 BN, the activation, the cast) rather than K7: under
    autograd with the parameters requiring a gradient, which the route
    (``models/common.py::bn_act``) leaves to the eager chain. Raises if K7
    launched all the same; returns the outputs detached."""
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import bn_act as k7

    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(True)
    before = k7.bn_act.launches
    try:
        with torch.enable_grad():
            out = detached(fn())
    finally:
        for p, f in zip(model.parameters(), flags):
            p.requires_grad_(f)
    if k7.bn_act.launches != before:
        raise RuntimeError(f"the eager reference launched K7 {k7.bn_act.launches - before} times")
    return out


def check_outputs(out, b, cfg):
    a = sum((IMG // s) ** 2 for s in (8, 16, 32))
    want = {
        "det_preds": (b, a, 4 + cfg.nc_det),
        "seg_preds": (b, a, 4 + cfg.nc_det + cfg.proto_ch),
        "seg_coeffs": (b, a, cfg.proto_ch),
        "protos": (b, IMG // 4, IMG // 4, cfg.proto_ch),
        "cls_probs": (b, cfg.nc_img),
        "seg_prob": (b, IMG, IMG, 1),
    }
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise RuntimeError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        if not torch.isfinite(out[k].float()).all():
            raise RuntimeError(f"{k}: non-finite values")


@torch.no_grad()
def phase_model(cnb, dev, gen):
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import bn_act as k7
    from multitask_bonetumor_yolo_tpu_torch.ops.nms import postprocess_detections

    cfg = ModelConfig(img_size=IMG, dtype="bfloat16", pallas="on")
    model = build_model(cfg, seed=SEED, device=dev)
    randomize(model, gen)
    requests = [torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev,
                              dtype=torch.uint8) for _ in range(3)]
    requests.append(torch.randint(0, 256, (1, IMG, IMG, 3), generator=gen, device=dev,
                                  dtype=torch.uint8))
    # Random weights score no anchor above the CLI's 0.25. Serve at the
    # confidence that passes ~CANDIDATES anchors per image, the regime of a
    # trained detector, so NMS and the instance masks do real work.
    scores = model(requests[0].float() / 255.0)["det_preds"][..., 4:].amax(-1)
    conf = torch.quantile(scores.float().flatten(), 1.0 - CANDIDATES / scores.shape[1]).item()
    serve = dict(conf_thresh=conf, instance_masks=True)
    torch.cuda.synchronize()

    cnb.convnext_block.launches = 0
    k7.bn_act.launches = 0
    t0 = time.perf_counter()
    results = [infer_batch(model, r, **serve) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = cnb.convnext_block.launches
    depth = sum(cfg.backbone_depths)
    if launches != depth * len(requests):
        raise RuntimeError(f"K1 launched {launches} times, want {depth} x {len(requests)}")
    k7_launches = k7.bn_act.launches // len(requests)
    if k7.bn_act.launches != K7_PER_FORWARD["v1"] * len(requests):
        raise RuntimeError(f"K7 launched {k7.bn_act.launches} times, want "
                           f"{K7_PER_FORWARD['v1']} x {len(requests)}")
    for r, res in zip(requests, results):
        check_outputs(res.outputs, r.shape[0], cfg)
        if res.detections.boxes.shape != (r.shape[0], 100, 4):
            raise RuntimeError("NMS result has the wrong shape")
        if res.instance_masks.shape != (r.shape[0], 100, IMG, IMG):
            raise RuntimeError("instance masks have the wrong shape")
        if not bool(res.detections.valid.any(1).all()):
            raise RuntimeError("an image kept no detection at the serving confidence")
    log(f"[serve] 3x{BATCH} + 1 requests (NMS + instance masks) in {serve_s:.3f} s "
        f"(first call included) at conf {conf:.4g}; K1 launches {launches} = {depth} per "
        f"forward, K7 {k7_launches} per forward; detections kept per image (first batch): "
        f"{results[0].detections.valid.sum(1).tolist()}")

    # the same weights with the eager blocks and the eager BN chain (no K1,
    # no K7), in bf16 and in fp32 (TF32 off)
    set_pallas(model, "off")
    img = requests[0].float() / 255.0
    off = eager_chain(model, lambda: model(img, train=False, mode="infer"))
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    ref32 = eager_chain(model, lambda: model(img, train=False, mode="infer"))
    model.cfg = cfg
    scale = torch.tensor([IMG] * 4 + [1] * cfg.nc_det, device=dev)

    def unit_boxes(out):  # boxes in units of the image side, like the scores
        return {**out, "det_preds": out["det_preds"] / scale}

    on, off, ref32 = unit_boxes(results[0].outputs), unit_boxes(off), unit_boxes(ref32)
    for k in ("cls_probs", "seg_prob", "det_preds"):
        err = check_close(f"model {k} on vs off", on[k], off[k], BF16_TOL)
        # K1 and K7 add no error beyond bf16 rounding: against the fp32
        # eager model, the kernel path may be at most 2x as far as the bf16
        # eager path (plus 1e-3 of the output's scale). Dropping the blocks' MLP
        # breaks this by ~10x; the 3e-2 on/off bound alone would not see it.
        e_on = (on[k].float() - ref32[k]).abs().max().item()
        e_off = (off[k].float() - ref32[k]).abs().max().item()
        bound = 2.0 * e_off + 1e-3 * ref32[k].abs().max().item()
        if e_on > bound:
            raise RuntimeError(f"model {k}: kernel path {e_on:.3e} from fp32, eager bf16 "
                               f"{e_off:.3e}, bound {bound:.3e}")
        log(f"[model] {k}: on vs off max_abs_err {err:.3e} (atol/rtol {BF16_TOL}); "
            f"vs fp32 eager: on {e_on:.3e}, off {e_off:.3e} (bound {bound:.3e})")

    # NMS on the card at the serving confidence and at its worst case (conf
    # 0: all 8400 anchors of all 16 images are candidates) must keep exactly
    # what it keeps on the CPU
    det_preds = results[0].outputs["det_preds"]
    for c in (conf, 0.0):
        nms_ms = sorted(host_ms(lambda: postprocess_detections(det_preds, IMG, conf_thresh=c))
                        for _ in range(5))
        det = postprocess_detections(det_preds, IMG, conf_thresh=c)
        det_cpu = postprocess_detections(det_preds.cpu(), IMG, conf_thresh=c)
        if not torch.equal(det.indices.cpu(), det_cpu.indices):
            raise RuntimeError(f"NMS keep-set on the card differs from the CPU's at conf {c}")
        log(f"[nms] batch-{BATCH} conf {c:.4g}: "
            f"{int((det_preds[..., 4:].amax(-1) > c).sum())} candidates, "
            f"{det.valid.sum().item()} kept; {nms_ms} ms (host clock, synchronised), "
            f"keep-set equal to the CPU's")
    set_pallas(model, "on")
    serve_ms = sorted(host_ms(lambda: infer_batch(model, requests[0], **serve)) for _ in range(5))
    log(f"[serve-time] batch-{BATCH} forward + NMS + instance masks: {serve_ms} ms "
        f"(host clock, synchronised; {BATCH * 1000 / serve_ms[2]:.1f} img/s at the median)")

    # "auto": K1 on stages 0-2, the eager block at C = 768 (15 launches)
    set_pallas(model, "auto")
    auto_want = auto_blocks(cnb)
    cnb.convnext_block.launches = 0
    auto_out = infer_batch(model, requests[0], **serve).outputs
    torch.cuda.synchronize()
    if cnb.convnext_block.launches != auto_want:
        raise RuntimeError(f"pallas=auto: K1 launched {cnb.convnext_block.launches} times per "
                           f"forward, want {auto_want}")
    for k in ("cls_probs", "seg_prob", "det_preds"):
        err = check_close(f"model {k} auto vs on", unit_boxes(auto_out)[k], on[k], BF16_TOL)
        log(f"[model] {k}: auto vs on max_abs_err {err:.3e} (atol/rtol {BF16_TOL})")

    x = requests[0].float() / 255.0
    modes = ("off", "on", "auto")
    times = {m: [] for m in modes}
    for mode in modes + modes[::-1]:
        set_pallas(model, mode)
        times[mode].append(cuda_ms(lambda: model(x), iters=10, warmup=2))
    dev_ms = {}
    for mode in modes:
        set_pallas(model, mode)
        dev_ms[mode] = device_ms(lambda: model(x), iters=5)
    torch.cuda.reset_peak_memory_stats()
    set_pallas(model, "on")
    model(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = {m: sum(times[m]) / 2 for m in modes}
    log(f"[model-time] batch-{BATCH} {IMG}^2 bf16 forward (CUDA events, two turns; "
        f"profiler device time): " + ", ".join(
            f"pallas={m} {times[m]} ms (mean {mean[m]:.3f}; device {dev_ms[m]:.3f})"
            for m in modes)
        + f"; {BATCH * 1000 / mean['on']:.1f} img/s with K1 on every stage, "
        f"{BATCH * 1000 / mean['auto']:.1f} under auto; peak memory {peak:.2f} GiB")
    if mean["auto"] > mean["on"]:
        log(f"[model-time] NOTE: the forward under auto ({mean['auto']:.3f} ms) is slower "
            f"than under on ({mean['on']:.3f} ms)")
    set_pallas(model, "on")
    return (launches, k7_launches), model, conf


def phase_infer_cli(cnb, model, conf, dev, gen):
    """``cli.infer.main`` in process on the card: the serving model's weights
    written as a checkpoint (``torch_to_flax`` + ``save_npz``), two PNGs
    (512x384 and 400x400) written by the port's codec, run at the serving
    confidence; each record of ``predictions.json`` must equal
    ``infer_batch`` of a model with the CLI's ``pallas`` setting ("auto")
    loaded from the same checkpoint, on the same letterboxed canvas."""
    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.bridge import save_npz, torch_to_flax
    from multitask_bonetumor_yolo_tpu_torch.cli import infer
    from multitask_bonetumor_yolo_tpu_torch.data.imageio import write_png
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig

    work = Path(__file__).resolve().parent / "build" / "infer_cli"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "weights.npz"
    save_npz(str(ckpt), *torch_to_flax(model.state_dict()))
    paths = []
    for name, (h, w) in (("wide.png", (384, 512)), ("square.png", (400, 400))):
        img = torch.randint(0, 256, (h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        write_png(work / name, img.cpu().numpy())
        paths.append(str(work / name))
    out = work / "out"
    cnb.convnext_block.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # one JSON record per image
        infer.main(["--checkpoint-path", str(ckpt), "--images", *paths, "--out-dir", str(out),
                    "--conf-thresh", repr(conf)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    cli_launches = cnb.convnext_block.launches
    records = json.loads((out / "predictions.json").read_text())
    ref = infer.load_model(ModelConfig(img_size=IMG, dtype="bfloat16"), str(ckpt), dev)
    per_image = []
    for rec, path in zip(records, paths):
        t0 = time.perf_counter()
        res = infer.infer_batch(ref, infer.load_and_letterbox(path, IMG)[None], conf_thresh=conf)
        torch.cuda.synchronize()
        per_image.append(time.perf_counter() - t0)
        n = int(res.detections.valid[0].sum())
        same = (rec["image"] == path and rec["num_detections"] == n
                and rec["boxes_xyxy"] == res.detections.boxes[0, :n].tolist()
                and rec["scores"] == res.detections.scores[0, :n].tolist()
                and rec["labels"] == res.detections.labels[0, :n].tolist()
                and rec["img_cls_probs"] == res.outputs["cls_probs"][0].float().tolist())
        if not same or n == 0:
            raise RuntimeError(f"[infer-cli] {path}: main's record ({rec['num_detections']} "
                               f"detections) differs from infer_batch's ({n})")
    want = len(paths) * auto_blocks(cnb)
    if cli_launches != want:
        raise RuntimeError(f"[infer-cli] main launched K1 {cli_launches} times, want {want}")
    names = ", ".join(Path(p).name for p in paths)
    log(f"[infer-cli] cli.infer.main on {len(paths)} PNGs ({names}) "
        f"at conf {conf:.4g}: {main_s:.3f} s in all (checkpoint load and first calls included), "
        f"records equal to infer_batch's ({[r['num_detections'] for r in records]} detections); "
        f"PNG read + letterbox + infer_batch per image {[round(t * 1e3, 1) for t in per_image]} "
        f"ms (host clock); K1 launches {cli_launches}")
    del ref
    return main_s


EVAL_IMAGES = 40  # the eval phase's synthetic dataset: 2 full batches of 16 + 8 and 8 replicas
EVAL_CONF = 0.05  # TrainConfig.eval_conf_thresh
EVAL_SEG_PIXELS = 0.01  # share of the pixels by which "auto"'s and "off"'s seg_counts may differ


def jax_evaluate_keys():
    """The keys of the JAX ``cli/evaluate.py``'s metric dict (``ValidationMetrics
    .compute(full_map=True)``): the six losses, the binary seg metrics, the
    image-class metrics, and the numeric keys of the three mAP accumulators
    (mask mAP at max-dets 1/10/100, box mAP50 and mAP50-95 at ``--map-thresholds
    1 10 100``)."""
    map_keys = (["map", "map_50", "map_75"] + [f"{m}_{a}" for m in ("map", "mar")
                                                for a in ("small", "medium", "large")]
                + [f"mar_{d}" for d in (1, 10, 100)])
    keys = [f"loss_{k}" for k in ("total", "seg", "box_iou", "dfl", "cls_det", "img_cls")]
    keys += [f"seg_{k}" for k in ("precision", "recall", "f1", "dice", "accuracy", "iou")]
    keys += [f"img_{k}" for k in ("accuracy", "precision_macro", "recall_macro", "f1_macro")]
    for prefix in ("seg_map_", "map_iou50_", "map_iou50_95_"):
        keys += [prefix + k for k in map_keys]
    return set(keys)


def device_total_ms(fn, iters=5) -> float:
    """Device time per call of ``fn``: every kernel's time under
    ``torch.profiler`` over ``iters`` calls, after one warm-up call, summed
    and divided by ``iters``: no per-kernel launch count is needed (which
    :func:`kernel_split` checks, and fails on where the profiler drops
    events)."""
    fn()
    torch.cuda.synchronize()
    events, _ = device_events(lambda: [fn() for _ in range(iters)], pad=fn)
    return sum(e.device_time for e in events) / 1e3 / iters


@torch.no_grad()
def condition_for_eval(state, images_u8):
    """Raise the Detect head's class biases of ``state.model`` by one shift,
    so that the eval forward (``train=False, mode="train"``; the BN running
    statistics put back) of ``images_u8`` scores ~
    ``CANDIDATES`` anchors per image above ``EVAL_CONF`` (random weights
    score none above it: NMS would keep nothing). The shift moves every
    class logit by the same amount (the bias is added after the last conv),
    from the quantile score to ``EVAL_CONF``. Returns the shift."""
    from multitask_bonetumor_yolo_tpu_torch.models.heads import decode_detections

    model, cfg = state.model, state.model.cfg
    snapshot = state.bn_snapshot()
    out = model(images_u8.float() / 255.0, train=False, mode="train")
    state.bn_restore(snapshot)
    scores = decode_detections(out["det_feats"], cfg.nc_det, cfg.img_size,
                               cfg.reg_max)[..., 4:].amax(-1)
    q = torch.quantile(scores.float().flatten(), 1.0 - CANDIDATES / scores.shape[1]).item()
    shift = float(torch.logit(torch.tensor(EVAL_CONF)) - torch.logit(torch.tensor(q)))
    for i in range(3):
        getattr(model.detect.towers, f"cv3_{i}_2").bias.add_(shift)
    return shift


def save_for_eval(model, images_u8, ckpt_dir, data_cfg):
    """``model``'s train state, conditioned for evaluation
    (:func:`condition_for_eval` on ``images_u8``), saved as step 1 with
    ``CheckpointManager`` under ``ckpt_dir`` with the trainer's
    ``config.json`` (model, TAL loss, data) beside it, as ``cli.evaluate``
    reads it. Returns ``(state, shift, loss_cfg, step_dir)``."""
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.train import (
        CheckpointManager, TrainConfig, create_train_state)

    cfg = model.cfg
    state = create_train_state(cfg, TrainConfig(), model=model)
    shift = condition_for_eval(state, images_u8)
    loss_cfg = LossConfig(img_size=IMG, assigner="tal")
    step_dir = CheckpointManager(str(ckpt_dir)).save(state, 1)
    (Path(ckpt_dir) / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(cfg), "loss": dataclasses.asdict(loss_cfg),
        "data": {"img_size": IMG, "max_boxes": data_cfg.max_boxes,
                 "upload_streams": data_cfg.upload_streams}}, indent=2, default=list))
    return state, shift, loss_cfg, step_dir


def phase_eval(cnb, model, dev, card):
    """The evaluation path on the card: a synthetic BTXRD dataset (40 PNGs,
    320-960 px, ``rich``), phase 4's randomized weights conditioned so that
    NMS keeps boxes at 0.05 and saved with ``CheckpointManager`` and the
    trainer's ``config.json``; one batch-16 eval step under ``"auto"`` and
    ``"off"`` (15 K1 launches per eval forward, losses, class logits and
    the pre-NMS predictions within 3e-2, the seg probabilities held against
    the fp32 eager forward as phase 4 holds them, seg_counts apart by at
    most 1 % of the pixels, BN statistics bit for bit as they were); ``cli.evaluate.main`` in process
    (two passes, the second from the device cache, equal to the first; the
    JAX CLI's key set, finite; overlays that read back); "[eval-time]" and
    "[evaluate]" beside the card. Returns K1's launches in ``main``."""
    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
    from multitask_bonetumor_yolo_tpu_torch.data import (
        BTXRD, BTXRDLoader, DataConfig, make_synthetic_btxrd, to_device)
    from multitask_bonetumor_yolo_tpu_torch.data.imageio import read_png
    from multitask_bonetumor_yolo_tpu_torch.models.heads import decode_detections
    from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig, make_eval_step

    work = Path(__file__).resolve().parent / "build" / "eval"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    t0 = time.perf_counter()
    root = make_synthetic_btxrd(str(work / "data"), n=EVAL_IMAGES, seed=SEED, min_size=320,
                                max_size=960, rich=True)
    log(f"[eval] synthetic dataset: {EVAL_IMAGES} PNGs (320-960 px, rich) written in "
        f"{time.perf_counter() - t0:.2f} s")
    data_cfg = DataConfig(root=str(root), img_size=IMG, image_ext=".png", batch_size=BATCH)
    ds = BTXRD(data_cfg, "all")
    host = next(iter(BTXRDLoader(ds, BATCH, pad_last=True)))
    batch = to_device(host, dev)

    set_pallas(model, "auto")
    cfg = model.cfg = dataclasses.replace(model.cfg, pallas="auto")
    state, shift, loss_cfg, step_dir = save_for_eval(model, batch["image"], work / "checkpoints",
                                                     data_cfg)

    step = make_eval_step(cfg, loss_cfg, TrainConfig())
    out, bn_before = {}, [t.clone() for t in state.bn_stats()]
    for mode in ("auto", "off"):
        set_pallas(model, mode)
        cnb.convnext_block.launches = 0
        metrics, aux = step(state, batch)
        torch.cuda.synchronize()
        want = 15 if mode == "auto" else 0
        if cnb.convnext_block.launches != want:
            raise RuntimeError(f"[eval] pallas={mode}: K1 launched {cnb.convnext_block.launches} "
                               f"times per eval forward, want {want}")
        if not all(torch.equal(a, b) for a, b in zip(state.bn_stats(), bn_before)):
            raise RuntimeError(f"[eval] pallas={mode}: the eval step moved the BN statistics")
        with torch.inference_mode():
            snap = state.bn_snapshot()
            raw = model(batch["image"].float() / 255.0, train=False, mode="train")
            state.bn_restore(snap)
            preds = decode_detections(raw["det_feats"], cfg.nc_det, IMG, cfg.reg_max)
        out[mode] = (metrics, aux, preds)
    (m_auto, a_auto, p_auto), (m_off, a_off, p_off) = out["auto"], out["off"]
    for k in m_auto:
        check_close(f"[eval] {k} auto vs off", m_auto[k], m_off[k], BF16_TOL)
    err_logits = check_close("[eval] cls_logits auto vs off", a_auto["cls_logits"],
                             a_off["cls_logits"], BF16_TOL)
    scale = torch.tensor([IMG] * 4 + [1] * cfg.nc_det, device=dev)
    err_preds = check_close("[eval] det_preds auto vs off", p_auto / scale, p_off / scale,
                            BF16_TOL)
    # the seg probabilities: K1 adds no error beyond bf16 rounding, as in
    # phase 4: against the fp32 eager eval forward (no K1, no K7), the
    # kernel path may be at most 2x as far as the bf16 eager path (plus
    # 1e-3); both bf16 eval steps run K7 on the body's BNs. The head BNs
    # normalise with this batch's statistics, which amplifies the bf16
    # rounding of both paths: with random weights on an H100 the two paths
    # came 6.2e-2 apart, where phase 4's inference forward stays within 3e-2.
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    snap = state.bn_snapshot()
    ref32 = torch.sigmoid(eager_chain(model, lambda: model(
        batch["image"].float() / 255.0, train=False, mode="train"))["seg_logits"])
    state.bn_restore(snap)
    model.cfg = cfg
    e_auto = (a_auto["seg_prob"] - ref32).abs().max().item()
    e_off = (a_off["seg_prob"] - ref32).abs().max().item()
    err_prob = (a_auto["seg_prob"] - a_off["seg_prob"]).abs().max().item()
    if e_auto > 2.0 * e_off + 1e-3:
        raise RuntimeError(f"[eval] seg_prob: K1 path {e_auto:.3e} from fp32, eager bf16 "
                           f"{e_off:.3e}, bound {2.0 * e_off + 1e-3:.3e}")
    near = ((a_off["seg_prob"][..., 0] - 0.5).abs() <= 1.5 * BF16_TOL).float().mean().item()
    seg_apart = (a_auto["seg_mask"] != a_off["seg_mask"]).float().mean().item()
    count_apart = ((a_auto["seg_counts"] - a_off["seg_counts"]).abs().sum() / 2
                   / a_off["seg_counts"].sum()).item()
    if count_apart > EVAL_SEG_PIXELS:
        raise RuntimeError(f"[eval] seg_counts of auto and off differ in {count_apart:.3%} of "
                           f"the pixels, more than {EVAL_SEG_PIXELS:.0%}")
    kept = a_auto["nms_valid"].sum(1)
    if not bool((kept > 0).all()) or int(a_auto["cm_counts"].sum()) == 0:
        raise RuntimeError(f"[eval] NMS kept {kept.tolist()} boxes per image, cm_counts "
                           f"{a_auto['cm_counts'].tolist()}: the conditioning failed")
    log(f"[eval] class-bias shift {shift:.3f}; batch-{BATCH} eval step, auto vs off: losses "
        + ", ".join(f"{k} {m_auto[k].item():.5g}/{m_off[k].item():.5g}" for k in m_auto)
        + f"; cls_logits max_abs_err {err_logits:.3e}, det_preds (boxes in image sides) "
        f"{err_preds:.3e} (atol/rtol {BF16_TOL}); seg_prob {err_prob:.3e} apart, from the "
        f"fp32 eager forward {e_auto:.3e} (auto) / {e_off:.3e} (off); seg_counts apart "
        f"{count_apart:.4%} of the pixels (limit {EVAL_SEG_PIXELS:.0%}); seg mask pixels "
        f"flipped {seg_apart:.4%}, of {near:.2%} within {1.5 * BF16_TOL:.3g} of 0.5; NMS kept "
        f"{kept.tolist()}; cm_counts {a_auto['cm_counts'].tolist()}; BN statistics unchanged")

    times, dev_ms = {}, {}
    for mode in ("auto", "off", "off", "auto"):
        set_pallas(model, mode)
        times.setdefault(mode, []).append(cuda_ms(lambda: step(state, batch), iters=10,
                                                  warmup=2))
    for mode in ("auto", "off"):
        set_pallas(model, mode)
        dev_ms[mode] = device_total_ms(lambda: step(state, batch))
    set_pallas(model, "auto")
    log(f"[eval-time] batch-{BATCH} {IMG}^2 bf16 eval step (forward train=False mode=train, "
        f"TAL loss, decode, NMS at {EVAL_CONF}, seg and CM counts; CUDA events, two turns; "
        f"profiler device time): " + ", ".join(
            f"pallas={m} {times[m]} ms (mean {sum(times[m]) / 2:.3f}; device "
            f"{dev_ms[m]:.3f})" for m in ("auto", "off")) + f"; {card}")
    del state, step, batch, out, m_auto, a_auto, p_auto, m_off, a_off, p_off

    # the host's work of pass 1 alone: read, letterbox and copy every batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in BTXRDLoader(ds, BATCH, pad_last=True):
        to_device(b, dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0

    run_dir = work / "run"
    torch.cuda.reset_peak_memory_stats()
    cnb.convnext_block.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        metrics = evaluate.main([
            "--checkpoint-path", str(step_dir), "--root", str(root), "--split", "all",
            "--batch-size", str(BATCH), "--image-ext", ".png", "--epochs", "2",
            "--log-examples", "--map-thresholds", "1", "10", "100", "--run-dir", str(run_dir),
            "--nproc", "1"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = cnb.convnext_block.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = -(-EVAL_IMAGES // BATCH)
    if launches != 2 * batches * 15:
        raise RuntimeError(f"[evaluate] main launched K1 {launches} times, want "
                           f"{2 * batches * 15} (2 passes x {batches} batches x 15)")
    if set(metrics) != jax_evaluate_keys():
        raise RuntimeError(f"[evaluate] keys differ from the JAX CLI's: "
                           f"{sorted(set(metrics) ^ jax_evaluate_keys())}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"[evaluate] non-finite metrics: {metrics}")
    passes = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()
              if '"test_pass/pass"' in line]
    if len(passes) != 2:
        raise RuntimeError(f"[evaluate] {len(passes)} pass records, want 2")
    p1, p2 = ({k.split("/", 1)[1]: v for k, v in p.items() if k.startswith("test_pass/")}
              for p in passes)
    for k in metrics:
        if abs(p2[k] - p1[k]) > 1e-5 * max(abs(p1[k]), 1e-12) or p2[k] != metrics[k]:
            raise RuntimeError(f"[evaluate] {k}: pass 2 (replayed) {p2[k]} != pass 1 {p1[k]}")
    overlays = sorted((run_dir / "media").glob("*.png"))
    if len(overlays) < 8:
        raise RuntimeError(f"[evaluate] {len(overlays)} overlays written, want 8")
    for path in overlays:
        if read_png(path).shape != (IMG, IMG, 3):
            raise RuntimeError(f"[evaluate] overlay {path.name} does not read back")
    log(f"[evaluate] cli.evaluate.main over {EVAL_IMAGES} PNGs ({batches} batches of {BATCH}, "
        f"2 passes) in {main_s:.3f} s (checkpoint restore included): pass 1 "
        f"{p1['seconds']:.3f} s ({EVAL_IMAGES / p1['seconds']:.1f} img/s), its host work "
        f"(read PNG, letterbox, copy; measured alone) {host_s:.3f} s "
        f"({EVAL_IMAGES / host_s:.1f} img/s, {host_s / p1['seconds']:.1%} of pass 1); pass 2 "
        f"from the device cache {p2['seconds']:.3f} s ({EVAL_IMAGES / p2['seconds']:.1f} "
        f"img/s), equal to pass 1; {len(metrics)} keys as the JAX CLI's, finite; "
        f"{len(overlays)} overlays read back; K1 launches {launches}; peak device memory "
        f"{peak:.2f} GiB; {card}")
    log("[evaluate] metrics " + json.dumps({k: metrics[k] for k in sorted(metrics)}))
    if "[evaluate] pass 2" not in printed.getvalue():
        raise RuntimeError("[evaluate] main printed no second pass")
    return launches


TRAINER_IMAGES = 48  # the trainer phase's synthetic split: 38 train (4 steps of 8), 10 val
TRAINER_EPOCHS = 2
TRAINER_AUG = ("--hsv-h", "0.015", "--hsv-s", "0.7", "--hsv-v", "0.4", "--hflip", "0.5")
# cli.evaluate against the trainer's last validation: the same weights (the
# checkpoint's fp32 parameters and BN statistics, bit for bit), the same val
# batches in the same order, the same eval step and metric code on the same
# card; its eager convs and K1 are deterministic at fixed shapes, so the two
# passes compute the same numbers and 1e-6 leaves room only for printing
TRAINER_EVAL_TOL = 1e-6


def phase_trainer(cnb, k2, dev, card):
    """The training entry point on the card: ``cli.train.main`` in process
    (the full-width v1 model from its seed, 640^2, bf16, batch 8,
    ``pallas`` and ``block_bwd`` "auto", HSV and flip augmentation) for
    two epochs over a synthetic PNG split, then ``--resume auto --epochs 3``,
    then ``cli.evaluate.main`` on the last checkpoint against the trainer's
    last validation, then the mosaic / HSV / flip stage on the card against
    the CPU on fixed draws. Each train step must launch K1's saving form
    and K2 15 times and no K1, each validation forward K1 15 times and
    neither of the others. Returns the launches of the first run, (K1, K1
    saving, K2), and epochs 0's and 1's training rates (img/s)."""
    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
    from multitask_bonetumor_yolo_tpu_torch.cli import train as cli_train
    from multitask_bonetumor_yolo_tpu_torch.data import (
        BTXRD, BTXRDLoader, DataConfig, make_synthetic_btxrd, to_device)
    from multitask_bonetumor_yolo_tpu_torch.data import preprocess
    from multitask_bonetumor_yolo_tpu_torch.train import loop

    work = Path(__file__).resolve().parent / "build" / "trainer"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    t0 = time.perf_counter()
    root = make_synthetic_btxrd(str(work / "data"), n=TRAINER_IMAGES, seed=SEED, min_size=320,
                                max_size=960, rich=True)
    data_cfg = DataConfig(root=str(root), img_size=IMG, image_ext=".png", batch_size=TRAIN_BATCH)
    n_train, n_val = len(BTXRD(data_cfg, "train")), len(BTXRD(data_cfg, "val"))
    steps = n_train // TRAIN_BATCH
    log(f"[trainer] synthetic split: {TRAINER_IMAGES} PNGs (320-960 px, rich), {n_train} train "
        f"({steps} steps of {TRAIN_BATCH}) / {n_val} val, written in "
        f"{time.perf_counter() - t0:.2f} s")
    if steps < 3:
        raise RuntimeError(f"[trainer] {steps} steps per epoch, want at least 3")

    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    run_dir = work / "run"
    argv = ["--root", str(root), "--run-dir", str(run_dir), "--img-size", str(IMG),
            "--batch-size", str(TRAIN_BATCH), "--image-ext", ".png", "--log-every", "1", "--nproc", "1",
            *TRAINER_AUG]

    def run_main(extra):
        """``cli.train.main(argv + extra)`` with the launches (K1, K1 saving,
        K2) of each train step and each validation forward recorded around
        the step's call; returns (trainer, stdout, per-call launches, all
        launches, seconds)."""
        per_call = {"train": [], "eval": []}

        def counted(kind, make):
            def wrapped(*a, **k):
                step = make(*a, **k)

                def run(*args):
                    before = tuple(fn.launches for fn in counts)
                    out = step(*args)
                    per_call[kind].append(tuple(fn.launches - b for fn, b in zip(counts, before)))
                    return out
                return run
            return wrapped

        make_train, make_eval = loop.make_train_step, loop.make_eval_step
        loop.make_train_step = counted("train", make_train)
        loop.make_eval_step = counted("eval", make_eval)
        try:
            torch.cuda.synchronize()
            reset_counts(*counts)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                trainer = cli_train.main(argv + extra)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            loop.make_train_step, loop.make_eval_step = make_train, make_eval
        return (trainer, printed.getvalue(), per_call, tuple(fn.launches for fn in counts),
                secs)

    torch.cuda.reset_peak_memory_stats()
    trainer, printed, first_calls, launches, first_s = run_main(["--epochs", str(TRAINER_EPOCHS)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    if "[train] finished" not in printed:
        raise RuntimeError("[trainer] main did not finish")

    n_val_batches = -(-n_val // TRAIN_BATCH)
    want_train = [(0, 15, 15)] * (TRAINER_EPOCHS * steps)
    want_eval = [(15, 0, 0)] * (TRAINER_EPOCHS * n_val_batches)
    if first_calls["train"] != want_train or first_calls["eval"] != want_eval:
        raise RuntimeError(f"[trainer] launches (K1, K1 saving, K2) per train step "
                           f"{first_calls['train']}, per validation forward "
                           f"{first_calls['eval']}; want {want_train[0]} x {len(want_train)} "
                           f"and {want_eval[0]} x {len(want_eval)}")
    if launches != (15 * len(want_eval), 15 * len(want_train), 15 * len(want_train)):
        raise RuntimeError(f"[trainer] main launched (K1, K1 saving, K2) {launches} in all")
    if trainer.state.step != TRAINER_EPOCHS * steps:
        raise RuntimeError(f"[trainer] ended at step {trainer.state.step}")

    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    losses = [(r["step"], k, v) for r in recs for k, v in r.items()
              if "/loss_" in k or k.endswith("grad_norm")]
    bad = [x for x in losses if not np.isfinite(x[2])]
    if not losses or bad:
        raise RuntimeError(f"[trainer] non-finite logged losses {bad[:5]}")
    if any(r.get("train_step/step_skipped", 0.0) != 0.0 for r in recs):
        raise RuntimeError("[trainer] a train step was skipped")
    ckpt_dir = run_dir / "checkpoints"
    index = json.loads((ckpt_dir / "index.json").read_text())
    last = ckpt_dir / f"step_{TRAINER_EPOCHS * steps:08d}"
    if not (ckpt_dir / "config.json").exists() or last.name not in index \
            or not (last / "weights.npz").exists():
        raise RuntimeError(f"[trainer] checkpoints: index {sorted(index)}, want {last.name} "
                           "with config.json beside it")
    epochs = [{k.split("/")[1]: v for k, v in r.items() if k.startswith("train_epoch/")}
              for r in recs if "train_epoch/epoch" in r]
    for e in epochs:
        log(f"[trainer] epoch {int(e['epoch'])}: {e['epoch_time_s']:.3f} s, PhaseTimer split "
            + ", ".join(f"{k[6:-2]} {v:.3f} s" for k, v in e.items() if k.startswith("phase_"))
            + f"; {card}")
    e1 = epochs[1]
    # the epoch less its validation, checkpoint and overlays: the batches'
    # wait, the steps and the per-step log (one host copy, which waits for
    # the step's device work)
    train_s = e1["epoch_time_s"] - sum(e1.get(f"phase_{k}_s", 0.0)
                                       for k in ("validate", "checkpoint", "viz"))
    rate = steps * TRAIN_BATCH / train_s
    log(f"[trainer-time] cli.train.main, {TRAINER_EPOCHS} epochs of {steps} steps "
        f"(batch {TRAIN_BATCH}, {IMG}^2 bf16, HSV + flip, PNG input): {first_s:.3f} s in all; "
        f"epoch 1 trains at {rate:.2f} img/s (host clock, the epoch "
        f"less validation and checkpoint: {train_s:.3f} s, of which waiting for batches "
        f"{e1['phase_data_s']:.3f} s and issuing the steps {e1['phase_train_step_s']:.3f} s); "
        f"validation {epochs[0]['phase_validate_s']:.3f} s (epoch 0, primed) / "
        f"{e1['phase_validate_s']:.3f} s (epoch 1, replayed) for {n_val} images; checkpoint "
        f"{epochs[0]['phase_checkpoint_s']:.3f} / {e1['phase_checkpoint_s']:.3f} s; launches "
        f"(K1, K1 saving, K2) {launches}; peak device memory {peak:.2f} GiB; {card}")

    # --resume auto: epoch 2 from the saved step
    resumed, printed2, per_call, _, _ = run_main(["--epochs", str(TRAINER_EPOCHS + 1),
                                                  "--resume", "auto"])
    if f"resumed from step {TRAINER_EPOCHS * steps}" not in printed2:
        raise RuntimeError("[trainer] the second run did not resume from the last checkpoint")
    if resumed.state.step != (TRAINER_EPOCHS + 1) * steps:
        raise RuntimeError(f"[trainer] the resumed run ended at step {resumed.state.step}")
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    run2 = [r["train_epoch/epoch"] for r in recs if "train_epoch/epoch" in r][len(epochs):]
    if run2 != [TRAINER_EPOCHS] or per_call["train"] != [(0, 15, 15)] * steps:
        raise RuntimeError(f"[trainer] the resumed run trained epochs {run2}, launches "
                           f"{per_call['train']}")
    val = [{k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("val_epoch/")}
           for r in recs if "val_epoch/map_iou50_map" in r][-1]

    # cli.evaluate on the last checkpoint over the same val split
    last = ckpt_dir / f"step_{(TRAINER_EPOCHS + 1) * steps:08d}"
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = evaluate.main(["--checkpoint-path", str(last), "--root", str(root),
                                 "--split", "val", "--batch-size", str(TRAIN_BATCH), "--nproc", "1",
                                 "--image-ext", ".png", "--run-dir", str(work / "eval")])
    keys = ("map_iou50_map", "seg_dice", "img_accuracy", "loss_total")
    apart = {k: abs(metrics[k] - val[k]) for k in keys}
    if any(d > TRAINER_EVAL_TOL * max(1.0, abs(val[k])) for k, d in apart.items()):
        raise RuntimeError(f"[trainer] cli.evaluate {({k: metrics[k] for k in keys})} against "
                           f"the trainer's last validation {({k: val[k] for k in keys})}")
    log(f"[trainer] resumed at step {TRAINER_EPOCHS * steps}, trained epoch {TRAINER_EPOCHS} "
        f"to step {resumed.state.step}; cli.evaluate on {last.name}: "
        + ", ".join(f"{k} {metrics[k]:.6g} (trainer {val[k]:.6g})" for k in keys)
        + f", apart at most {max(apart.values()):.3g} (tolerance {TRAINER_EVAL_TOL})")
    del trainer, resumed

    # the mosaic, HSV and flip stage on the card against the CPU, fixed draws
    host = next(iter(BTXRDLoader(BTXRD(data_cfg, "train"), TRAIN_BATCH)))
    aug = preprocess.AugmentConfig(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5,
                                   mosaic_prob=0.5)
    gen = torch.Generator().manual_seed(SEED)
    draws = next(d for d in (preprocess.augment_draws(gen, aug, TRAIN_BATCH) for _ in range(64))
                 if d["gate"].tolist() == [True, False] and 0 < int(d["flip"].sum()) < 2)
    want = preprocess.augment_apply(to_device(host, "cpu"), aug, draws)
    got = preprocess.augment_apply(to_device(host, dev), aug,
                                   {k: v.to(dev) for k, v in draws.items()})
    for k in ("boxes", "box_valid", "mask", "img_cls", "id", "sample_valid"):
        if not torch.equal(got[k].cpu(), want[k]):
            raise RuntimeError(f"[trainer] augment_batch {k} on the card differs from the CPU")
    err = (got["image"].cpu() - want["image"]).abs().max().item()
    if not err <= 1e-5:
        raise RuntimeError(f"[trainer] augmented images on the card {err:.3e} from the CPU's")
    on_card = preprocess.augment_batch(to_device(host, dev),
                                       torch.Generator(device=dev).manual_seed(SEED), aug)
    log(f"[trainer] mosaic (one group of two used) + HSV + flip on the card against the CPU on "
        f"fixed draws: boxes, valid, masks, img_cls, id equal; images max_abs_err {err:.3e} "
        f"(limit 1e-5); with draws from a generator on the card: batch "
        f"{tuple(on_card['image'].shape)}")
    e0 = epochs[0]
    rate0 = steps * TRAIN_BATCH / (e0["epoch_time_s"] - sum(
        e0.get(f"phase_{k}_s", 0.0) for k in ("validate", "checkpoint", "viz")))
    return launches, (rate0, rate)


DDP_GLOBAL = 8  # the global batch of the step check (the train path's batch)
DDP_STEPS, DDP_TIMED = 2, 3  # checked steps, then timed ones
DDP_AUG = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5)  # TRAINER_AUG
# N ranks against 1 (relative; at most the bf16 kernel tolerance). bf16, the
# main path: the loss per step, grad_norm at step 1 (from the same weights),
# the BN statistics after both steps. fp32 (TF32 off, K1 and K2 in their
# fp32 designs), the same weights: the loss and grad_norm per step, p2 - p0
# on the elements whose gradient is strong, the noise-gradient biases' by
# their gradients, the BN statistics. In bf16 the trunk's gradient is mostly
# rounding noise (the neck's train-mode BNs cancel most of it), which
# depends on the order of the sums: one rank run twice already parts in
# p2 - p0 (printed beside the 2-rank figure, not held).
DDP_TOL = {"bf16": {"loss": 1e-2, "grad_norm": 3e-2, "bn": 1e-2},
           "fp32": {"loss": 1e-4, "grad_norm": 1e-3, "update": 3e-2, "noise_grad": 1e-3,
                    "bn": 1e-3},
           "evaluate": 3e-2}
DDP_STRONG = 0.3  # an element's update is held where |g| >= this x its tensor's RMS, both steps
DDP_ALLREDUCE_ITERS = 5


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN and matmuls inside the block (fp32 comparisons)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def ddp_route():
    """(ranks, backend): NCCL over every card when there are 2 or more, else
    two ranks sharing the one card over gloo (NCCL refuses that)."""
    n = torch.cuda.device_count()
    return (n, "nccl") if n >= 2 else (2, "gloo")


def ddp_state(dev, **over):
    """The full-width v1 train state (640^2, bf16, pallas and block_bwd
    "auto", or ``ModelConfig`` fields ``over``) from SEED with
    ``randomize``'s weights, alike on every rank."""
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
    from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig, create_train_state

    cfg = ModelConfig(**{"img_size": IMG, "dtype": "bfloat16", **over})
    model = build_model(cfg, seed=SEED, device=dev)
    randomize(model, torch.Generator(device=dev).manual_seed(SEED))
    return create_train_state(cfg, TrainConfig(), model=model)


def ddp_steps(dev, mesh, timed=False, **over) -> dict:
    """DDP_STEPS train steps of ``ddp_state(dev, **over)`` on ``mesh``'s rows
    of the global batch (``synthetic_batch`` from SEED, its mask as the
    loader's uint8), HSV and flip. Per step: the metrics, the launches (K1,
    K1 saving, K2) and the gradient the optimizer applied (summed over the
    ranks); then p2 - p0 and the BN statistics. ``timed``: also the upload's
    ms (``shard_batch``: this rank's rows, pinned, non-blocking), DDP_TIMED
    more steps' ms (CUDA events) and the all-reduce's ms for the gradient's
    bytes."""
    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.data.preprocess import AugmentConfig
    from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2
    from multitask_bonetumor_yolo_tpu_torch.parallel import dist, shard_batch
    from multitask_bonetumor_yolo_tpu_torch.train import make_train_step

    host = {k: v.numpy() for k, v in
            synthetic_batch(DDP_GLOBAL, IMG, torch.Generator().manual_seed(SEED)).items()}
    host["mask"] = host["mask"].astype(np.uint8)
    upload_ms = []
    for _ in range(5 if timed else 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = shard_batch(host, mesh)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    state = ddp_state(dev, **over)
    p0 = torch.cat([p.detach().reshape(-1).float() for p in state.params()])
    applied = []
    apply = state.apply_gradients

    def recording(grads, bn_before):
        applied.append(torch.cat([torch.zeros(p.numel(), device=p.device) if g is None
                                  else g.reshape(-1).float() for p, g in zip(state.params(), grads)]))
        return apply(grads, bn_before)

    state.apply_gradients = recording
    step = make_train_step(state.model.cfg, LossConfig(img_size=IMG), AugmentConfig(**DDP_AUG))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    metrics, launches = [], []
    for _ in range(DDP_STEPS):
        torch.cuda.synchronize()
        reset_counts(*counts)
        state, m, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        launches.append(tuple(fn.launches for fn in counts))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "launches": launches, "applied": [a.cpu() for a in applied],
           "names": [n for n, _ in state.model.named_parameters()],
           "sizes": [p.numel() for p in state.params()],
           "update": torch.cat([p.detach().reshape(-1).float() for p in state.params()]).sub(p0)
           .cpu(), "bn": state.bn_snapshot().cpu(), "upload_ms": float(np.median(upload_ms))}
    state.apply_gradients = apply
    if not timed:
        return out
    step_ms = []
    for _ in range(DDP_TIMED):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _, _ = step(state, batch, gen)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    out["step_ms"] = float(np.median(step_ms))
    flat = torch.zeros(p0.numel(), device=dev)
    ar_ms = []
    for _ in range(DDP_ALLREDUCE_ITERS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.sum_(flat)
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"], out["allreduce_bytes"] = float(np.median(ar_ms[1:])), flat.numel() * 4
    return out


def ddp_checks(dev, mesh) -> dict:
    """The step check's runs on ``mesh``: bf16 (the main path, timed) and
    fp32 with TF32 off, from the same weights."""
    out = {"bf16": ddp_steps(dev, mesh, timed=True)}
    with no_tf32():
        out["fp32"] = ddp_steps(dev, mesh, dtype="float32")
    return out


def ddp_evaluate(argv) -> tuple:
    """``cli.evaluate.main(argv)`` (TF32 off) and its K1 launches."""
    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb

    cnb.convnext_block.launches = 0
    with no_tf32(), contextlib.redirect_stdout(io.StringIO()):
        table = evaluate.main(argv)
    torch.cuda.synchronize()
    return table, cnb.convnext_block.launches


def ddp_rank(work: str, train_argv: list, eval_argv: list) -> None:
    """One rank of phase ``ddp``, in the group ``parallel.dist.spawn`` joined
    (torchrun's route: the CLIs run as this rank): ``cli.train.main``, the
    step checks on its rows, then ``cli.evaluate.main`` on the trained run's
    last checkpoint; the results to ``<work>/rank<r>.pt``, rank 0's console
    to ``<work>/train.log``."""
    from multitask_bonetumor_yolo_tpu_torch.cli import train as cli_train
    from multitask_bonetumor_yolo_tpu_torch.parallel import create_mesh, dist

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"device": str(dev)}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        cli_train.main(train_argv)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    if dist.is_main():
        (Path(work) / "train.log").write_text(printed.getvalue())
    out.update(ddp_checks(dev, create_mesh(device=dev)))
    out["evaluate"], out["eval_launches"] = ddp_evaluate(eval_argv + ["--checkpoint-path",
                                                                      str(ddp_last(work))])
    torch.save(out, Path(work) / f"rank{dist.rank()}.pt")


def ddp_last(work) -> Path:
    """The trained run's last checkpoint."""
    ckpt = Path(work) / "run" / "checkpoints"
    index = json.loads((ckpt / "index.json").read_text())
    return ckpt / max(index, key=lambda n: index[n]["step"])


def rel_norm(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


def trainer_split():
    """The trainer phase's synthetic PNG split (written anew when phase
    ``trainer`` did not run)."""
    from multitask_bonetumor_yolo_tpu_torch.data import make_synthetic_btxrd

    root = Path(__file__).resolve().parent / "build" / "trainer" / "data"
    if not (root / "img_cls.csv").exists():
        make_synthetic_btxrd(str(root), n=TRAINER_IMAGES, seed=SEED, min_size=320, max_size=960,
                             rich=True)
    return root


def ddp_compare(tag, got, one):
    """N ranks' run (rank 0's; every rank's launches) against one rank's
    (``ddp_steps``): the relative gaps DDP_TOL[tag] names."""
    import re

    two, tol = got[0][tag], DDP_TOL[tag]
    m2, m1 = two["metrics"], one["metrics"]
    apart = {"loss": max(abs(a["loss_total"] / b["loss_total"] - 1) for a, b in zip(m2, m1)),
             "grad_norm": max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                              for a, b in list(zip(m2, m1))[:1 if tag == "bf16" else None]),
             "bn": rel_norm(two["bn"], one["bn"])}
    noise = [bool(re.search(r"ConvBN_0\.Conv_0\.bias$", n)) for n in one["names"]]
    sizes = one["sizes"]
    strong = torch.ones(one["update"].numel(), dtype=torch.bool)
    for g1 in one["applied"]:
        strong &= torch.cat([
            torch.zeros_like(g, dtype=torch.bool) if z
            else (g.abs() >= DDP_STRONG * g.pow(2).mean().sqrt()) & (g != 0)
            for g, z in zip(g1.split(sizes), noise)])
    update = rel_norm(two["update"][strong], one["update"][strong])
    top = max(float(g.abs().max()) for g in one["applied"])
    noise_grad = max(float((a - b).abs().max()) / top
                     for ga, gb in zip(two["applied"], one["applied"])
                     for a, b, z in zip(ga.split(sizes), gb.split(sizes), noise) if z)
    if "update" in tol:
        apart["update"], apart["noise_grad"] = update, noise_grad
    want_launches = [(0, 15, 15)] * DDP_STEPS
    bad = [r for r, g in enumerate(got) if g[tag]["launches"] != want_launches]
    skipped = [m["step_skipped"] for m in m1 + m2]
    same = all(torch.equal(g[tag]["update"], two["update"]) and torch.equal(g[tag]["bn"], two["bn"])
               for g in got)
    if any(apart[k] > tol[k] for k in apart) or bad or any(skipped) or not same:
        raise RuntimeError(f"[ddp] {tag}, {len(got)} ranks against 1: apart {apart}, tolerances "
                           f"{tol}; launches of ranks {bad} {[g[tag]['launches'] for g in got]}, "
                           f"want {want_launches}; skipped {skipped}; ranks equal {same}")
    return apart, update, noise_grad, int(strong.sum()), strong.numel(), sum(noise)


def phase_ddp(dev, card, trainer_rates):
    """Data parallelism on the card(s): N ranks (``ddp_route``) against 1.

    N ranks spawned by ``parallel.dist.spawn`` (each joins the group and
    runs the CLIs as its rank, torchrun's route) each run
    ``cli.train.main`` for one epoch over the trainer phase's split
    (per-rank batch TRAIN_BATCH / N), ``ddp_checks`` on their rows of a
    global batch of DDP_GLOBAL and ``cli.evaluate.main`` on the trained
    checkpoint (fp32, split all); this process runs ``ddp_checks`` and
    ``cli.evaluate --nproc 1`` on one rank, and the bf16 steps once more
    (one rank's own spread). Checks: K1's saving form and K2 15 launches
    per step on every rank, K1 15 per evaluation forward on every rank;
    the gaps of DDP_TOL; the ranks' states equal bit for bit; the
    evaluation's every key within DDP_TOL["evaluate"] of max(1, |value|).
    Prints per rank the step's, the upload's and the gradient
    all-reduce's times, and epoch 0's rate beside the trainer phase's one
    rank. Returns the launches per rank (K1 per evaluation forward, K1
    saving and K2 per train step)."""
    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.parallel import create_mesh, dist

    ranks, backend = ddp_route()
    note = "" if backend == "nccl" else (" (two ranks share one card over gloo, which stages "
                                         "each collective through the host: not a multi-card "
                                         "speed figure)")
    log(f"[ddp] route: {ranks} ranks over {backend} on {torch.cuda.device_count()} card(s); "
        f"{card}")
    work = Path(__file__).resolve().parent / "build" / "ddp"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    work.mkdir(parents=True)
    root = trainer_split()
    per_rank = TRAIN_BATCH // ranks
    train = ["--root", str(root), "--run-dir", str(work / "run"), "--img-size", str(IMG),
             "--batch-size", str(per_rank), "--image-ext", ".png", "--log-every", "1",
             "--epochs", "1", *TRAINER_AUG]
    ev = ["--root", str(root), "--split", "all", "--image-ext", ".png", "--dtype", "float32",
          "--epochs", "1"]
    t0 = time.perf_counter()
    dist.spawn(ddp_rank, (str(work), train, ev + ["--run-dir", str(work / "evalN"),
                                                   "--batch-size", str(per_rank)]),
               ranks, str(work), device="cuda", backend=backend, deadline_s=900)
    spawn_s = time.perf_counter() - t0
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(ranks)]

    # cli.train on N ranks
    recs = [json.loads(line) for line in (work / "run" / "metrics.jsonl").open()]
    steps = [r for r in recs if "train_step/loss_total" in r]
    bad = [(r["step"], k, v) for r in recs for k, v in r.items()
           if ("/loss_" in k or k.endswith("grad_norm")) and not np.isfinite(v)]
    epochs = [{k.split("/")[1]: v for k, v in r.items() if k.startswith("train_epoch/")}
              for r in recs if "train_epoch/epoch" in r]
    last = ddp_last(work)
    if len(epochs) != 1 or not steps or bad or not (last / "weights.npz").exists() \
            or "[train] finished" not in (work / "train.log").read_text():
        raise RuntimeError(f"[ddp-train] epochs {len(epochs)}, {len(steps)} step records, "
                           f"non-finite {bad[:3]}, last checkpoint {last}")
    e0 = epochs[0]
    e0_train = e0["epoch_time_s"] - sum(e0.get(f"phase_{k}_s", 0.0)
                                        for k in ("validate", "checkpoint", "viz"))
    rate = len(steps) * TRAIN_BATCH / e0_train
    log(f"[ddp-train] cli.train.main on {ranks} ranks ({backend}), one epoch of {len(steps)} "
        f"steps of {TRAIN_BATCH} ({per_rank} per rank, {IMG}^2 bf16, HSV + flip) in "
        f"{got[0]['train_s']:.3f} s on rank 0; epoch 0 trains at {rate:.2f} img/s (host clock, "
        f"the epoch less validation, checkpoint and overlays: {e0_train:.3f} s, of which "
        f"waiting for batches {e0['phase_data_s']:.3f} s and issuing the steps "
        f"{e0['phase_train_step_s']:.3f} s: the first steps load the kernels and plan cuDNN) "
        f"beside the trainer phase's 1 rank at "
        + (f"{trainer_rates[0]:.2f} img/s in its epoch 0 ({trainer_rates[1]:.2f} in its epoch 1)"
           if trainer_rates else "(phase trainer not run)")
        + f"{note}; {last.name}; {card}")

    # the step checks: N ranks against 1
    one = ddp_checks(dev, create_mesh(device=dev, world_size=1, rank=0))
    again = ddp_steps(dev, create_mesh(device=dev, world_size=1, rank=0))
    for tag in ("bf16", "fp32"):
        apart, update, noise_grad, n_strong, n_all, n_noise = ddp_compare(tag, got, one[tag])
        for i, (a, b) in enumerate(zip(got[0][tag]["metrics"], one[tag]["metrics"])):
            log(f"[ddp] {tag} step {i + 1}: loss {a['loss_total']:.6f} on {ranks} ranks, "
                f"{b['loss_total']:.6f} on 1; grad_norm {a['grad_norm']:.6f} / "
                f"{b['grad_norm']:.6f}; num_pos {a['num_pos']:.0f} / {b['num_pos']:.0f}; "
                f"launches (K1, K1 saving, K2) per rank {[g[tag]['launches'][i] for g in got]}")
        floor = ""
        if tag == "bf16":
            floor = (f"; one rank run twice parts by {rel_norm(again['update'], one[tag]['update']):.3e} "
                     f"in p2 - p0 over all elements ({ranks} ranks against 1: "
                     f"{rel_norm(got[0][tag]['update'], one[tag]['update']):.3e}) and "
                     f"{rel_norm(again['applied'][0], one[tag]['applied'][0]):.3e} in step 1's "
                     f"gradient ({rel_norm(got[0][tag]['applied'][0], one[tag]['applied'][0]):.3e})")
        log(f"[ddp] {tag}, {ranks} ranks against 1 at the global batch {DDP_GLOBAL} ({IMG}^2, "
            f"full-width v1, HSV + flip, pallas and block_bwd auto), after {DDP_STEPS} steps: "
            + ", ".join(f"{k} {v:.3e}" for k, v in apart.items())
            + f" (held: tolerances {DDP_TOL[tag]}); p2 - p0 {update:.3e} on the {n_strong} of "
            f"{n_all} elements whose gradient is at least {DDP_STRONG} x its tensor's RMS at "
            f"both steps, the {n_noise} conv biases in front of a train-mode BN by their "
            f"gradients {noise_grad:.3e} of the largest gradient element{floor}; the ranks' "
            f"states equal bit for bit")

    # cli.evaluate: N ranks against 1
    want_eval, one_launches = ddp_evaluate(ev + ["--checkpoint-path", str(last), "--run-dir",
                                                 str(work / "eval1"), "--batch-size",
                                                 str(TRAIN_BATCH), "--nproc", "1"])
    keys = sorted(want_eval)
    two_eval = got[0]["evaluate"]
    eval_apart = {k: abs(two_eval[k] - want_eval[k]) / max(1.0, abs(want_eval[k])) for k in keys}
    n_images = next(json.loads(line) for line in (work / "eval1" / "metrics.jsonl").open()
                    )["test_pass/images"]
    forwards = -(-int(n_images) // TRAIN_BATCH)
    if sorted(two_eval) != keys or max(eval_apart.values()) > DDP_TOL["evaluate"] \
            or any(g["eval_launches"] != 15 * forwards for g in got) \
            or one_launches != 15 * forwards \
            or any(g["evaluate"] != two_eval for g in got):
        raise RuntimeError(f"[ddp-evaluate] {ranks} ranks against 1: apart "
                           f"{ {k: v for k, v in eval_apart.items() if v > DDP_TOL['evaluate']} }, "
                           f"K1 launches per rank {[g['eval_launches'] for g in got]} and on one "
                           f"{one_launches} (want {15 * forwards})")
    worst = max(eval_apart, key=eval_apart.get)
    log(f"[ddp-evaluate] cli.evaluate on {last.name} over {int(n_images)} images (fp32, TF32 "
        f"off, global batch {TRAIN_BATCH}): {ranks} ranks against 1, every one of the "
        f"{len(keys)} keys within {eval_apart[worst]:.3e} ({worst}; tolerance "
        f"{DDP_TOL['evaluate']} of max(1, |value|)); loss_total {two_eval['loss_total']:.6f} / "
        f"{want_eval['loss_total']:.6f}, seg_dice {two_eval['seg_dice']:.6f} / "
        f"{want_eval['seg_dice']:.6f}, map_iou50_map {two_eval['map_iou50_map']:.6f} / "
        f"{want_eval['map_iou50_map']:.6f}; K1 launches per rank "
        f"{[g['eval_launches'] for g in got]}, {one_launches} on one ({forwards} forwards)")
    for r, g in enumerate(got):
        b = g["bf16"]
        log(f"[ddp-time] rank {r} on {g['device']}: step {b['step_ms']:.3f} ms (bf16, CUDA "
            f"events, median of {DDP_TIMED}, {DDP_GLOBAL // ranks} rows); upload "
            f"{b['upload_ms']:.3f} ms (shard_batch of its rows: {IMG}^2 uint8 images and masks, "
            f"pinned, non-blocking; median of 5); gradient all-reduce {b['allreduce_ms']:.3f} ms "
            f"for {b['allreduce_bytes']} bytes ({b['allreduce_bytes'] // 4} fp32 parameters; "
            f"host clock, median of {DDP_ALLREDUCE_ITERS}){note}; {card}")
    b = one["bf16"]
    log(f"[ddp-time] 1 rank: step {b['step_ms']:.3f} ms ({DDP_GLOBAL} rows), upload "
        f"{b['upload_ms']:.3f} ms; the spawned ranks' run {spawn_s:.3f} s; {card}")
    return (got[0]["eval_launches"] // forwards, *got[0]["bf16"]["launches"][0][1:])


RAW_IMAGES = 24  # make_synthetic_raw's split: the JAX function's 300-600 px JPEGs
RAW_BIG = (2560, 2048)  # H, W of the two radiograph-sized JPEGs (colour 4:2:0 and grey)
RAW_LOADER_TURNS = ("jpeg", "png", "png", "jpeg")


def radiograph(h, w, seed):
    """A seeded radiograph-like uint8 RGB image: a bright band on a smooth
    background with noise (libjpeg's encoder keeps most AC of it at 95)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (90 + 60 * np.exp(-((xx - w / 2) / (0.18 * w)) ** 2) + 30 * np.sin(yy / 97.0)
            + rs.randn(h, w).astype(np.float32) * 6)
    return np.clip(np.stack([base, base * 0.97 + 4, base * 0.94 + 8], -1), 0, 255).astype(np.uint8)


def with_exif(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 Exif segment holding the orientation tag."""
    import struct

    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def k6_bounds(lay):
    """(bound_ms, bound_by) of K6a and K6b for one read of layout ``lay``:
    K6a reads the needed components' coefficients (2 bytes each) and writes
    their planes, ~1,400 32-bit integer operations per block (two passes of
    eight 1-D IDCTs, the dequantisation and the range limit); K6b reads the
    planes once and writes the pixels, ~30 operations per output value. The
    integer operations are held to the fp32 rate outside the tensor cores."""
    pixels = lay.height * lay.width * lay.channels
    a = bound(lay.blocks * 128 + lay.plane_bytes, 0, 1400 * lay.blocks)
    b = bound(lay.plane_bytes + pixels, 0, 30 * pixels)
    return a, b


def phase_raw(cnb, dev, gen, card):
    """What a user does on the first day, from raw BTXRD on the card's
    machine: ``make_synthetic_raw`` (24 JPEGs, 300-600 px, by the port's
    writer) and two 2560x2048 JPEGs (colour 4:2:0 and grey); the CLIs
    ``prepare_data``, ``wrangle`` and ``show_sample``; K6 (the C entropy
    decoder, K6a and K6b) against its plain version on every image in
    colour and grey reads (0 differing bytes), the C entropy decoder
    against the Python one on two small images, an Exif orientation; "[jpeg]"
    ms per image by part at both sizes; "[raw-loader]" ``BTXRD.__getitem__``
    on the JPEG split against the same pixels as PNG; then the full-width v1
    model (seeded random weights, conditioned as the eval phase does) through
    ``cli.infer.main`` with overlays and ``cli.evaluate.main --image-ext
    .jpeg`` over the converted split, K1's and K6's launches counted.
    Returns the kernels line's K6 entries."""
    import shutil
    import statistics

    import numpy as np

    from multitask_bonetumor_yolo_tpu_torch.bridge import save_npz, torch_to_flax
    from multitask_bonetumor_yolo_tpu_torch.cli import (
        evaluate, infer, prepare_data, show_sample, wrangle)
    from multitask_bonetumor_yolo_tpu_torch.data import (
        BTXRD, BTXRDLoader, DataConfig, jpeg, make_synthetic_raw, to_device)
    from multitask_bonetumor_yolo_tpu_torch.data.imageio import read_png, write_png
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import jpeg as k6

    work = Path(__file__).resolve().parent / "build" / "raw"
    if work.exists():
        shutil.rmtree(work)
    t0 = time.perf_counter()
    raw = make_synthetic_raw(str(work / "raw"), n=RAW_IMAGES, seed=SEED)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = {}
    for name, gray in (("big_colour", False), ("big_grey", True)):
        img = radiograph(*RAW_BIG, seed=SEED)
        big[name] = work / f"{name}.jpeg"
        jpeg.write_jpeg(big[name], img[..., 0] if gray else img)
    big_s = time.perf_counter() - t0
    small = sorted((raw / "images").glob("*.jpeg"))
    log(f"[prepare] raw split: {RAW_IMAGES} labelme JSONs + JPEGs (300-600 px, quality 95, "
        f"4:2:0; {sum(p.stat().st_size for p in small) / 2**20:.2f} MiB) written in {raw_s:.2f} s; "
        f"two {RAW_BIG[0]}x{RAW_BIG[1]} JPEGs (colour 4:2:0, grey; "
        f"{', '.join(f'{p.stat().st_size / 2**20:.2f}' for p in big.values())} MiB) in "
        f"{big_s:.2f} s (the port's writer, host)")

    # the data-preparation CLIs
    ready = work / "ready"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        prepare_data.main(["--src", str(raw), "--meta", str(raw / "dataset.csv"), "--dst",
                           str(ready), "--emit-seg-polygons"])
    prep_s = time.perf_counter() - t0
    converted = sorted((ready / "images").glob("*.jpeg"))
    counts = {d: len(list((ready / d).iterdir())) for d in ("images", "labels_det", "masks",
                                                              "labels_seg")}
    if len(converted) != RAW_IMAGES or set(counts.values()) != {RAW_IMAGES} or \
            f"Converted {RAW_IMAGES}/{RAW_IMAGES}" not in said.getvalue():
        raise RuntimeError(f"[prepare] convert gave {counts}: {said.getvalue()!r}")
    masks = [read_png(p)[..., 0] for p in sorted((ready / "masks").glob("*.png"))]
    if not all(m.max() == 255 and set(np.unique(m)) <= {0, 255} for m in masks):
        raise RuntimeError("[prepare] a mask is empty or not binary 0/255")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rows = wrangle.main(["--src", str(raw), "--meta", str(raw / "dataset.csv"), "--out",
                             str(work / "merged_annotations.csv")])
    wrangle_s = time.perf_counter() - t0
    if rows != 2 * RAW_IMAGES:
        raise RuntimeError(f"[prepare] wrangle wrote {rows} rows, want {2 * RAW_IMAGES}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        show_sample.main(["--root", str(ready), "--split", "all", "--index", "0",
                          "--img-size", str(IMG), "--out", str(work / "sample.png")])
    show_s = time.perf_counter() - t0
    if read_png(work / "sample.png").shape != (IMG, IMG, 3) or "box(es)" not in said.getvalue():
        raise RuntimeError(f"[prepare] show_sample: {said.getvalue()!r}")
    log(f"[prepare] cli.prepare_data (--emit-seg-polygons) in {prep_s:.3f} s: "
        f"{counts} (masks binary, 255 inside); cli.wrangle {rows} rows in {wrangle_s:.3f} s; "
        f"cli.show_sample (JPEG decoded on the card) in {show_s:.3f} s: "
        f"{said.getvalue().strip()}")

    # K6 against its plain version on every image, colour and grey reads
    files = small + list(big.values())
    diff_bytes, max_err, reads = 0, 0, 0
    for path in files:
        data = path.read_bytes()
        frame = jpeg.parse(data)
        coefs = k6.entropy_decode(data, frame).to(dev)
        qt = jpeg.quant_tables(frame)
        for gray in (False, True):
            lay = jpeg.layout(frame, gray)
            got = k6.jpeg_color(k6.jpeg_idct(coefs, qt, lay), lay)
            want = k6.jpeg_color_plain(k6.jpeg_idct_plain(coefs, qt, lay), lay)
            route = torch.from_numpy(k6.decode_jpeg(data, gray=gray, device=dev)).to(dev)
            torch.cuda.synchronize()
            if got.shape != want.shape or route.shape != want.shape:
                raise RuntimeError(f"[jpeg-check] {path.name}: shapes {tuple(got.shape)}, "
                                   f"{tuple(route.shape)}, plain {tuple(want.shape)}")
            diff_bytes += int((got != want).sum()) + int((route != want).sum())
            max_err = max(max_err, int((got.int() - want.int()).abs().max()))
            reads += 1
    if diff_bytes:
        raise RuntimeError(f"[jpeg-check] K6 differs from its plain version in {diff_bytes} bytes")
    for path in small[:2]:
        data = path.read_bytes()
        frame = jpeg.parse(data)
        if not np.array_equal(k6.entropy_decode(data, frame).numpy(),
                              jpeg.entropy_decode_py(data, frame)):
            raise RuntimeError(f"[jpeg-check] {path.name}: the C entropy decoder differs "
                               "from the Python one")
    data = small[0].read_bytes()
    upright = k6.decode_jpeg(data, device=dev)
    turned = k6.decode_jpeg(with_exif(data, 6), device=dev)
    if not np.array_equal(turned, np.swapaxes(upright, 0, 1)[:, ::-1]):
        raise RuntimeError("[jpeg-check] Exif orientation 6 was not applied")
    log(f"[jpeg-check] K6 (C entropy decoder, K6a, K6b) against its plain version on the "
        f"card over {len(files)} images x colour/grey ({reads} reads): 0 differing bytes "
        f"(max |diff| {max_err}); the C entropy decoder equal to the Python one on "
        f"{small[0].name} and {small[1].name}; Exif orientation 6 turns "
        f"{upright.shape[:2]} into {turned.shape[:2]}")

    # "[jpeg]": one read by parts, at both sizes
    def read_parts(data, gray, n=5):
        parts = []
        for _ in range(n + 1):
            times = {}
            t0 = time.perf_counter()
            frame = jpeg.parse(data)
            lay = jpeg.layout(frame, gray)
            parse_ms = (time.perf_counter() - t0) * 1e3
            k6.decode_on_card(data, frame, lay, jpeg.quant_tables(frame), dev, times)
            times["parse"] = parse_ms
            times["total"] = (time.perf_counter() - t0) * 1e3
            parts.append(times)
        return {k: statistics.median(p[k] for p in parts[1:]) for k in parts[0]}

    jpeg_rows, k6_entry = [], {}
    for label, path, gray in (("small", small[0], False), ("big colour", big["big_colour"], False),
                              ("big grey", big["big_grey"], True)):
        data = path.read_bytes()
        frame = jpeg.parse(data)
        lay = jpeg.layout(frame, gray)
        qt = jpeg.quant_tables(frame)
        coefs = k6.entropy_decode(data, frame).to(dev)
        planes = k6.jpeg_idct(coefs, qt, lay)
        parts = read_parts(data, gray)
        ms_a = cuda_ms(lambda: k6.jpeg_idct(coefs, qt, lay))
        ms_b = cuda_ms(lambda: k6.jpeg_color(planes, lay))
        dev_a = device_ms(lambda: k6.jpeg_idct(coefs, qt, lay), "jpeg_idct_kernel", launches=1)
        dev_b = device_ms(lambda: k6.jpeg_color(planes, lay), "jpeg_color_kernel", launches=1)
        plain_a = cuda_ms(lambda: k6.jpeg_idct_plain(coefs, qt, lay), iters=5)
        plain_b = cuda_ms(lambda: k6.jpeg_color_plain(planes, lay), iters=5)
        (b_a, by_a), (b_b, by_b) = k6_bounds(lay)
        row = {"image": label, "shape": [lay.height, lay.width], "gray": gray,
               "bytes": len(data), "blocks": lay.blocks, "ms_by_part": parts,
               "jpeg_idct": {"ms": ms_a, "device_ms": dev_a, "plain_ms": plain_a,
                             "bound_ms": b_a, "bound_by": by_a},
               "jpeg_color": {"ms": ms_b, "device_ms": dev_b, "plain_ms": plain_b,
                              "bound_ms": b_b, "bound_by": by_b}}
        jpeg_rows.append(row)
        log(f"[jpeg] {label} {lay.height}x{lay.width}{' grey' if gray else ''} "
            f"({len(data) / 2**20:.2f} MiB, {lay.blocks} blocks): per read (median of 5, ms) "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; K6a {ms_a:.4f} (events) / {dev_a:.4f} (device) beside its bound {b_a:.4f} "
            f"({by_a}) and its plain version {plain_a:.3f}; K6b {ms_b:.4f} / {dev_b:.4f} beside "
            f"{b_b:.4f} ({by_b}) and {plain_b:.3f}; {card}")
        if label == "big colour":
            k6_entry = row
    t0 = time.perf_counter()
    frame = jpeg.parse(small[0].read_bytes())
    jpeg.entropy_decode_py(small[0].read_bytes(), frame)
    py_ms = (time.perf_counter() - t0) * 1e3
    log(f"[jpeg] the plain version's Python entropy decoder on {small[0].name}: {py_ms:.1f} ms "
        f"(host), against the C decoder's {jpeg_rows[0]['ms_by_part']['entropy']:.3f} ms")

    # "[raw-loader]": BTXRD.__getitem__ on the JPEG split against the same pixels as PNG
    png_root = work / "ready_png"
    for d in ("labels_det", "masks"):
        shutil.copytree(ready / d, png_root / d)
    (png_root / "images").mkdir()
    for p in converted:
        write_png(png_root / "images" / f"{p.stem}.png", k6.read_jpeg(p, device=dev), level=1)
    (png_root / "img_cls.csv").write_text((ready / "img_cls.csv").read_text()
                                          .replace(".jpeg,", ".png,"))
    sets = {ext: BTXRD(DataConfig(root=str(root), img_size=IMG, image_ext=f".{ext}"), "all",
                       device=dev)
            for ext, root in (("jpeg", ready), ("png", png_root))}
    for i in range(len(sets["jpeg"])):
        a, b = sets["jpeg"][i], sets["png"][i]
        if not all(np.array_equal(a[k], b[k]) for k in a):
            raise RuntimeError(f"[raw-loader] item {i}: the JPEG and PNG splits differ")
    rates = {}
    for ext in RAW_LOADER_TURNS:
        ds = sets[ext]
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        rates.setdefault(ext, []).append(len(ds) / (time.perf_counter() - t0))
    log(f"[raw-loader] BTXRD.__getitem__ over the {len(converted)} converted images "
        f"(read, letterbox to {IMG}, mask, labels; one thread), turns "
        f"{' '.join(RAW_LOADER_TURNS)}: JPEG (decoded on the card) {rates['jpeg']} img/s, the "
        f"same pixels as PNG (the port's codec, zlib level 1) {rates['png']} img/s; items equal")

    # the model over the JPEG split: cli.infer with overlays, cli.evaluate
    cfg = ModelConfig(img_size=IMG, dtype="bfloat16")
    model = build_model(cfg, seed=SEED, device=dev)
    randomize(model, gen)
    data_cfg = DataConfig(root=str(ready), img_size=IMG, image_ext=".jpeg", batch_size=BATCH)
    host = next(iter(BTXRDLoader(BTXRD(data_cfg, "all", device=dev), BATCH, pad_last=True)))
    images = to_device(host, dev)["image"]
    state, shift, _, step_dir = save_for_eval(model, images, work / "checkpoints", data_cfg)
    # cli.infer's forward normalises with the BN running statistics, the eval
    # forward with the batch's: serve at the confidence that passes
    # CANDIDATES anchors per image in the inference forward, as phase 4 does
    with torch.no_grad():
        scores = model(images.float() / 255.0)["det_preds"][..., 4:].amax(-1)
    conf = torch.quantile(scores.float().flatten(), 1.0 - CANDIDATES / scores.shape[1]).item()
    ckpt = work / "weights.npz"
    save_npz(str(ckpt), *torch_to_flax(model.state_dict()))
    del state, model, host, images, scores
    torch.cuda.empty_cache()
    counts = (cnb.convnext_block, k6.jpeg_idct, k6.jpeg_color)
    for c in counts:
        c.launches = 0
    out = work / "infer"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        infer.main(["--checkpoint-path", str(ckpt), "--images", *map(str, converted),
                    "--out-dir", str(out), "--img-size", str(IMG), "--conf-thresh",
                    repr(conf)])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_launches = [c.launches for c in counts]
    records = json.loads((out / "predictions.json").read_text())
    overlays = sorted((out / "media").glob("*.png"))
    n = len(converted)
    if infer_launches != [15 * n, n, n] or len(records) != n or len(overlays) != 2 * n:
        raise RuntimeError(f"[raw-infer] launches (K1, K6a, K6b) {infer_launches}, want "
                           f"{[15 * n, n, n]}; {len(records)} records, {len(overlays)} overlays")
    if not all(read_png(p).shape == (IMG, IMG, 3) for p in overlays):
        raise RuntimeError("[raw-infer] an overlay does not read back")
    dets = [r["num_detections"] for r in records]
    if not all(np.isfinite(r["img_cls_probs"]).all() for r in records) or sum(dets) == 0:
        raise RuntimeError(f"[raw-infer] detections {dets}, or non-finite class probabilities")
    log(f"[raw-infer] cli.infer.main on the {n} converted JPEGs at conf {conf:.4g} (~{CANDIDATES} "
        f"anchors per image; weights conditioned for evaluation, class-bias shift {shift:.3f}) "
        f"in {infer_s:.3f} s (checkpoint load, first "
        f"calls and {2 * n} overlay PNGs included): detections {dets}; launches K1 "
        f"{infer_launches[0]} (15 per image), K6a {infer_launches[1]}, K6b {infer_launches[2]}")
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = evaluate.main([
            "--checkpoint-path", str(step_dir), "--root", str(ready), "--split", "all",
            "--batch-size", str(BATCH), "--image-ext", ".jpeg", "--run-dir", str(work / "eval"),
            "--log-examples", "--nproc", "1"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = [c.launches for c in counts]
    batches = -(-n // BATCH)
    if eval_launches != [15 * batches, n, n]:
        raise RuntimeError(f"[raw-evaluate] launches (K1, K6a, K6b) {eval_launches}, want "
                           f"{[15 * batches, n, n]}")
    if set(metrics) != jax_evaluate_keys() or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"[raw-evaluate] keys or values: {metrics}")
    log(f"[raw-evaluate] cli.evaluate.main --image-ext .jpeg over the {n} converted JPEGs "
        f"({batches} batches of {BATCH}) in {eval_s:.3f} s: launches K1 {eval_launches[0]}, K6a "
        f"{eval_launches[1]}, K6b {eval_launches[2]}; {len(metrics)} keys as the JAX CLI's, "
        f"finite; box mAP50 {metrics['map_iou50_map']:.4g}, seg Dice {metrics['seg_dice']:.4g}; "
        f"{card}")

    common = {"route": "cuda", "library_ms": None,
              "source": "multitask_bonetumor_yolo_tpu_torch/csrc/jpeg.cu",
              "replaces": "multitask_bonetumor_yolo_tpu/data/dataset.py:67 (cv2.imread on the "
                          "host; no TPU kernel)",
              "max_abs_err": max_err, "shape": k6_entry["shape"]}
    return [{"name": name, **common,
             "launches": infer_launches[i] + eval_launches[i],
             "infer_launches": infer_launches[i], "eval_launches": eval_launches[i],
             "ms": k6_entry[name]["ms"], "device_ms": k6_entry[name]["device_ms"],
             "plain_ms": k6_entry[name]["plain_ms"], "bound_ms": k6_entry[name]["bound_ms"],
             "bound_by": k6_entry[name]["bound_by"],
             "per_image": [{"image": r["image"], "shape": r["shape"], "gray": r["gray"],
                            **r[name]} for r in jpeg_rows]}
            for i, name in ((1, "jpeg_idct"), (2, "jpeg_color"))], jpeg_rows


def check_grads(name, got, want, tol):
    """dx elementwise (atol/rtol tol); each parameter gradient, a sum over
    every pixel, to tol of its own scale. Returns (dx max abs err, largest
    gradient error over its scale)."""
    err_dx = check_close(f"{name} dx", got[0], want[0], tol)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not torch.isfinite(a).all() or err > tol * scale:
            raise RuntimeError(f"{name} gradient {i}: max abs err {err:.3e} > {tol} x {scale:.3e}")
        worst = max(worst, err / scale)
    return err_dx, worst


TOOLS_ITERS = {"bench_block": 2, "profile_infer": 2, "profile_train": 1}  # timeloop's n


def run_tool(name, argv):
    """``tools.<name>.main(argv)`` in process, its printed lines logged
    behind "[tools]"; returns what main returns."""
    import importlib

    mod = importlib.import_module(f"multitask_bonetumor_yolo_tpu_torch.tools.{name}")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = mod.main(argv)
    for line in printed.getvalue().splitlines():
        if line.strip():
            log(f"[tools] {name}: {line.rstrip()}")
    return out


def check_launches(where, got, want):
    if got != want:
        raise RuntimeError(f"[tools] {where}: launches per call {got}, want {want}")


def phase_tools(card):
    """The profiling tools at full width on the card (phase 18). Returns
    {tool: seconds}."""
    secs = {}
    t0 = time.perf_counter()
    bench = run_tool("bench_block", ["--iters", str(TOOLS_ITERS["bench_block"])])
    secs["bench_block"] = time.perf_counter() - t0
    for si, row in bench.items():
        check_launches(f"bench_block stage {si}", row["launches"], {"K1": 1.0})
        if not row["maxdiff"] <= BF16_TOL * (1.0 + row["scale"]):
            raise RuntimeError(f"[tools] bench_block stage {si}: K1 {row['maxdiff']:.4f} from the "
                               f"eager block, |y|max {row['scale']:.2f}, tolerance {BF16_TOL}")

    t0 = time.perf_counter()
    rows = run_tool("profile_infer", ["--iters", str(TOOLS_ITERS["profile_infer"])])
    secs["profile_infer"] = time.perf_counter() - t0
    k1 = {"FULL multitask infer (model+decode+NMS)": 15, "TRUNK total": 15,
          "BACKBONE (trunk + 3 C2f adapters)": 15}
    k7 = {"FULL multitask infer (model+decode+NMS)": K7_PER_FORWARD["v1"],
          "BACKBONE (trunk + 3 C2f adapters)": 18, "BiFPN x2": 59, "Segment head": 21,
          "Detect head": 12}
    for row in rows:
        n = k1.get(row["name"], 1 if row["name"].startswith("stage") else 0)
        want = {"K1": n} if n else {}
        if row["name"] in k7:
            want["K7"] = k7[row["name"]]
        check_launches(f"profile_infer {row['name']}", row["launches"], want)
    full = rows[0]
    if not 0 < full["device_ms"] <= full["ms"] * 1.5:
        raise RuntimeError(f"[tools] profile_infer: FULL device time {full['device_ms']} ms "
                           f"against {full['ms']} ms by events")

    t0 = time.perf_counter()
    rows = run_tool("profile_train", ["--iters", str(TOOLS_ITERS["profile_train"])])
    secs["profile_train"] = time.perf_counter() - t0
    fused = {"K1 saving": 15, "K2": 15}
    want = {"FULL train step (fwd+bwd+AdamW, no donate)": fused,
            "fwd+bwd (value_and_grad, no opt)": fused, "forward + loss only": {"K1": 15},
            "forward only (train mode, no loss)": {"K1": 15},
            "BACKBONE fwd+bwd (trunk + C2f)": fused}
    routes = {"ref": {"K1": 1}, "eager": {}, "fused_v1": {"K1": 1, "K4": 1},
              "fused": {"K1 saving": 1, "K2": 1}}
    for row in rows:
        check_launches(f"profile_train {row['name']}", row["launches"],
                       {k: float(v) for k, v in want.get(row["name"], {}).items()}
                       if "routes" not in row else {k: float(v) for k, v in routes["ref"].items()})
        for route, got in row.get("route_launches", {}).items():
            check_launches(f"profile_train {row['name']} {route}", got,
                           {k: float(v) for k, v in routes[route].items()})
    if sum(1 for row in rows if "routes" in row) != len(STAGES):
        raise RuntimeError("[tools] profile_train: not one row per stage")
    log(f"[tools] seconds: {json.dumps({k: round(v, 1) for k, v in secs.items()})}; timeloop "
        f"n per tool {json.dumps(TOOLS_ITERS)}; {card}")
    return secs


RECIPE_IMAGES = 24  # the recipe phase's split: 20 train (2 steps of 8), 4 val
RECIPE_EPOCHS = 2


def phase_recipe(cnb, k2, card):
    """The quality-parity recipe cut to size, then the diagnosis (phase 19).
    Returns the seconds of the recipe and of the diagnosis."""
    from multitask_bonetumor_yolo_tpu_torch import train as train_pkg
    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
    from multitask_bonetumor_yolo_tpu_torch.data import dataset
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import jpeg as k6
    from multitask_bonetumor_yolo_tpu_torch.tools import diagnose_det, train_synthetic
    from multitask_bonetumor_yolo_tpu_torch.train import loop

    work = Path(__file__).resolve().parent / "build" / "recipe"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    per_call = {"train": [], "eval": []}
    reads = [0]

    def counted(kind, make):
        def wrapped(*a, **k):
            step = make(*a, **k)

            def run(*args):
                before = tuple(fn.launches for fn in counts)
                out = step(*args)
                per_call[kind].append(tuple(fn.launches - b for fn, b in zip(counts, before)))
                return out
            return run
        return wrapped

    read_image = dataset.read_image

    def counted_read(*a, **k):
        reads[0] += 1
        return read_image(*a, **k)

    patched = [(loop, "make_train_step", counted("train", loop.make_train_step)),
               (loop, "make_eval_step", counted("eval", loop.make_eval_step)),
               (evaluate, "make_eval_step", counted("eval", evaluate.make_eval_step)),
               (train_pkg, "make_eval_step", counted("eval", train_pkg.make_eval_step)),
               (dataset, "read_image", counted_read)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    try:
        reset_counts(*counts, k6.jpeg_idct, k6.jpeg_color)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            table = train_synthetic.main([
                "--variant", "v1", "--epochs", str(RECIPE_EPOCHS), "--n-images",
                str(RECIPE_IMAGES), "--assigner", "tal", "--eval-bn", "frozen",
                "--data-dir", str(work / "data"), "--run-dir", str(work / "run")])
        recipe_s = time.perf_counter() - t0
        n_train_steps, n_eval = len(per_call["train"]), len(per_call["eval"])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as diag:
            maps = diagnose_det.main(["--run-dir", str(work / "run"), "--root",
                                      str(work / "data")])
        diag_s = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    text = printed.getvalue()
    if "[train] finished" not in text or "[eval] best checkpoint" not in text:
        raise RuntimeError("[recipe] train_synthetic did not train and evaluate")
    if per_call["train"] != [(0, 15, 15)] * n_train_steps or n_train_steps != 2 * RECIPE_EPOCHS:
        raise RuntimeError(f"[recipe] launches (K1, K1 saving, K2) per train step "
                           f"{per_call['train']}")
    if not per_call["eval"] or any(c != (15, 0, 0) for c in per_call["eval"]) \
            or len(per_call["eval"]) == n_eval:
        raise RuntimeError(f"[recipe] launches (K1, K1 saving, K2) per eval forward "
                           f"{per_call['eval']} (recipe {n_eval})")
    k6_launches = (k6.jpeg_idct.launches, k6.jpeg_color.launches)
    if k6_launches != (reads[0], reads[0]) or reads[0] < RECIPE_IMAGES:
        raise RuntimeError(f"[recipe] K6a, K6b launches {k6_launches} for {reads[0]} image reads")
    keys = ("map_iou50_map", "map_iou50_95_map", "seg_dice", "img_accuracy", "loss_total")
    bad = {k: table.get(k) for k in keys if not (k in table and math.isfinite(table[k]))}
    if bad:
        raise RuntimeError(f"[recipe] cli.evaluate's table: {bad}")
    lines = diag.getvalue().splitlines()
    if not any(ln.startswith("[diag] restored") for ln in lines) \
            or not lines[-1].startswith("class-AGNOSTIC mAP50:"):
        raise RuntimeError("[recipe] diagnose_det printed no diagnosis")
    log(f"[recipe] train_synthetic ({RECIPE_IMAGES} JPEGs of 480-800 px, {RECIPE_EPOCHS} epochs "
        f"of {n_train_steps // RECIPE_EPOCHS} steps of 8 at 640^2, TAL, frozen BN): "
        f"{recipe_s:.1f} s with the data written; cli.evaluate on the best checkpoint: "
        + ", ".join(f"{k} {table[k]:.4g}" for k in keys)
        + f"; diagnose_det {diag_s:.1f} s: class-aware mAP50 {maps['class_aware']}, "
        f"class-agnostic {maps['agnostic']}; launches (K1, K1 saving, K2) {per_call['train'][0]} "
        f"per train step x {n_train_steps}, {per_call['eval'][0]} per eval forward x "
        f"{len(per_call['eval'])}; K6a, K6b {k6_launches} for {reads[0]} reads; {card}")
    return recipe_s, diag_s


def phase_training_kernels(cnb, k2, dev, gen):
    """K1's saving form and K2 against their plain versions, then K2 timed.
    Besides the stage shapes, batch 1 at 13x11 (143 pixels: a partial
    64-pixel tile of K2's row pass) at each width of its Hopper pipeline."""
    shapes = ([(2, s, s, c) for c, s, _ in STAGES] + [(1, 13, 21, 96), (3, 7, 5, 48)]
              + [(1, 13, 11, c) for c in (48, 96, 192, 384)])
    err_sav, err_dx, err_scale = 0.0, 0.0, 0.0
    for shape in shapes:
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            x, *params = block_args(gen, *shape, dt, dev)
            out, y = cnb.convnext_block_saving(x, *params)
            want_out, want_y = cnb.convnext_block_plain_saving(x, *params)
            g = torch.randn(shape, generator=gen, device=dev).to(dt)
            got = k2.convnext_block_bwd(x, want_y, g, *params)
            want = k2.convnext_block_bwd_plain(x, want_y, g, *params)
            again = k2.convnext_block_bwd(x, want_y, g, *params)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"K2 {shape} {dt}: two calls differ (want bit for bit)")
            e_out = check_close(f"K1 saving {shape} {dt} out", out, want_out, tol)
            e_y = check_close(f"K1 saving {shape} {dt} y", y, want_y, tol)
            e_dx, e_sc = check_grads(f"K2 {shape} {dt}", got, want, tol)
            if dt == torch.bfloat16:
                err_sav = max(err_sav, e_out, e_y)
                err_dx, err_scale = max(err_dx, e_dx), max(err_scale, e_sc)
            log(f"[k2] {shape} {str(dt):15s} K1 saving out {e_out:.3e} y {e_y:.3e}; "
                f"K2 dx {e_dx:.3e}, gradients {e_sc:.3e} of scale (tol {tol})")

    per_stage, totals = [], {"k2": 0.0, "plain": 0.0, "eager": 0.0, "sav": 0.0,
                             "sav_v0": 0.0, "sav_plain": 0.0}
    train_stages = STAGES[:3]  # the stages that train through K2 under "auto"
    totals["bound"] = depth_sum(
        [k2_bound(TRAIN_BATCH, s, s, c) for c, s, _ in train_stages], train_stages)
    totals["sav_bound"] = depth_sum(
        [k1_bound(TRAIN_BATCH, s, s, c, saving=True) for c, s, _ in train_stages], train_stages)
    for c, s, depth in train_stages:
        shape = (TRAIN_BATCH, s, s, c)
        x, *params = block_args(gen, *shape, torch.bfloat16, dev)
        # K2 takes the operands that the train path's forward folded once
        ops = cnb.kernel_operands(params, x.dtype, backward=True)
        out, y = cnb.convnext_block_saving(x, *params, ops=ops)
        want_out, want_y = cnb.convnext_block_plain_saving(x, *params)
        g = torch.randn_like(out)
        got = k2.convnext_block_bwd(x, y, g, *params, ops=ops)
        want = k2.convnext_block_bwd_plain(x, y, g, *params)
        again = k2.convnext_block_bwd(x, y, g, *params, ops=ops)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K2 {shape}: two calls differ (want bit for bit)")
        del again
        # the main path's shapes, where K2's split-K plan (slices over B*H*W)
        # differs from batch 2's
        e_out = check_close(f"K1 saving {shape} out", out, want_out, BF16_TOL)
        e_y = check_close(f"K1 saving {shape} y", y, want_y, BF16_TOL)
        e_dx, e_sc = check_grads(f"K2 {shape}", got, want, BF16_TOL)
        err_sav = max(err_sav, e_out, e_y)
        err_dx, err_scale = max(err_dx, e_dx), max(err_scale, e_sc)
        del out, want_out, want_y, got, want
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        ref_out = cnb.convnext_block_ref(*leaves)
        t_plain = cuda_ms(lambda: k2.convnext_block_bwd_plain(x, y, g, *params), iters=5)
        t_k2 = cuda_ms(lambda: k2.convnext_block_bwd(x, y, g, *params, ops=ops))
        t_eager = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True))
        t_k2b = cuda_ms(lambda: k2.convnext_block_bwd(x, y, g, *params, ops=ops))
        # the saving form, turns: first design, routed, routed, first design
        t_sav_v0 = cuda_ms(lambda: cnb.convnext_block_v0(x, *params, saving=True))
        t_sav = cuda_ms(lambda: cnb.convnext_block_saving(x, *params))
        t_sav_b = cuda_ms(lambda: cnb.convnext_block_saving(x, *params))
        t_sav_v0b = cuda_ms(lambda: cnb.convnext_block_v0(x, *params, saving=True))
        t_sav, t_sav_v0 = (t_sav + t_sav_b) / 2, (t_sav_v0 + t_sav_v0b) / 2
        t_fwd_eager = cuda_ms(lambda: cnb.convnext_block_ref(x, *params))
        t_sav_plain = cuda_ms(lambda: cnb.convnext_block_plain_saving(x, *params), iters=5)
        b_ms, b_by = k2_bound(*shape)
        sb_ms, sb_by = k1_bound(*shape, saving=True)
        k_ms = (t_k2 + t_k2b) / 2
        per_stage.append({"shape": list(shape), "ms": k_ms, "plain_ms": t_plain,
                          "eager_bwd_ms": t_eager, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err_dx": e_dx, "grad_err_of_scale": e_sc,
                          "saving_ms": t_sav, "saving_first_design_ms": t_sav_v0,
                          "saving_plain_ms": t_sav_plain, "eager_fwd_ms": t_fwd_eager,
                          "saving_bound_ms": sb_ms, "saving_bound_by": sb_by,
                          "saving_max_abs_err": max(e_out, e_y)})
        for key, v in (("k2", k_ms), ("plain", t_plain), ("eager", t_eager),
                       ("sav", t_sav), ("sav_v0", t_sav_v0), ("sav_plain", t_sav_plain)):
            totals[key] += depth * v
        log(f"[k2] {shape} bf16 K1 saving out {e_out:.3e} y {e_y:.3e}; K2 dx {e_dx:.3e}, "
            f"gradients {e_sc:.3e} of scale (tol {BF16_TOL})")
        log(f"[k2-time] {shape} bf16: K2 {t_k2:.4f}/{t_k2b:.4f} ms (the first design "
            f"{K2_MS_BEFORE[c]} ms, PERF.md §6; bound {b_ms:.4f} ms, {b_by}), "
            f"plain {t_plain:.4f} ms, eager autograd backward "
            f"{t_eager:.4f} ms")
        log(f"[k1-time] saving form {shape} bf16: routed "
            f"({'hopper' if cnb.forward_route(x.dtype, c) else 'first'} design) {t_sav:.4f} ms, "
            f"first design {t_sav_v0:.4f} ms (each the mean of two turns), twin "
            f"{t_sav_plain:.4f} ms, eager erf block forward {t_fwd_eager:.4f} ms; bound "
            f"{sb_ms:.4f} ms ({sb_by})")
    return err_sav, err_dx, err_scale, per_stage, totals


PAD_S = 0.02  # host seconds of calls on each side of a fenced profile window
MARK = "spin_kernel"  # torch.cuda._sleep's kernel: the fence's markers


def pad_calls(pad):
    """Calls of ``pad``, each waited for, until ``PAD_S`` seconds have passed."""
    t0 = time.perf_counter()
    while True:
        pad()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= PAD_S:
            return


def device_events(run, attempts=4, pad=None):
    """The device's events of ``run()`` under ``torch.profiler`` (``run``
    ends in no synchronise; this adds one), and the host-clock seconds of
    the profiled run. On the H100 machine the profiler has come back with no
    device event at all for a call that launched kernels (once, in phase
    12); such a profile is taken again, up to ``attempts`` profiles.

    With ``pad`` (one call of what ``run`` repeats) the window is fenced:
    calls of ``pad`` run for ``PAD_S`` seconds before and after it in the
    same profile, a marker kernel (``torch.cuda._sleep``) stands at each end
    of ``run``, and only the events between the two markers are returned.
    Late in the script the profiler loses the device events at the start of
    a profile, and at times at its end (K2 at batch 8, stage 0, after the
    raw phase: 8 of 10 calls seen with a marker after each; every call seen
    in a fresh process; three calls of K6 on either side did not cover the
    loss); the fence keeps those losses out of the window. A profile that
    lost a marker is taken again."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            if pad:
                pad_calls(pad)
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            if pad:
                torch.cuda._sleep(1)
                pad_calls(pad)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if pad:
            marks = sorted(e.time_range.start for e in events if MARK in e.name)
            if len(marks) != 2:
                log(f"[profile] profile {attempt} of {attempts} recorded {len(marks)} of the "
                    "fence's 2 markers")
                continue
            events = [e for e in events
                      if MARK not in e.name and marks[0] < e.time_range.start < marks[1]]
        if sum(e.device_time for e in events) > 0:
            return events, wall_s
        log(f"[profile] profile {attempt} of {attempts} recorded no device time")
    raise RuntimeError(f"the profiler recorded no device time in {attempts} profiles")


def kernel_split(fn, iters=10, attempts=3, known=None):
    """Device time and launches per call of ``fn``, by kernel (the name up to
    its argument list), from ``torch.profiler`` after one warm-up call: each
    kernel's mean time per recorded launch times its launches per call, in a
    window that :func:`device_events` fences. The profiler has dropped
    events (seen on the H100 machine: 9 of 10, and once 14 of 20, launches
    of a kernel recorded, before the fence), so a kernel's
    launches per call are its recorded count over ``iters`` rounded to a
    whole number; when that count is not within a quarter of a whole,
    nonzero number of launches per call, the call is profiled again, and
    the split fails after ``attempts`` such profiles; ``recorded`` keeps the
    raw ratio. ``known`` maps a name fragment to the launches per call that
    the caller knows its kernel makes (K3's one per call): such a kernel is
    scaled to that count from whatever launches were recorded (at least one,
    at most that count per call; on a loaded host the profiler recorded 14
    of K3's 20 in every one of three profiles)."""
    from collections import defaultdict

    known = known or {}

    def per_call(k, n):
        return next((c for frag, c in known.items() if frag in k), round(n[k] / iters))

    def whole(k, n):
        c = per_call(k, n)
        if any(frag in k for frag in known):
            return 1 <= n[k] <= c * iters
        return c >= 1 and abs(n[k] / iters - c) <= 0.25 * c

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        events, _ = device_events(lambda: [fn() for _ in range(iters)], pad=fn)
        ms, n = defaultdict(float), defaultdict(int)
        for e in events:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0]
            ms[name] += e.device_time / 1e3
            n[name] += 1
        off = [(k, n[k]) for k in ms if not whole(k, n)]
        if not off:
            break
        msg = (f"the profiler recorded {off[0][1]} launches of {off[0][0]} over {iters} calls: "
               f"not a whole number per call")
        if attempt == attempts:
            raise RuntimeError(msg + f" ({attempts} profiles)")
        log(f"[profile] {msg}; profiling again")
    out = {}
    for k in sorted(ms, key=lambda k: -ms[k]):
        out[k] = {"ms": ms[k] / n[k] * per_call(k, n), "launches": per_call(k, n),
                  "recorded": n[k] / iters}
    return out


def phase_k2_split(cnb, k2, dev, gen):
    """"[k2-split]": K2's device time per launch, by kernel, at the three
    batch-8 stage shapes that train through it, on the operands the forward
    folds: in bf16 (the Hopper pipeline, at most five launches per call) and
    in fp32, which runs the first design, the bf16 pipeline's predecessor."""
    out = []
    for dt in (torch.bfloat16, torch.float32):
        for c, s, _ in STAGES[:3]:
            shape = (TRAIN_BATCH, s, s, c)
            x, *params = block_args(gen, *shape, dt, dev)
            ops = cnb.kernel_operands(params, x.dtype, backward=True)
            _, y = cnb.convnext_block_saving(x, *params, ops=ops)
            g = torch.randn(shape, generator=gen, device=dev).to(dt)
            split = kernel_split(lambda: k2.convnext_block_bwd(x, y, g, *params, ops=ops))
            total = sum(v["ms"] for v in split.values())
            launches = sum(v["launches"] for v in split.values())
            out.append({"shape": list(shape), "dtype": str(dt), "device_ms": total,
                        "launches_per_call": launches, "by_kernel": split})
            if dt == torch.bfloat16 and launches > K2_MAX_LAUNCHES:
                raise RuntimeError(f"[k2-split] {shape}: {launches:g} launches per call, want "
                                   f"at most {K2_MAX_LAUNCHES}")
            log(f"[k2-split] {shape} {dt}: {launches:g} launches, {total:.4f} ms device time "
                f"per call; " + "; ".join(f"{k} x{v['launches']} ({v['recorded']:g} recorded) "
                                          f"{v['ms']:.4f} ms" for k, v in split.items()))
            del x, params, ops, y, g
    return out


# nvcc's report per library, by name, from the builds in main (ptxas -v)
BUILD_REPORTS = {}


def ptxas_kernels(report: str) -> dict:
    """Registers and spills per kernel from an ``nvcc -Xptxas -v`` report: the
    demangled-enough name (its mangled form) -> (registers, spill line)."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used " in line and "registers" in line:
            out[name] = [int(line.split("Used ")[1].split()[0]), out.get(name, [0, ""])[1]]
        elif name and "spill" in line:
            out.setdefault(name, [0, ""])[1] = line.split(":", 1)[-1].strip()
    return out


def k3_kernel_label(mangled: str) -> str:
    """K3's kernels by design and dtype (the mangled template argument:
    ``cnb_dwconv7_kernelI13__nv_bfloat16E``)."""
    design = "first design" if "dwconv7_v0" in mangled else "hopper"
    return f"{design} {'bf16' if 'bfloat16' in mangled else 'fp32'}"


def sass_instructions(lib_path) -> dict:
    """SASS of every kernel in a built library (``cuobjdump -sass``): the
    kernel's mangled name -> its instruction opcodes, with the labels as
    ``":"`` entries (NOPs dropped)."""
    import re
    import shutil

    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or str(Path(build.find_nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            cur.append(":")
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and not m.group(2).startswith("NOP"):
            cur.append(m.group(2) + ("?" if m.group(1) else ""))
    return out


def k3_instructions_per_value(ops, hopper: bool, px: int):
    """SASS instructions per output value of K3's band code. Hopper design:
    its unguarded band, the 7 basic blocks of at least 40 P FFMAs (one per
    input row; a guarded row splits at each tap row) through the stores of
    the last, up to the next unconditional branch or barrier, over its 7 P
    outputs per thread. First design (bf16, fully unrolled): from the
    barrier after the copies to the end, over its 32 outputs per thread.
    None where the code has not that shape."""
    if not hopper:
        bars = [i for i, op in enumerate(ops) if op.startswith("BAR.SYNC")]
        if not bars:
            return None
        body = [op for op in ops[bars[-1] + 1:] if op != ":"]
        return len(body) / 32
    blocks, start = [], 0
    for i, op in enumerate(ops + [":"]):
        if op == ":" or op.startswith(("BRA", "EXIT", "BAR.")):
            blocks.append((start, i))
            start = i + 1
    big = [(a, b) for a, b in blocks if sum(op.startswith("FFMA") for op in ops[a:b]) >= 40 * px]
    if len(big) < 7:
        return None
    first = big[0][0]
    last = big[6][1]
    end = next((i for i in range(last, len(ops))
                if ops[i] in ("BRA", "BAR.SYNC", "BAR.SYNC.DEFER_BLOCKING") or ops[i] == "EXIT"),
               len(ops))
    body = [op for op in ops[first:end] if op != ":"]
    return len(body) / (7 * px)


def phase_dwconv(k3, dev, gen):
    """K3's Hopper design against its plain version and bit for bit against
    its first design (``dwconv7_v0``): both calls of the explicit backward
    (the taps and the flipped taps) and with a bias (the library's bias
    pointer, as K4's recompute passes it); the library's plan against its
    Python mirror; registers (ptxas) and SASS instructions per output value
    of both designs; then "[k3-time]": the Hopper design and the first
    design in turns (CUDA events, and each kernel alone under
    ``torch.profiler``), the bound, the plain version and cuDNN's depthwise
    convolution at the batch-8 stage shapes."""
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    regs = {k3_kernel_label(k): v for k, v in ptxas_kernels(BUILD_REPORTS.get("dwconv", "")).items()}
    sass = {k3_kernel_label(k): ops for k, ops in
            sass_instructions(build.library_path("dwconv")).items() if "dwconv7" in k}
    per_value = {}
    for label, ops in sorted(sass.items()):
        per_value[label] = k3_instructions_per_value(ops, label.startswith("hopper"), k3.PX)
        ffma = sum(op.startswith("FFMA") for op in ops)
        log(f"[k3-build] {label}: registers {regs.get(label, ['?'])[0]}, spills "
            f"{regs.get(label, [0, '?'])[1]}; SASS {len([o for o in ops if o != ':'])} "
            f"instructions, {ffma} FFMA; band code {per_value[label]} instructions per output "
            f"value")
    if any("0 bytes spill stores" not in v[1] for v in regs.values()):
        raise RuntimeError(f"[k3] a K3 kernel spills: {regs}")
    # fp32 at FP32_TOL, the script's fp32 tolerance: K3 sums exact fp32
    # products in fp32 like its plain version (no TF32 anywhere), so its
    # fp32 errors are ~1e-6 (printed); the bound is shared with the kernels
    # whose fp32 products run in TF32. (32, 20, 20, 768): more units than
    # CTAs, so CTAs walk several units; (2, 9, 11, 16): C below the chunk.
    shapes = ([(b, s, s, c) for b in (2, TRAIN_BATCH) for c, s, _ in STAGES]
              + [(1, 13, 21, 96), (3, 7, 5, 48), (2, 9, 11, 16), (32, 20, 20, 768)])
    max_err, persistent = 0.0, False
    for shape in shapes:
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            plan = k3.library_plan(*shape, dt)
            mirror = k3.dwconv7_plan(*shape, dt.itemsize, sms=plan["sms"],
                                     ctas_per_sm=plan["ctas_per_sm"])
            if plan != mirror:
                raise RuntimeError(f"[k3] plan {shape} {dt}: library {plan}, mirror {mirror}")
            persistent |= plan["units"] > plan["grid"]
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            taps = torch.randn(7, 7, shape[-1], generator=gen, device=dev) * 0.1
            bias = torch.randn(shape[-1], generator=gen, device=dev)
            errs = []
            for name, t, bs in (("taps", taps, None), ("flipped taps", taps.flip(0, 1), None),
                                ("taps + bias", taps, bias)):
                before = k3.dwconv7.launches, k3.dwconv7_v0.launches
                got = k3.dwconv7(x, t, bs)
                v0 = k3.dwconv7_v0(x, t, bs)
                want = k3.dwconv7_plain(x, t, bs)
                torch.cuda.synchronize()
                if (k3.dwconv7.launches, k3.dwconv7_v0.launches) != (before[0] + 1, before[1] + 1):
                    raise RuntimeError(f"[k3] {shape} {dt} {name}: launch counts")
                errs.append(check_close(f"K3 {shape} {dt} {name}", got, want, tol))
                if not torch.equal(got, v0):
                    raise RuntimeError(f"K3 {shape} {dt} {name}: the Hopper design differs from "
                                       f"the first design by {(got - v0).abs().max().item():.3e}")
            if dt == torch.bfloat16:
                max_err = max(max_err, *errs)
            log(f"[k3] {shape} {str(dt):15s} max_abs_err {errs[0]:.3e}, flipped taps "
                f"{errs[1]:.3e}, with bias {errs[2]:.3e} (tol {tol}); equal to the first design "
                f"bit for bit; plan {json.dumps(plan)}")
            del x, got, v0, want
    if not persistent:
        raise RuntimeError("[k3] no checked shape had more work units than CTAs")

    per_stage = []
    for c, s, depth in STAGES:
        shape = (TRAIN_BATCH, s, s, c)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        taps = torch.randn(7, 7, c, generator=gen, device=dev) * 0.1
        xf = x.float()
        w = taps.permute(2, 0, 1).reshape(c, 1, 7, 7).contiguous()
        # turns: Hopper, first design, plain, cuDNN, first design, Hopper
        t_k3 = cuda_ms(lambda: k3.dwconv7(x, taps))
        t_v0 = cuda_ms(lambda: k3.dwconv7_v0(x, taps))
        t_plain = cuda_ms(lambda: k3.dwconv7_plain(x, taps))
        t_lib = cuda_ms(lambda: F.conv2d(xf.permute(0, 3, 1, 2), w, padding=3, groups=c))
        t_v0b = cuda_ms(lambda: k3.dwconv7_v0(x, taps))
        t_k3b = cuda_ms(lambda: k3.dwconv7(x, taps))
        d_k3 = device_ms(lambda: k3.dwconv7(x, taps), "cnb_dwconv7", launches=1)
        d_v0 = device_ms(lambda: k3.dwconv7_v0(x, taps), "cnb_dwconv7_v0", launches=1)
        d_k3b = device_ms(lambda: k3.dwconv7(x, taps), "cnb_dwconv7", launches=1)
        b_ms, b_by = k3_bound(*shape)
        plan = k3.library_plan(*shape, torch.bfloat16)
        label = "hopper bf16"
        per_stage.append({"shape": list(shape), "ms": (t_k3 + t_k3b) / 2,
                          "first_design_ms": (t_v0 + t_v0b) / 2, "plain_ms": t_plain,
                          "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
                          "device_ms": (d_k3 + d_k3b) / 2, "first_design_device_ms": d_v0,
                          "registers": regs.get(label, [None])[0],
                          "first_design_registers": regs.get("first design bf16", [None])[0],
                          "instructions_per_value": per_value.get(label),
                          "first_design_instructions_per_value":
                              per_value.get("first design bf16"),
                          "wasted_lanes": k3.wasted_lanes(plan, s, c), "plan": plan})
        log(f"[k3-time] {shape} bf16 in, fp32 out: K3 {t_k3:.4f}/{t_k3b:.4f} ms (its kernel "
            f"alone {d_k3:.4f}/{d_k3b:.4f} ms on the device), first design {t_v0:.4f}/"
            f"{t_v0b:.4f} ms ({d_v0:.4f} ms on the device); bound {b_ms:.4f} ms, {b_by}; plain "
            f"{t_plain:.4f} ms, cuDNN depthwise F.conv2d on the fp32 input {t_lib:.4f} ms; "
            f"{label}, {plan['grid']} CTAs for {plan['units']} units of {plan['seg_rows']} rows")
    return max_err, per_stage, {"registers": {k: v[0] for k, v in regs.items()},
                                "instructions_per_value": per_value}


def phase_bwd_v1(cnb, k2, dev, gen):
    """K4 against its plain version on both designs: its route (in bf16 up to
    C = 384 K2's Hopper pipeline under V1) and its first design through
    ``convnext_block_bwd_v1_v0`` (batch 2 at the stage shapes, the odd shape
    and C=48, bf16 and fp32; batch 1 at 13x11 at each Hopper width; the
    batch-8 stage shapes in bf16); two calls of the route equal bit for bit;
    both wrappers raise on what they do not take. Then "[k4-time]": the
    route, the first design, the plain version and the eager block's
    autograd backward timed in turns at the batch-8 stage shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for c in (48, 96, 192, 384, 768):  # the Python rule that picks the pointers, as the library's
        want = bool(k2._library().cnb_backward_v1_route(c, 1))
        if k2.bwd_v1_route(torch.bfloat16, c) != want or want != (c <= 384):
            raise RuntimeError(f"[k4] route at C={c}: library {want}")
        if k2.bwd_v1_route(torch.float32, c) or k2._library().cnb_backward_v1_route(c, 0):
            raise RuntimeError(f"[k4] fp32 at C={c} must run the first design")
    shapes = [(2, s, s, c) for c, s, _ in STAGES] + [(1, 13, 21, 96), (3, 7, 5, 48)]
    cases = [(shape, dt, tol) for shape in shapes
             for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL))]
    cases += [((1, 13, 11, c), torch.bfloat16, BF16_TOL) for c in (48, 96, 192, 384)]
    cases += [((TRAIN_BATCH, s, s, c), torch.bfloat16, BF16_TOL) for c, s, _ in STAGES]
    err_dx, err_scale = 0.0, 0.0
    for shape, dt, tol in cases:
        x, *params = block_args(gen, *shape, dt, dev)
        g = torch.randn(shape, generator=gen, device=dev).to(dt)
        got = k2.convnext_block_bwd_v1(x, g, *params)
        again = k2.convnext_block_bwd_v1(x, g, *params)
        v0 = k2.convnext_block_bwd_v1_v0(x, g, *params)
        want = k2.convnext_block_bwd_v1_plain(x, g, *params)
        torch.cuda.synchronize()
        route = "Hopper pipeline" if k2.bwd_v1_route(dt, shape[-1]) else "first design"
        e_dx, e_sc = check_grads(f"K4 {shape} {dt} ({route})", got, want, tol)
        v_dx, v_sc = check_grads(f"K4 first design {shape} {dt}", v0, want, tol)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K4 {shape} {dt}: two calls differ")
        if dt == torch.bfloat16:
            err_dx, err_scale = max(err_dx, e_dx), max(err_scale, e_sc)
        log(f"[k4] {shape} {str(dt):15s} {route}: dx {e_dx:.3e}, gradients {e_sc:.3e} of scale; "
            f"first design dx {v_dx:.3e}, gradients {v_sc:.3e} (tol {tol}); two calls equal")
        del got, again, v0, want
    x, *params = block_args(gen, 1, 8, 8, 32, torch.bfloat16, dev)
    before = k2.convnext_block_bwd_v1.launches, k2.convnext_block_bwd_v1_v0.launches
    for fn in (k2.convnext_block_bwd_v1, k2.convnext_block_bwd_v1_v0):
        for bad in (torch.zeros_like(x).float(), torch.zeros_like(x).transpose(1, 2)):
            try:
                fn(x, bad, *params)
            except ValueError:
                continue
            raise RuntimeError(f"{fn.__name__} took a cotangent it must refuse")
    if (k2.convnext_block_bwd_v1.launches, k2.convnext_block_bwd_v1_v0.launches) != before:
        raise RuntimeError("[k4] a refused call launched")

    per_stage = []
    for c, s, depth in STAGES:
        shape = (TRAIN_BATCH, s, s, c)
        x, *params = block_args(gen, *shape, torch.bfloat16, dev)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        ref_out = cnb.convnext_block_ref(*leaves)
        t_k4 = cuda_ms(lambda: k2.convnext_block_bwd_v1(x, g, *params))
        t_v0 = cuda_ms(lambda: k2.convnext_block_bwd_v1_v0(x, g, *params))
        t_plain = cuda_ms(lambda: k2.convnext_block_bwd_v1_plain(x, g, *params), iters=5)
        t_eager = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True))
        t_v0b = cuda_ms(lambda: k2.convnext_block_bwd_v1_v0(x, g, *params))
        t_k4b = cuda_ms(lambda: k2.convnext_block_bwd_v1(x, g, *params))
        b_ms, b_by = k4_bound(*shape)
        per_stage.append({"shape": list(shape), "ms": (t_k4 + t_k4b) / 2,
                          "first_design_ms": (t_v0 + t_v0b) / 2, "plain_ms": t_plain,
                          "eager_bwd_ms": t_eager, "bound_ms": b_ms, "bound_by": b_by})
        route = "Hopper pipeline" if k2.bwd_v1_route(torch.bfloat16, c) else "first design"
        log(f"[k4-time] {shape} bf16: K4 ({route}) {t_k4:.4f}/{t_k4b:.4f} ms, first design "
            f"{t_v0:.4f}/{t_v0b:.4f} ms (bound {b_ms:.4f} ms, {b_by}), plain {t_plain:.4f} ms, "
            f"eager autograd backward {t_eager:.4f} ms")
        del x, params, g, leaves, ref_out
    return err_dx, err_scale, per_stage


def k4_kernel(name: str) -> bool:
    """Whether a kernel of a K4 call is one of K4's own (the recompute
    ``cnb_dwconv7_kernel``, the Hopper passes ``k2_*``, the first design's
    ``cnb_bwd_*``), not one of the wrapper's copies of the parameters."""
    return "k2_" in name or "cnb_" in name


def phase_k4_split(k2, dev, gen):
    """"[k4-split]": K4's device time per launch, by kernel, at the three
    batch-8 stage shapes of its Hopper pipeline: the route (at most five
    launches of its kernels per call) and, beside it, the first design in
    bf16; the wrapper's parameter copies apart."""
    out = []
    for c, s, _ in STAGES[:3]:
        shape = (TRAIN_BATCH, s, s, c)
        x, *params = block_args(gen, *shape, torch.bfloat16, dev)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for design, fn in (("route", k2.convnext_block_bwd_v1),
                           ("first design", k2.convnext_block_bwd_v1_v0)):
            split = kernel_split(lambda: fn(x, g, *params))
            ours = {k: v for k, v in split.items() if k4_kernel(k)}
            total = sum(v["ms"] for v in ours.values())
            launches = sum(v["launches"] for v in ours.values())
            copies = sum(v["ms"] for k, v in split.items() if k not in ours)
            out.append({"shape": list(shape), "design": design, "device_ms": total,
                        "launches_per_call": launches, "operand_copies_ms": copies,
                        "by_kernel": split})
            if design == "route" and not 0 < launches <= K2_MAX_LAUNCHES:
                raise RuntimeError(f"[k4-split] {shape}: {launches:g} launches per call, want "
                                   f"1 to {K2_MAX_LAUNCHES}")
            log(f"[k4-split] {shape} bf16 {design}: {launches:g} launches, {total:.4f} ms device "
                f"time per call (the wrapper's parameter copies {copies:.4f} ms more); "
                + "; ".join(f"{k} x{v['launches']} ({v['recorded']:g} recorded) {v['ms']:.4f} ms"
                            for k, v in ours.items()))
        del x, params, g
    return out


# The five block fwd+bwd routes of the per-stage phase: the autograd routes
# of ``convnext_block`` by their ``bwd`` value, and "eager" (pallas="off":
# autograd of the eager erf block)
FWDBWD_ROUTES = ("ref", "eager", "fused", "fused_v1", "explicit")
# per block: (K1, K1 saving, K2, K4, K3) launches
FWDBWD_LAUNCHES = {"ref": (1, 0, 0, 0, 0), "eager": (0, 0, 0, 0, 0), "fused": (0, 1, 1, 0, 0),
                   "fused_v1": (1, 0, 0, 1, 0), "explicit": (1, 0, 0, 0, 2)}


def block_fwd_bwd(cnb, route, leaves, g):
    if route == "eager":
        out = cnb.convnext_block_ref(*leaves)
    else:
        out = cnb.convnext_block(*leaves, bwd=route)
    return torch.autograd.grad(out, leaves, g)


def phase_block_fwdbwd(cnb, k2, k3, dev, gen):
    """One block's forward plus backward at the batch-8 640^2 stage shapes,
    bf16, every parameter and x requiring grad, under the five routes (the
    port of scripts/profile_train.py's per-stage block fwd+bwd): launch
    counts over a pass of the trunk's 18 blocks, CUDA-event times, trunk
    totals weighted by the depths; then each new route's gradient at batch 2
    in fp32 against the fp32 eager autograd gradient."""
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd,
              k2.convnext_block_bwd_v1, k3.dwconv7)
    launches = {r: [0] * len(counts) for r in FWDBWD_ROUTES}
    table = []
    totals = {r + sfx: 0.0 for r in FWDBWD_ROUTES for sfx in ("", "_device")}
    for c, s, depth in STAGES:
        shape = (TRAIN_BATCH, s, s, c)
        x, *params = block_args(gen, *shape, torch.bfloat16, dev)
        leaves = [t.requires_grad_() for t in (x, *params)]
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for route in FWDBWD_ROUTES:  # the stage's blocks, as a pass of the trunk runs them
            reset_counts(*counts)
            for _ in range(depth):
                grads = block_fwd_bwd(cnb, route, leaves, g)
            torch.cuda.synchronize()
            got = tuple(fn.launches for fn in counts)
            want = tuple(depth * n for n in FWDBWD_LAUNCHES[route])
            if got != want:
                raise RuntimeError(f"[block-fwdbwd] {shape} {route}: launches (K1, K1 saving, "
                                   f"K2, K4, K3) {got}, want {want}")
            if not all(torch.isfinite(t).all() for t in grads):
                raise RuntimeError(f"[block-fwdbwd] {shape} {route}: non-finite gradients")
            launches[route] = [a + b for a, b in zip(launches[route], got)]
        times = {r: [] for r in FWDBWD_ROUTES}
        for route in FWDBWD_ROUTES + FWDBWD_ROUTES[::-1]:  # two turns, in turns
            times[route].append(cuda_ms(lambda: block_fwd_bwd(cnb, route, leaves, g), iters=10))
        # the explicit backward's plain taps' gradient (49 shifted sums),
        # which eager PyTorch runs as 49 unfused products and reductions
        d_y = torch.randn(shape, generator=gen, device=dev)
        t_taps = cuda_ms(lambda: k2.taps_grad(x, d_y), iters=5)
        row = {"shape": list(shape), "depth": depth, "explicit_taps_grad_ms": t_taps}
        for route in FWDBWD_ROUTES:
            # device time alone: at the narrow stages the host issues a
            # route's ~20-200 launches slower than the device runs them
            dev_ms = device_ms(lambda: block_fwd_bwd(cnb, route, leaves, g), iters=5)
            row[route] = sum(times[route]) / 2
            row[f"{route}_device_ms"] = dev_ms
            totals[route] += depth * row[route]
            totals[f"{route}_device"] += depth * dev_ms
        table.append(row)
        log(f"[block-fwdbwd] {shape} bf16 fwd+bwd ms per block (CUDA events, two turns; "
            f"device time alone): " + ", ".join(
                f"{r} {times[r][0]:.4f}/{times[r][1]:.4f}; {row[r + '_device_ms']:.4f}"
                for r in FWDBWD_ROUTES)
            + f"; the explicit route's 49 shifted sums {t_taps:.4f}")
    log("[block-fwdbwd] trunk (depths 3/3/9/3) fwd+bwd ms (CUDA events; device time alone): "
        + ", ".join(f"{r} {totals[r]:.3f}; {totals[r + '_device']:.3f}" for r in FWDBWD_ROUTES))

    # the new routes' gradients against fp32 eager autograd at batch 2, fp32
    # with TF32 off (K1's and K4's products still run in TF32): within the
    # tanh/erf GELU gap, the JAX package's tolerances for its fused backward
    # against the vjp of the reference (tests/test_pallas_convnext.py:
    # 178-202): dx 5e-3, parameter gradients 2e-2 of their own scale
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grad_err = {}
    for c, s, _ in STAGES:
        shape = (2, s, s, c)
        x, *params = block_args(gen, *shape, torch.float32, dev)
        leaves = [t.requires_grad_() for t in (x, *params)]
        g = torch.randn(shape, generator=gen, device=dev)
        want = block_fwd_bwd(cnb, "eager", leaves, g)
        for route in ("fused_v1", "explicit"):
            got = block_fwd_bwd(cnb, route, leaves, g)
            torch.cuda.synchronize()
            e_dx = check_close(f"[block-fwdbwd] {shape} {route} dx", got[0], want[0], 5e-3)
            e_sc = 0.0
            for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
                scale = b.abs().max().item()
                err = (a - b).abs().max().item()
                if not torch.isfinite(a).all() or err > 2e-2 * scale:
                    raise RuntimeError(f"[block-fwdbwd] {shape} {route} gradient {i}: max abs "
                                       f"err {err:.3e} > 2e-2 x {scale:.3e}")
                e_sc = max(e_sc, err / scale)
            grad_err[route] = max(grad_err.get(route, 0.0), e_sc)
            log(f"[block-fwdbwd] {shape} fp32 {route} vs eager autograd: dx {e_dx:.3e} "
                f"(tol 5e-3), gradients {e_sc:.3e} of scale (tol 2e-2)")
    return launches, table, totals, grad_err


# the H100 SXM's bf16 rate outside the tensor cores (2x fp32, whitepaper):
# dwbf16's taps are bf16 operations, though the kernel runs them as fp32
# operations rounded to bf16 one by one
PEAK_BF16_SIMT = 134e12


def lab_bound(name, b, h, w, c):
    """(bound_ms, bound_by) of one lab launch: the largest of the bytes (x in,
    out out: 4 B H W C) over the memory rate, the 49 taps (98 C flop per
    pixel) over the fp32 peak (``dwbf16``: the bf16 rate outside the tensor
    cores) and the two products (16 C^2 flop per pixel) over the bf16 tensor
    peak, as far as the variant has them."""
    p = b * h * w
    taps = 98 * c * p if name.startswith("dw") or name == "full" else 0
    prods = 16 * c * c * p if name.startswith("mlp") or name == "full" else 0
    parts = {"bytes": 4 * p * c / PEAK_BYTES * 1e3,
             "taps": taps / (PEAK_BF16_SIMT if name == "dwbf16" else PEAK_FP32) * 1e3,
             "products": prods / PEAK_BF16 * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes" else "operations"


LAB_SPLIT = ("copy", "dwrowreg", "dwln", "mlp", "mlpgelu", "full")


def lab_split(t):
    """K1's time by phase from the lab's launch-alone times ``t``: the load
    and store (copy), the 49 taps (K1's schedule less copy), LN (dwln less
    dw), the two products (mlp less copy), GELU (mlpgelu less mlp), and what
    the phases do not add up to (full less dwln less mlpgelu plus copy)."""
    return {"load_store": t["copy"], "taps": t["dwrowreg"] - t["copy"],
            "ln": t["dwln"] - t["dwrowreg"], "products": t["mlp"] - t["copy"],
            "gelu": t["mlpgelu"] - t["mlp"],
            "rest": t["full"] - t["dwln"] - t["mlpgelu"] + t["copy"], "full": t["full"]}


ONE_BF16_STEP = (2.0 ** -7, 1e-3)  # rtol, atol: the lab's full at the other tile against K1


def check_lab(name, got, want, rtol, atol):
    """Max |got - want|, or raises where it is not finite or past the
    tolerance."""
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or bool(
            (err > atol + rtol * want.float().abs()).any()):
        raise RuntimeError(f"[lab] {name}: max abs err {err.max().item():.3e} (rtol {rtol}, "
                           f"atol {atol})")
    return err.max().item()


def phase_lab(cnb, dev):
    """The kernel lab (K5): every variant against its plain version at every
    legal tile, at the batch-16 stage shapes (K1's Hopper design cut down at
    stages 0-2, its first design at stage 3) and at C = 48; ``full`` at K1's
    tile bit for bit against K1 (``convnext_block``), at the other tile
    within one bf16 step of it; the first design's lab (``lab_variant_v0``)
    against the plain versions where it is timed. Then each variant at K1's
    tile timed (``timeloop``) with and without ``padded_io``, beside its
    bound, its plain version and the library call, where there is one; the
    first design's lab timed launch alone at stages 0-2 (the "before"); K1's
    split by phase per stage at both tiles and the first design's beside it;
    last the entry point itself, ``tools.kernel_lab.main`` at ``--stage 0``,
    with the launch count set to 0 before it and read after."""
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import kernel_lab as lab
    from multitask_bonetumor_yolo_tpu_torch.tools import kernel_lab as tools
    from multitask_bonetumor_yolo_tpu_torch.utils.timing import timeloop

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    six = tools.DEFAULT_VARIANTS.split(",")  # the entry point's variants
    before_names = list(dict.fromkeys(six + list(LAB_SPLIT)))
    shapes = [(BATCH, s, s, c) for c, s, _ in STAGES] + [(2, 13, 21, 48)]
    max_err = 0.0
    # the lab cuts K1's Hopper design where K1 runs it, up to its own
    # narrower ceiling (Tiny's widths): at C = 512 K1 runs it, the lab does not
    for c in (48, 96, 192, 384, 512, 768):
        want = cnb.forward_route(torch.bfloat16, c) and c <= lab.HOPPER_MAX_CHANNELS
        if lab.hopper_route(c) != want:
            raise RuntimeError(f"[lab] C={c}: the lab's route is {lab.hopper_route(c)}, want "
                               f"{want} (K1's route up to {lab.HOPPER_MAX_CHANNELS})")
    for shape in shapes:
        c = shape[-1]
        for v0 in (False, True):
            if lab.k1_tile(c, v0)[0] != lab.k1_tile_pixels(c, v0):
                raise RuntimeError(f"[lab] C={c}{' v0' if v0 else ''}: K1's tile "
                                   f"{lab.k1_tile(c, v0)} but the CPU route's rule says TM="
                                   f"{lab.k1_tile_pixels(c, v0)}")
        x, dw, w1, w2 = tools.lab_inputs(*shape, device=dev)
        taps, w1k, w2k, zeros, wt = tools.fold(dw, w1, w2, c)
        errs = []
        for name in lab.VARIANTS:
            want = lab.lab_variant_plain(name, x, taps, w1k, w2k)
            rtol, atol = lab.card_tolerance(name)
            for tm in lab.legal_tiles(c):
                got = lab.lab_variant(name, x, taps, w1k, w2k, tm=tm, zeros=zeros, wt=wt)
                torch.cuda.synchronize()
                errs.append((name, tm, check_lab(f"{name} {shape} TM={tm}", got, want, rtol,
                                                 atol)))
            if lab.hopper_route(c) and name in before_names:
                got = lab.lab_variant_v0(name, x, taps, w1k, w2k, zeros=zeros)
                errs.append((name, "v0", check_lab(f"{name} {shape} first design", got, want,
                                                   rtol, atol)))
        max_err = max(max_err, *(e for _, tm, e in errs if tm != "v0"))  # the lab's route
        # full at K1's tile is K1's own launch on K1's operands, bit for bit;
        # at the other tile the lab's FULL instantiation, within one bf16 step
        ones = torch.ones(c, device=dev)
        k1_out = cnb.convnext_block(
            x, taps.permute(2, 0, 1).reshape(c, 1, 7, 7), zeros[:c], ones, zeros[:c],
            w1k.t().float(), zeros, w2k.t().float(), zeros[:c], ones)
        if not torch.equal(lab.lab_variant("full", x, taps, w1k, w2k, zeros=zeros, wt=wt),
                           k1_out):
            raise RuntimeError(f"[lab] {shape}: full differs from K1 (convnext_block)")
        other = [tm for tm in lab.legal_tiles(c) if tm != lab.k1_tile_pixels(c)]
        full_other = {tm: check_lab(f"full {shape} TM={tm} against K1", lab.lab_variant(
            "full", x, taps, w1k, w2k, tm=tm, zeros=zeros, wt=wt), k1_out, *ONE_BF16_STEP)
            for tm in other}
        log(f"[lab] {shape} bf16, kernel vs plain max abs err per variant and tile: "
            + ", ".join(f"{n}@{tm} {e:.2e}" for n, tm, e in errs)
            + "; full == K1 (convnext_block) bit for bit"
            + "".join(f"; full@{tm} vs K1 {e:.2e}" for tm, e in full_other.items()))

    iters = 10
    table = {name: [] for name in lab.VARIANTS}
    split, per_stage = [], []
    for c, s, _ in STAGES:
        shape = (BATCH, s, s, c)
        x, dw, w1, w2 = tools.lab_inputs(*shape, device=dev)
        taps, w1k, w2k, zeros, wt = tools.fold(dw, w1, w2, c)
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes (channels_last)
        wb = taps.permute(2, 0, 1).reshape(c, 1, 7, 7).to(torch.bfloat16)
        lib = {"copy": cuda_ms(lambda: x.clone()),
               "dw": cuda_ms(lambda: F.conv2d(xc, wb, padding=3, groups=c))}
        padded, plain = {}, {}
        for name in lab.VARIANTS:
            run, xin = tools.build_variant(name, *shape, 0, torch.bfloat16, device=dev)
            run_p, _ = tools.build_variant(name, *shape, 0, torch.bfloat16, padded_io=True,
                                           device=dev)
            t_pad = timeloop(lambda: run_p(xin), iters)
            t_run = timeloop(lambda: run(xin), iters)
            t_plain = cuda_ms(lambda: lab.lab_variant_plain(name, xin, taps, w1k, w2k),
                              iters=3, warmup=1)
            b_ms, b_by = lab_bound(name, *shape)
            t_lib = (lib["copy"] if name == "copy" else
                     lib["dw"] if name.startswith("dw") and name != "dwln" else None)
            ctas = lab.lab_tile(name, c)[3]
            padded[name], plain[name] = t_pad, t_plain
            table[name].append({"shape": list(shape), "ms": t_run, "ms_padded_io": t_pad,
                                "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
                                "library_ms": t_lib, "ctas_per_sm": ctas})
            log(f"[lab-time] {shape} {name:<11s} {t_run:.4f} ms, launch alone {t_pad:.4f} ms "
                f"({ctas} CTAs/SM{'; = ' + lab.SHARES[name] if name in lab.SHARES else ''}); "
                f"bound {b_ms:.4f} ({b_by}), plain {t_plain:.4f}"
                + (f", library {t_lib:.4f}" if t_lib is not None else ""))
        tm, th, tw, _ = lab.lab_tile("full", c)
        row = {"shape": list(shape), "tile": [tm, th, tw], **lab_split(padded)}
        for tm2 in lab.legal_tiles(c):
            if tm2 != tm:  # the same split at the other tile
                t2 = {name: timeloop(lambda: lab.lab_variant(
                    name, x, taps, w1k, w2k, tm=tm2, zeros=zeros, wt=wt), iters)
                    for name in LAB_SPLIT}
                row[f"tm{tm2}"] = lab_split(t2)
        stage = {"shape": list(shape), "six_ms": {n: padded[n] for n in six}}
        if lab.hopper_route(c):  # the first design's lab, launch alone: the "before"
            t0 = {name: timeloop(lambda: lab.lab_variant_v0(name, x, taps, w1k, w2k,
                                                            zeros=zeros), iters)
                  for name in before_names}
            row["first_design"] = {"tm": lab.k1_tile_pixels(c, v0=True), **lab_split(t0)}
            stage["before_ms"] = {n: t0[n] for n in six}
            for name in before_names:
                t_lib = table[name][-1]["library_ms"]
                log(f"[lab-time] {shape} {name:<11s} before (the first design's lab, TM="
                    f"{lab.k1_tile_pixels(c, v0=True)}), launch alone {t0[name]:.4f} ms; "
                    f"Hopper lab {padded[name]:.4f}; bound {table[name][-1]['bound_ms']:.4f}, "
                    f"plain {plain[name]:.4f}"
                    + (f", library {t_lib:.4f}" if t_lib is not None else ""))
        stage["six_total_ms"] = sum(stage["six_ms"].values())
        if "before_ms" in stage:
            stage["before_total_ms"] = sum(stage["before_ms"].values())
        per_stage.append(stage)
        split.append(row)
        log(f"[lab-split] {shape} K1 (TM={tm}, {th}x{tw}) by phase, launch alone, ms: "
            + json.dumps({k: v for k, v in row.items() if k not in ("shape", "tile")}))
        log(f"[lab-library] {shape} x.clone() {lib['copy']:.4f} ms; cuDNN depthwise "
            f"F.conv2d(groups=C) on the bf16 input, bf16 taps {lib['dw']:.4f} ms; the six "
            f"launch alone {stage['six_total_ms']:.4f} ms"
            + (f", before {stage['before_total_ms']:.4f}" if "before_ms" in stage else ""))

    # the main path: the lab's entry point on the card, as a user runs it
    lab.lab_variant.launches = 0
    times = tools.main(["--stage", "0"])
    torch.cuda.synchronize()
    launches = lab.lab_variant.launches
    reps, n = 3, 20  # timeloop's defaults and main's --iters
    want = len(times) * (1 + reps) * 4 * n
    if launches != want:
        raise RuntimeError(f"[lab] the entry point launched {launches} lab kernels, want {want}")
    log(f"[lab] tools.kernel_lab.main(--stage 0): {launches} launches of the lab's kernels; "
        f"the phase took {time.perf_counter() - t_phase:.1f} s after the build")
    main_rows = {name: table[name][0] for name in times}
    by_ms = {"bytes": 0.0, "operations": 0.0}
    for r in main_rows.values():
        by_ms[r["bound_by"]] += r["bound_ms"]
    # the main path's numbers: the entry point's six variants at stage 0
    return {"launches": launches, "max_abs_err": max_err, "ms": sum(times.values()),
            "plain_ms": sum(r["plain_ms"] for r in main_rows.values()),
            "bound_ms": sum(by_ms.values()), "bound_by": max(by_ms, key=by_ms.get),
            "main_path": {"argv": "--stage 0", "ms": times}, "per_stage": per_stage,
            "per_variant": table, "split": split}


# Device kernels by category, first match wins, against the lower-cased
# demangled name. The port's kernels carry their own prefixes (K1
# ``cnb_forward_kernel`` and ``k1h::k1_forward_kernel``, K2
# ``k2h::k2_*_kernel`` and ``cnb_bwd_spatial_kernel``, K4
# ``cnb_bwd_*_kernel``, K3 ``cnb_dwconv7_kernel`` and its first design
# ``cnb_dwconv7_v0_kernel``), which no PyTorch kernel has.
CATEGORIES = (
    ("K1 (convnext_block.cu)", ("cnb_forward_kernel", "k1h::")),
    ("K3 (dwconv.cuh)", ("cnb_dwconv7",)),
    ("K2 (convnext_block_bwd.cu)", ("cnb_bwd_", "k2h::")),
    ("optimizer (foreach, flat AdamW)", ("foreach", "multi_tensor")),
    ("BatchNorm (incl. the running-statistics pass)",
     ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("convolutions", ("conv", "xmma", "implicit", "wgrad", "dgrad", "fprop", "winograd")),
    ("matrix products", ("gemm", "cutlass", "cublas", "sm90", "sm80")),
    ("copies / layout", ("copy", "cat", "memcpy", "memset", "transpose", "permute")),
    ("reductions", ("reduce", "sum", "norm", "max", "argmax", "topk", "sort")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)
PROFILE_STEPS = 3


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def profile_step(step, state, batch, gen) -> dict:
    """Where the time of the train step goes: ``torch.profiler`` over
    PROFILE_STEPS steps (after one warm-up step), device kernel time per step
    by category, kernels per step, and the device's idle share of the
    profiled wall time."""
    from collections import defaultdict

    step(state, batch, gen)
    torch.cuda.synchronize()
    events, wall_s = device_events(lambda: [step(state, batch, gen) for _ in range(PROFILE_STEPS)])
    wall_ms = wall_s * 1e3 / PROFILE_STEPS
    by_cat, count = defaultdict(float), 0
    for evt in events:
        by_cat[category(evt.name)] += evt.device_time / 1e3 / PROFILE_STEPS
        count += 1
    device_ms = sum(by_cat.values())
    return {"wall_ms_per_step_profiled": wall_ms, "device_kernel_ms_per_step": device_ms,
            "kernels_per_step": count / PROFILE_STEPS,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))}


def set_block_bwd(model, policy):
    """Every block's backward under ``ModelConfig.block_bwd = policy``."""
    from multitask_bonetumor_yolo_tpu_torch.models.backbone import ConvNeXtBlock, bwd_for_dim

    for m in model.modules():
        if isinstance(m, ConvNeXtBlock):
            m.bwd = bwd_for_dim(m.gamma.numel(), policy)


def reset_counts(*fns):
    for fn in fns:
        fn.launches = 0


def phase_train(cnb, k2, dev, gen):
    """3 + 1 full-width train steps through make_train_step, then the
    three-way gradient check and the step times."""
    from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig, multitask_loss
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
    from multitask_bonetumor_yolo_tpu_torch.models.backbone import ConvNeXtBlock
    from multitask_bonetumor_yolo_tpu_torch.train import (
        TrainConfig, create_train_state, make_train_step,
    )

    cfg = ModelConfig(img_size=IMG, dtype="bfloat16")  # pallas and block_bwd "auto"
    model = build_model(cfg, seed=SEED, device=dev)
    randomize(model, gen)
    state = create_train_state(cfg, TrainConfig(), model=model)
    step = make_train_step(cfg, LossConfig(img_size=IMG))
    batch = synthetic_batch(TRAIN_BATCH, IMG, gen)
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    blocks = sum(cfg.backbone_depths)
    kernel_blocks = auto_blocks(cnb)
    launches = {}
    for policy, n_steps, want in (("auto", 3, kernel_blocks), ("fused", 1, blocks)):
        set_block_bwd(model, policy)
        for i in range(n_steps):
            stats_before = state.bn_snapshot()
            reset_counts(*counts)
            state, metrics, aux = step(state, batch, gen)
            torch.cuda.synchronize()
            got = tuple(fn.launches for fn in counts)
            if got != (0, want, want):
                raise RuntimeError(f"{policy} step {i}: launches (K1, K1 saving, K2) {got}, "
                                   f"want (0, {want}, {want})")
            launches[policy] = got
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(map(lambda v: v == v and abs(v) != float("inf"), vals.values())):
                raise RuntimeError(f"{policy} step {i}: non-finite metrics {vals}")
            if vals["step_skipped"] != 0.0:
                raise RuntimeError(f"{policy} step {i}: the step was skipped")
            moved = (state.bn_snapshot() - stats_before).abs().max().item()
            if not moved > 0:
                raise RuntimeError(f"{policy} step {i}: BN running statistics did not move")
            log(f"[train] block_bwd={policy} step {state.step}: loss {vals['loss_total']:.4f} "
                f"(seg {vals['loss_seg']:.4f}, box {vals['loss_box_iou']:.4f}, dfl "
                f"{vals['loss_dfl']:.4f}, cls {vals['loss_cls_det']:.4f}, img "
                f"{vals['loss_img_cls']:.4f}), num_pos {vals['num_pos']:.0f}, grad_norm "
                f"{vals['grad_norm']:.4f}, launches (K1, K1 saving, K2) {got}, BN moved {moved:.3e}")
    if any(not torch.isfinite(t).all() for t in aux.values()):
        raise RuntimeError("train step aux outputs are not finite")

    # (a) kernels on every stage, (b) eager bf16, (c) eager fp32 without TF32.
    # The default assigner thresholds the predictions' IoU, so the three
    # precisions pick different positive anchors (logged below) and their
    # gradients differ by the loss terms of those anchors, not by arithmetic;
    # with iou_match_thresh -1 every anchor is positive: all five terms take
    # part and the set cannot flip.
    trunk = [id(p) for m in model.modules() if isinstance(m, ConvNeXtBlock) for p in m.params()]
    all_positive = LossConfig(img_size=IMG, iou_match_thresh=-1.0)

    def loss_grad(pallas, dtype, loss_cfg=all_positive, grad=True):
        set_pallas(model, pallas)
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        img = batch["image"].float() / 255.0
        with torch.set_grad_enabled(grad):
            out = model(img, train=True, mode="train")
            lo = multitask_loss(out, {**batch, "image": img}, loss_cfg)
        model.cfg = cfg
        if not grad:
            return int(lo.num_pos)
        params = list(model.parameters())
        grads = torch.autograd.grad(lo.total, params, allow_unused=True)
        flat = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(params, grads)]
        return (torch.cat([g.reshape(-1) for g in flat]),
                torch.cat([g.reshape(-1) for p, g in zip(params, flat) if id(p) in trunk]))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_block_bwd(model, "fused")
    pos = [loss_grad(p, d, LossConfig(img_size=IMG), grad=False)
           for p, d in (("on", "bfloat16"), ("off", "bfloat16"), ("off", "float32"))]
    log(f"[grad] positives under the default assigner: (a) {pos[0]}, (b) {pos[1]}, (c) {pos[2]}")
    reset_counts(*counts)
    g_a = loss_grad("on", "bfloat16")
    if counts[1].launches != blocks or counts[2].launches != blocks:
        raise RuntimeError("gradient (a) did not run K1's saving form and K2 on every block")
    g_b = loss_grad("off", "bfloat16")
    g_c = loss_grad("off", "float32")
    rel = {}
    for i, part in enumerate(("whole", "trunk blocks")):
        a, b, c = g_a[i], g_b[i], g_c[i]
        e_a = ((a - c).norm() / c.norm()).item()
        e_b = ((b - c).norm() / c.norm()).item()
        rel[part] = (e_a, e_b)
        if not e_a <= 2.0 * e_b + 1e-3:
            raise RuntimeError(f"gradient {part}: |a-c|/|c| {e_a:.3e} > 2 x {e_b:.3e} + 1e-3")
        log(f"[grad] {part} ({c.numel()} values): kernels vs fp32 {e_a:.3e}, eager bf16 vs "
            f"fp32 {e_b:.3e} (bound {2 * e_b + 1e-3:.3e})")
    set_pallas(model, "auto")
    set_block_bwd(model, "auto")

    # the step is bound by the host's launches, whose speed varies from turn
    # to turn: six turns of 10 steps, alternating, and the median turn of each
    times = {"off": [], "auto": []}
    for mode in ("off", "auto", "auto", "off", "off", "auto"):
        set_pallas(model, mode)
        times[mode].append(cuda_ms(lambda: step(state, batch, gen), iters=10, warmup=1))
    set_pallas(model, "auto")
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    on_ms, off_ms = sorted(times["auto"])[1], sorted(times["off"])[1]
    log(f"[train-time] batch-{TRAIN_BATCH} {IMG}^2 bf16 train step: K1 + K2 (auto) "
        f"{times['auto']} ms (median {on_ms:.3f}, {TRAIN_BATCH * 1000 / on_ms:.1f} img/s), "
        f"pallas=off {times['off']} ms (median {off_ms:.3f}, "
        f"{TRAIN_BATCH * 1000 / off_ms:.1f} img/s); peak memory {peak:.2f} GiB")

    for mode in ("auto", "off"):
        set_pallas(model, mode)
        log(f"[profile] pallas={mode} " + json.dumps(profile_step(step, state, batch, gen)))
    set_pallas(model, "auto")
    return launches["auto"]


def path_totals(per_stage, per_block, keys):
    """Per-launch stage numbers summed over the trunk's launches (``per_block``
    launches in each of a stage's ``depth`` blocks): each time in ``keys`` and
    the bound, bound by what bounds most of it."""
    stages = [(c, s, per_block * d) for c, s, d in STAGES]
    out = {k: sum(n * row[k] for (_, _, n), row in zip(stages, per_stage)) for k in keys}
    b_ms, b_by = depth_sum([(row["bound_ms"], row["bound_by"]) for row in per_stage], stages)
    return {**out, "bound_ms": b_ms, "bound_by": b_by}


# K7 at the serving forward's shapes (B, C, H, W), bf16, with the channels of
# the map it reads (C, or a channel slice [offset, offset + C) of a wider
# map): the P3 neck map, the Proto's cv2 on its four phases stacked on the
# batch axis, the P5 adapter's, the heads' fused first conv's slice (offset
# 64 of 320 channels), and a narrow map (C = 64)
K7_SHAPES = (("P3 neck", (16, 256, 80, 80), None), ("Proto cv2 phases", (64, 256, 80, 80), None),
             ("P5 adapter", (16, 256, 20, 20), None),
             ("head slice", (16, 256, 80, 80), (64, 320)), ("C 64", (16, 64, 80, 80), None))
K7_PER_FORWARD = {"v1": 110, "v2": 98}  # eval BN + act calls of the serving forward
K7_MIN_ROOFLINE = 60.0  # % of the byte bound K7 should reach at the P3 neck shape


def bf16_steps(got, want):
    """|got - want| in bf16 steps of ``want``, a step taken no smaller than
    at 2^-12 of ``want``'s largest magnitude: near a zero crossing the
    chain's fp32 rounding moves the value by many steps of its own tiny
    size, whichever side rounds."""
    floor = want.float().abs().max() * 2.0 ** -12
    _, e = torch.frexp(torch.maximum(want.float().abs(), floor))
    return (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()), e - 8)


def route_bn_act(x, m, act, eager):
    """The models' route (``models/common.py::bn_act``) on ``x`` with the
    eval BN ``m``: K7 with no gradient wanted, the eager chain (cuDNN's
    fp32 BN, the activation, the cast) under autograd, ``m``'s parameters
    requiring a gradient."""
    from multitask_bonetumor_yolo_tpu_torch.models import common

    with torch.enable_grad() if eager else torch.no_grad():
        return common.bn_act(x, m, False, act).detach()


def phase_k7(dev, gen, card):
    """K7 against the eager chain, both through the models' route
    (:func:`route_bn_act`), at :data:`K7_SHAPES` (SiLU, then ELU and none
    at the P3 shape): at most 1 bf16 step (:func:`bf16_steps`) on at most
    1 % of the elements, one K7 launch per call and none on the eager
    chain; then "[k7-time]": K7's device time (profiler) beside its byte
    bound (2 + 2 bytes per element at the card's rate), its events time,
    and the eager chain's device and events times (``library_ms``).
    Returns the rows."""
    import torch.nn as nn

    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import bn_act as k7

    rows = []
    for name, (b, c, h, w), cut in K7_SHAPES:
        off, total = cut or (0, c)
        full = (torch.randn(b, total, h, w, generator=gen, device=dev) * 2).to(torch.bfloat16)
        x = full.contiguous(memory_format=torch.channels_last)[:, off:off + c]
        m = nn.BatchNorm2d(c, eps=1e-3).to(dev).eval()
        with torch.no_grad():
            m.running_mean.copy_(torch.randn(c, generator=gen, device=dev) * 0.5)
            m.running_var.copy_(torch.rand(c, generator=gen, device=dev) * 1.8 + 0.2)
            m.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen, device=dev))
            m.bias.copy_(0.3 * torch.randn(c, generator=gen, device=dev))
        for act in ("silu", "elu", "none") if name == "P3 neck" else ("silu",):
            before = k7.bn_act.launches
            got = route_bn_act(x, m, act, eager=False)
            want = route_bn_act(x, m, act, eager=True)
            if k7.bn_act.launches != before + 1:
                raise RuntimeError(f"[k7] {name} {act}: {k7.bn_act.launches - before} K7 "
                                   f"launches for one call on K7 and one on the eager chain")
            worst = bf16_steps(got, want).max().item()
            share = (got != want).float().mean().item()
            if worst > 1 or share > 0.01:
                raise RuntimeError(f"[k7] {name} {act}: {worst} bf16 steps from the eager "
                                   f"chain on {share:.3%} of the elements")
            log(f"[k7] {name} {(b, h, w, c)} of {total} channels from {off}, {act}: at most "
                f"{worst} bf16 step from the eager chain, on {share:.4%} of the elements")
        n = x.numel()
        bound_ms = 4 * n / PEAK_BYTES * 1e3

        def fast():
            return route_bn_act(x, m, "silu", eager=False)

        def slow():
            return route_bn_act(x, m, "silu", eager=True)

        ms = device_ms(fast, key="bn_act_kernel")
        lib_ms = device_ms(slow)
        ev = [cuda_ms(fast), cuda_ms(slow), cuda_ms(slow), cuda_ms(fast)]
        row = {"shape": [b, h, w, c], "name": name, "channels_of": total, "offset": off,
               "elements": n, "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "roofline_pct": 100 * bound_ms / ms, "events_ms": (ev[0] + ev[3]) / 2,
               "library_ms": lib_ms, "library_events_ms": (ev[1] + ev[2]) / 2,
               "speedup": lib_ms / ms}
        rows.append(row)
        log("[k7-time] " + json.dumps(row))
    p3 = rows[0]["roofline_pct"]
    if p3 < K7_MIN_ROOFLINE:
        log(f"[k7-time] NOTE: K7 at the P3 neck shape reaches {p3:.1f} % of its byte bound, "
            f"under {K7_MIN_ROOFLINE:.0f} %")
    log(f"[k7-time] {card}")
    return rows


def saved_mib(fn):
    """MiB that the autograd graph of ``fn()``'s output holds for its
    backward: the memory allocated while the output lives, less before."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - before) / 2**20
    del out
    return held


def phase_base(cnb, k2, dev, gen):
    """ConvNeXt-Base's widths (phase 21): K1 at batch 16, K1's saving form
    and K2 at batch 32 against their plain twins at the stage shapes of
    Base's kernel stages, timed beside the eager block, with their bounds
    ("[base-time]"); then the v1 model at Base's widths, served and trained
    under "auto", its launches and trunk counters per call ("[base-model]").
    Returns the rows, the launch counts and the largest errors."""
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch
    from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
    from multitask_bonetumor_yolo_tpu_torch.train import (
        TrainConfig, create_train_state, make_train_step,
    )
    from multitask_bonetumor_yolo_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, errs = [], {"k1": 0.0, "saving": 0.0, "dx": 0.0, "grad_of_scale": 0.0}
    for c, s, depth in BASE_STAGES:
        if c > cnb.HOPPER_MAX_CHANNELS:
            continue  # C = 1024: eager under "auto", no kernel takes it
        with torch.no_grad():
            shape = (BATCH, s, s, c)
            args = block_args(gen, *shape, torch.bfloat16, dev)
            got = cnb.convnext_block(*args)
            want, want_y = cnb.convnext_block_plain_saving(*args)
            err = check_close(f"[base] K1 {shape}", got, want, BF16_TOL)
            errs["k1"] = max(errs["k1"], err,
                             check_k1_designs(cnb, args, got, want, want_y, shape))
            del got, want, want_y
            # turns: routed, eager, eager, routed
            t = [cuda_ms(lambda: cnb.convnext_block(*args)),
                 cuda_ms(lambda: cnb.convnext_block_ref(*args))]
            t = [(t[0] + cuda_ms(lambda: cnb.convnext_block(*args))) / 2,
                 (t[1] + cuda_ms(lambda: cnb.convnext_block_ref(*args))) / 2]
            row = {"c": c, "hw": s, "depth": depth, "k1": {
                "shape": list(shape), "ms": t[0], "eager_ms": t[1], "max_abs_err": err}}
            row["k1"]["bound_ms"], row["k1"]["bound_by"] = k1_bound(*shape)
            del args

            shape = (BASE_TRAIN_BATCH, s, s, c)
            x, *params = block_args(gen, *shape, torch.bfloat16, dev)
            ops = cnb.kernel_operands(params, x.dtype, backward=True)
            out, y = cnb.convnext_block_saving(x, *params, ops=ops)
            want_out, want_y = cnb.convnext_block_plain_saving(x, *params)
            g = torch.randn(shape, generator=gen, device=dev).to(x.dtype)
            got = k2.convnext_block_bwd(x, y, g, *params, ops=ops)
            again = k2.convnext_block_bwd(x, y, g, *params, ops=ops)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"[base] K2 {shape}: two calls differ (want bit for bit)")
            del again
            want = k2.convnext_block_bwd_plain(x, y, g, *params)
            e_sav = max(check_close(f"[base] K1 saving {shape} out", out, want_out, BF16_TOL),
                        check_close(f"[base] K1 saving {shape} y", y, want_y, BF16_TOL))
            e_dx, e_sc = check_grads(f"[base] K2 {shape}", got, want, BF16_TOL)
            errs["saving"] = max(errs["saving"], e_sav)
            errs["dx"], errs["grad_of_scale"] = max(errs["dx"], e_dx), max(errs["grad_of_scale"],
                                                                           e_sc)
            del out, want_out, want_y, got, want
            t_sav = cuda_ms(lambda: cnb.convnext_block_saving(x, *params, ops=ops))
            t_k2 = cuda_ms(lambda: k2.convnext_block_bwd(x, y, g, *params, ops=ops), iters=10)
            t_fwd = cuda_ms(lambda: cnb.convnext_block_ref(x, *params))
        leaves = [t_.detach().requires_grad_() for t_ in (x, *params)]
        ref_out = cnb.convnext_block_ref(*leaves)
        t_bwd = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True),
                        iters=10)
        del ref_out

        def fused():
            torch.autograd.grad(cnb.convnext_block(*leaves, bwd="fused"), leaves, g)

        def eager():
            torch.autograd.grad(cnb.convnext_block_ref(*leaves), leaves, g)

        # turns: fused, eager, eager, fused
        t_fused, t_eager = cuda_ms(fused, iters=10), cuda_ms(eager, iters=10)
        t_eager, t_fused = (t_eager + cuda_ms(eager, iters=10)) / 2, \
            (t_fused + cuda_ms(fused, iters=10)) / 2
        row["saving"] = {"shape": list(shape), "ms": t_sav, "eager_fwd_ms": t_fwd,
                         "max_abs_err": e_sav}
        row["saving"]["bound_ms"], row["saving"]["bound_by"] = k1_bound(*shape, saving=True)
        row["k2"] = {"shape": list(shape), "ms": t_k2, "eager_bwd_ms": t_bwd,
                     "max_abs_err_dx": e_dx, "grad_err_of_scale": e_sc}
        row["k2"]["bound_ms"], row["k2"]["bound_by"] = k2_bound(*shape)
        row["fwd_bwd"] = {"fused_ms": t_fused, "eager_ms": t_eager,
                          "fused_saved_mib": saved_mib(lambda: cnb.convnext_block(
                              *leaves, bwd="fused")),
                          "eager_saved_mib": saved_mib(lambda: cnb.convnext_block_ref(*leaves))}
        rows.append(row)
        del x, params, leaves, ops, y, g
        torch.cuda.empty_cache()
        k1r, sr, k2r, fb = row["k1"], row["saving"], row["k2"], row["fwd_bwd"]
        log(f"[base-time] C={c} {s}x{s}: K1 batch {BATCH} {k1r['ms']:.4f} ms against the eager "
            f"block's {k1r['eager_ms']:.4f} (bound {k1r['bound_ms']:.4f}, {k1r['bound_by']}); "
            f"batch {BASE_TRAIN_BATCH}: K1 saving {sr['ms']:.4f} ms (bound {sr['bound_ms']:.4f}), "
            f"K2 {k2r['ms']:.4f} ms (bound {k2r['bound_ms']:.4f}) against eager forward "
            f"{t_fwd:.4f} and autograd backward {t_bwd:.4f}; forward + backward fused "
            f"{fb['fused_ms']:.4f} against eager {fb['eager_ms']:.4f} ms, holding "
            f"{fb['fused_saved_mib']:.0f} against {fb['eager_saved_mib']:.0f} MiB for the "
            f"backward; errors K1 {k1r['max_abs_err']:.3e}, saving {e_sav:.3e}, K2 dx "
            f"{e_dx:.3e}, gradients {e_sc:.3e} of scale (tol {BF16_TOL})")

    # the model at Base's widths through its normal path, the tracer on
    cfg = ModelConfig(img_size=IMG, dtype="bfloat16",
                      backbone_depths=tuple(d for _, _, d in BASE_STAGES),
                      backbone_dims=tuple(c for c, _, _ in BASE_STAGES))
    want_k = auto_blocks(cnb, BASE_STAGES)
    want_e = sum(cfg.backbone_depths) - want_k
    model = build_model(cfg, seed=SEED, device=dev)
    randomize(model, gen)
    request = torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev,
                            dtype=torch.uint8)
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    with torch.no_grad():
        infer_batch(model, request)  # warm-up
    state = create_train_state(cfg, TrainConfig(), model=model)
    step = make_train_step(cfg, LossConfig(img_size=IMG))
    batch = synthetic_batch(BASE_TRAIN_BATCH, IMG, gen)
    state, _, _ = step(state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    profiling.enable()
    try:
        reset_counts(*counts)
        with torch.no_grad():
            res = infer_batch(model, request)
        torch.cuda.synchronize()
        serve = tuple(fn.launches for fn in counts)
        check_outputs(res.outputs, BATCH, cfg)
        reset_counts(*counts)
        state, metrics, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        train = tuple(fn.launches for fn in counts)
        per_root = profiling.report()["per_root"]
    finally:
        profiling.disable()
        profiling.reset()
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(v == v and abs(v) != float("inf") for v in vals.values()) \
            or vals["step_skipped"] != 0.0:
        raise RuntimeError(f"[base-model] the train step is not finite or was skipped: {vals}")
    if serve != (want_k, 0, 0) or train != (0, want_k, want_k):
        raise RuntimeError(f"[base-model] launches (K1, K1 saving, K2) per forward {serve}, per "
                           f"step {train}; want ({want_k}, 0, 0) and (0, {want_k}, {want_k})")
    trunk = {root: (per_root[root].get("trunk.blocks.kernel", 0),
                    per_root[root].get("trunk.blocks.eager", 0)) for root in ("infer", "train_step")}
    if any(v != (want_k, want_e) for v in trunk.values()):
        raise RuntimeError(f"[base-model] trunk.blocks (kernel, eager) per root {trunk}, want "
                           f"({want_k}, {want_e})")
    log(f"[base-model] v1 at ConvNeXt-Base's widths {cfg.backbone_dims}, depths "
        f"{cfg.backbone_depths}, bf16, {IMG}^2: launches (K1, K1 saving, K2) per batch-{BATCH} "
        f"forward {serve}, per batch-{BASE_TRAIN_BATCH} train step {train}; trunk.blocks "
        f"(kernel, eager) per root {trunk}; step loss {vals['loss_total']:.4f}, grad_norm "
        f"{vals['grad_norm']:.4f}")
    del model, state, step, batch, res
    totals = {}
    for key, sub in (("k1", "k1"), ("saving", "saving"), ("k2", "k2")):
        stages = [(r["c"], r["hw"], r["depth"]) for r in rows]
        b_ms, b_by = depth_sum([(r[sub]["bound_ms"], r[sub]["bound_by"]) for r in rows], stages)
        totals[key] = {"ms": sum(r["depth"] * r[sub]["ms"] for r in rows),
                       "bound_ms": b_ms, "bound_by": b_by}
    out = {"rows": rows, "totals": totals, "launches": {"forward": serve, "train_step": train},
           "trunk_blocks": trunk, "errors": errs}
    log("[base] " + json.dumps(out))
    return out


def timed_build(name):
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    path, report = build.build(name)
    return path, report, time.perf_counter() - t0


PHASES = ("kernel", "model", "infer-cli", "eval", "trainer", "ddp", "raw", "tools", "recipe", "k2",
          "k2-split", "train", "k3", "k4", "k4-split", "fwdbwd", "k7", "lab", "base")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run, in the full run's order (of "
                         + ", ".join(PHASES) + "; infer-cli and eval bring model with them); "
                         "a partial run prints no kernels line and no result line")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    if only - set(PHASES):
        raise SystemExit(f"unknown phases {sorted(only - set(PHASES))}")
    if only & {"infer-cli", "eval"}:  # they take the model phase's model
        only.add("model")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import dwconv as k3

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    names = ("convnext_block", "convnext_block_bwd", "dwconv", "jpeg", "bn_act", "kernel_lab",
             "kernel_lab_v0")
    if only and "lab" not in only:
        names = names[:5]
    with ThreadPoolExecutor(len(names)) as ex:
        builds = dict(zip(names, ex.map(timed_build, names)))
    for name, (path, report, secs) in builds.items():
        BUILD_REPORTS[name] = report
        log(f"[build] {path.name} in {secs:.2f} s (the builds ran in parallel)")
        lines = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln
                 or ("Compiling entry" in ln and ("k2h" in ln or "k1h" in ln or "dwconv7" in ln))]
        if name.startswith("kernel_lab"):  # ~90 instantiations each: a summary
            regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines if "Used " in ln]
            spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes spill")
                      and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
            log(f"[build] {name}: {len(regs)} kernels, registers {min(regs, default=0)}"
                f"-{max(regs, default=0)}; with spills: {spills or 'none'}")
            continue
        for line in lines:
            log(f"[build] {line}")
    top = cnb.HOPPER_MAX_CHANNELS  # the model's block route reads it: both libraries' ceiling
    for route in (cnb.forward_route, k2.hopper_route):
        if not route(torch.bfloat16, top) or route(torch.bfloat16, top + 16):
            raise RuntimeError(f"{route.__module__}.{route.__name__}: the library's bf16 ceiling "
                               f"is not HOPPER_MAX_CHANNELS = {top}")
    for c in (48, 96, 192, 384, 512):  # the Hopper kernels, one instantiation per width
        for saving in (False, True):
            log(f"[build] K1 Hopper design at C={c}{' (saving form)' if saving else ''}: "
                f"{json.dumps(cnb.hopper_tile(c, saving))}")
        v1 = (f"; K4's: {json.dumps(k2.row_pass_config(c, v1=True))}"
              if k2.bwd_v1_route(torch.bfloat16, c) else "")
        log(f"[build] K2 row pass at C={c}: {json.dumps(k2.row_pass_config(c))}{v1}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    r = {}  # each phase's result, by phase

    def infer_cli():
        _, model, conf = r["model"]
        return phase_infer_cli(cnb, model, conf, dev, gen)

    def eval_phase():
        launches, model, _ = r["model"]
        r["model"] = (launches,)  # the served model is freed before the train phases
        return phase_eval(cnb, model, dev, card)

    table = (
        ("kernel", lambda: phase_kernel(cnb, dev, gen)),
        ("model", lambda: phase_model(cnb, dev, gen)),
        ("infer-cli", infer_cli),
        ("eval", eval_phase),
        ("trainer", lambda: phase_trainer(cnb, k2, dev, card)),
        ("ddp", lambda: phase_ddp(dev, card, r["trainer"][1] if "trainer" in r else None)),
        ("raw", lambda: phase_raw(cnb, dev, gen, card)),
        ("tools", lambda: phase_tools(card)),
        ("recipe", lambda: phase_recipe(cnb, k2, card)),
        ("k2", lambda: phase_training_kernels(cnb, k2, dev, gen)),
        ("k2-split", lambda: phase_k2_split(cnb, k2, dev, gen)),
        ("train", lambda: phase_train(cnb, k2, dev, gen)),
        ("k3", lambda: phase_dwconv(k3, dev, gen)),
        ("k4", lambda: phase_bwd_v1(cnb, k2, dev, gen)),
        ("k4-split", lambda: phase_k4_split(k2, dev, gen)),
        ("fwdbwd", lambda: phase_block_fwdbwd(cnb, k2, k3, dev, gen)),
        ("k7", lambda: phase_k7(dev, gen, card)),
        ("lab", lambda: phase_lab(cnb, dev)),
        ("base", lambda: phase_base(cnb, k2, dev, gen)),
    )
    assert tuple(name for name, _ in table) == PHASES
    for name, run in table:
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        r[name] = run()
        torch.cuda.empty_cache()
        log(f"[phase] {name} took {time.perf_counter() - t0:.1f} s")
    if only:  # a partial run, for bring-up: nothing is printed after its phases
        return 0

    max_err, per_stage, k_ms, p_ms = r["kernel"]
    launches, k7_launches = r["model"][0]
    eval_launches = r["eval"]
    trainer_launches, _ = r["trainer"]
    ddp_launches = r["ddp"]
    k6_entries, _ = r["raw"]
    err_sav, err_dx, err_scale, bwd_stages, tot = r["k2"]
    k2_split = r["k2-split"]
    _, n_saving, n_bwd = r["train"]
    err_k3, k3_stages, k3_build = r["k3"]
    err_k4_dx, err_k4_scale, k4_stages = r["k4"]
    k4_split = r["k4-split"]
    fb_launches, fb_table, fb_totals, fb_grad_err = r["fwdbwd"]
    lab_entry = r["lab"]
    k7_rows = r["k7"]
    base = r["base"]

    def base_widths(key, launches):  # phase 21's rows of one kernel, ConvNeXt-Base's widths
        return {"launches": launches, **base["totals"][key],
                "per_stage": [{**row[key], **(row["fwd_bwd"] if key == "k2" else {})}
                              for row in base["rows"]]}

    infer_bound = depth_sum([k1_bound(BATCH, s, s, c) for c, s, _ in STAGES], STAGES)
    common = {"route": "cuda", "library_ms": None}
    log(json.dumps({"kernels": [
        {"name": "convnext_block", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py:165",
         "launches": launches, "eval_launches": eval_launches,
         "trainer_launches": trainer_launches[0], "ddp_launches_per_rank": ddp_launches[0],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "first_design_ms": sum(d * row["first_design_ms"]
                                for (_, _, d), row in zip(STAGES, per_stage)),
         "bound_ms": infer_bound[0], "bound_by": infer_bound[1], "per_stage": per_stage,
         "base_widths": base_widths("k1", base["launches"]["forward"][0])},
        {"name": "convnext_block_saving", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py:563",
         "launches": n_saving, "trainer_launches": trainer_launches[1],
         "ddp_launches_per_rank": ddp_launches[1],
         "max_abs_err": err_sav, "ms": tot["sav"],
         "plain_ms": tot["sav_plain"], "first_design_ms": tot["sav_v0"],
         "bound_ms": tot["sav_bound"][0], "bound_by": tot["sav_bound"][1],
         "per_stage": [{"shape": row["shape"], "ms": row["saving_ms"],
                        "first_design_ms": row["saving_first_design_ms"],
                        "plain_ms": row["saving_plain_ms"], "eager_fwd_ms": row["eager_fwd_ms"],
                        "bound_ms": row["saving_bound_ms"], "bound_by": row["saving_bound_by"],
                        "max_abs_err": row["saving_max_abs_err"]} for row in bwd_stages],
         "base_widths": base_widths("saving", base["launches"]["train_step"][1])},
        {"name": "convnext_block_bwd", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block_bwd.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block_bwd.py:312",
         "launches": n_bwd, "trainer_launches": trainer_launches[2],
         "ddp_launches_per_rank": ddp_launches[2],
         "max_abs_err": err_dx, "grad_err_of_scale": err_scale,
         "ms": tot["k2"], "plain_ms": tot["plain"], "bound_ms": tot["bound"][0],
         "bound_by": tot["bound"][1], "eager_bwd_ms": tot["eager"],
         "launches_per_call": max(r["launches_per_call"] for r in k2_split
                                  if r["dtype"] == "torch.bfloat16"),
         "per_stage": bwd_stages, "split": k2_split,
         "base_widths": base_widths("k2", base["launches"]["train_step"][2])},
        {"name": "dwconv7", "route": "cuda",
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/dwconv.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/dwconv.py:25",
         "launches": fb_launches["explicit"][4], "max_abs_err": err_k3,
         **path_totals(k3_stages, 2, ("ms", "first_design_ms", "plain_ms", "library_ms")),
         "registers": k3_build["registers"],
         "instructions_per_value": k3_build["instructions_per_value"],
         "per_stage": k3_stages},
        {"name": "convnext_block_bwd_v1", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block_bwd.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block_bwd.py:43",
         "launches": fb_launches["fused_v1"][3], "max_abs_err": err_k4_dx,
         "grad_err_of_scale": err_k4_scale,
         **path_totals(k4_stages, 1, ("ms", "first_design_ms", "plain_ms", "eager_bwd_ms")),
         "launches_per_call": max(r["launches_per_call"] for r in k4_split
                                  if r["design"] == "route"),
         "per_stage": k4_stages, "split": k4_split},
        {"name": "kernel_lab", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/kernel_lab.cu",
         "replaces": "scripts/kernel_lab.py:37", **lab_entry},
        *k6_entries,
        {"name": "bn_act", "route": "cuda",
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/bn_act.cu",
         "replaces": None, "launches": k7_launches, "ms": k7_rows[0]["ms"],
         "bound_ms": k7_rows[0]["bound_ms"], "bound_by": "bytes",
         "library_ms": k7_rows[0]["library_ms"], "per_shape": k7_rows},
    ]}))
    log("[block-fwdbwd] " + json.dumps({"per_stage": fb_table, "trunk_ms": fb_totals,
                                         "launches (K1, K1 saving, K2, K4, K3)": fb_launches,
                                         "grad_err_of_scale": fb_grad_err}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
