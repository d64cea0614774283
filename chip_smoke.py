"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):
  1. record the card (``nvidia-smi`` name and power limit);
  2. build the kernels from ``csrc/``, one nvcc per source, all at once: the
     ConvNeXt-block forward (K1) and the block backward (K2); time the builds;
  3. K1 against its plain twin at the four 640^2 stage shapes (batch 2),
     an odd non-square shape and a narrow (C=48) one, in bf16 (atol/rtol 3e-2) and fp32 (atol/rtol
     1e-2: the kernel's products run in TF32, the twin in full fp32); then
     K1, the twin and the eager block timed with CUDA events at the batch-16
     shapes the model gives it;
  4. the full-width v1 model (ConvNeXt-Tiny 3/3/9/3, BiFPN 256x2, 640^2,
     bf16) with seeded random weights, every parameter and BN statistic
     perturbed (``randomize``), serves 3 batches of 16 and 1 single image
     through ``infer_batch``; K1 must have launched exactly 18 times per
     forward, outputs must be finite with the right shapes, and
     ``cls_probs``, ``seg_prob`` and the pre-NMS ``det_preds`` (boxes in
     units of the image side) must agree with the same weights under
     ``pallas="off"`` (atol/rtol 3e-2) and be no farther from the fp32 eager
     model than 2x the bf16 eager path is. Random weights score no anchor
     above the CLI's 0.25, so requests are served at the confidence that
     passes ~250 anchors per image, with NMS and instance masks; NMS at that
     confidence and over all 16 x 8400 anchors (conf 0) must keep on the
     card what it keeps on the CPU;
  5. NMS and whole-request times (host clock), and batch-16 forward times
     with ``pallas="on"`` and ``"off"`` (CUDA events, in turns off/on/on/off);
  6. K1's residual-saving form (``out`` and the saved ``y``) and K2 against
     their plain versions at the stage shapes (batch 2), the odd shape and
     C=48, bf16 and fp32 (tolerances as in phase 3; K2's parameter gradients,
     sums over up to 204 800 pixels, judged against their own scale:
     max |got - want| <= tol * max |want|); then at the batch-8 stage shapes
     of the train path, the same checks in bf16, and K2 (on the operands
     that the forward folded), its plain version, the eager block's autograd
     backward and the saving form timed with CUDA events;
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
     the device's idle share ("[profile]").
Each phase sets the launch counts to 0 right before the path it drives and
reads them right after. Prints the kernels' JSON line, the card's line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

SEED = 0
IMG = 640
BATCH = 16
TRAIN_BATCH = 8
STAGES = ((96, 160, 3), (192, 80, 3), (384, 40, 9), (768, 20, 3))  # C, H=W, depth
# H100 SXM datasheet peaks (dense): bf16 tensor cores, TF32 tensor cores,
# fp32 outside the tensor cores, device memory
PEAK_BF16, PEAK_TF32, PEAK_FP32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
BF16_TOL = 3e-2
FP32_TOL = 1e-2
CANDIDATES = 250  # anchors per image above the serving confidence


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


def phase_kernel(cnb, dev, gen):
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
            want = cnb.convnext_block_plain(*args)
            torch.cuda.synchronize()
            err = check_close(f"K1 {shape} {dt}", got, want, tol)
            if dt == torch.bfloat16:
                max_err = max(max_err, err)
            log(f"[k1] {shape} {str(dt):15s} max_abs_err {err:.3e} (tol {tol})")

    per_stage, k_total, p_total = [], 0.0, 0.0
    for c, s, depth in STAGES:
        args = block_args(gen, BATCH, s, s, c, torch.bfloat16, dev)
        err = check_close(f"K1 batch-16 {s}x{s}x{c}", cnb.convnext_block(*args),
                          cnb.convnext_block_plain(*args), BF16_TOL)
        max_err = max(max_err, err)
        t_plain = cuda_ms(lambda: cnb.convnext_block_plain(*args))
        t_k1 = cuda_ms(lambda: cnb.convnext_block(*args))
        t_eager = cuda_ms(lambda: cnb.convnext_block_ref(*args))
        t_k1b = cuda_ms(lambda: cnb.convnext_block(*args))
        t_plainb = cuda_ms(lambda: cnb.convnext_block_plain(*args))
        k_ms, p_ms = (t_k1 + t_k1b) / 2, (t_plain + t_plainb) / 2
        b_ms, b_by = k1_bound(BATCH, s, s, c)
        per_stage.append({"shape": [BATCH, s, s, c], "ms": k_ms, "plain_ms": p_ms,
                          "eager_ms": t_eager, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err})
        k_total += depth * k_ms
        p_total += depth * p_ms
        log(f"[k1-time] ({BATCH},{s},{s},{c}) bf16: kernel {t_k1:.4f}/{t_k1b:.4f} ms, "
            f"twin {t_plain:.4f}/{t_plainb:.4f} ms, eager erf block {t_eager:.4f} ms")
    return max_err, per_stage, k_total, p_total


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
    t0 = time.perf_counter()
    results = [infer_batch(model, r, **serve) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = cnb.convnext_block.launches
    depth = sum(cfg.backbone_depths)
    if launches != depth * len(requests):
        raise RuntimeError(f"K1 launched {launches} times, want {depth} x {len(requests)}")
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
        f"forward; detections kept per image (first batch): "
        f"{results[0].detections.valid.sum(1).tolist()}")

    # the same weights with the eager blocks, in bf16 and in fp32 (TF32 off)
    set_pallas(model, "off")
    off = infer_batch(model, requests[0]).outputs
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    ref32 = infer_batch(model, requests[0]).outputs
    model.cfg = cfg
    scale = torch.tensor([IMG] * 4 + [1] * cfg.nc_det, device=dev)

    def unit_boxes(out):  # boxes in units of the image side, like the scores
        return {**out, "det_preds": out["det_preds"] / scale}

    on, off, ref32 = unit_boxes(results[0].outputs), unit_boxes(off), unit_boxes(ref32)
    for k in ("cls_probs", "seg_prob", "det_preds"):
        err = check_close(f"model {k} on vs off", on[k], off[k], BF16_TOL)
        # K1 adds no error beyond bf16 rounding: against the fp32 eager
        # model, the kernel path may be at most 2x as far as the bf16 eager
        # path (plus 1e-3 of the output's scale). Dropping the blocks' MLP
        # breaks this by ~10x; the 3e-2 on/off bound alone would not see it.
        e_on = (on[k].float() - ref32[k]).abs().max().item()
        e_off = (off[k].float() - ref32[k]).abs().max().item()
        bound = 2.0 * e_off + 1e-3 * ref32[k].abs().max().item()
        if e_on > bound:
            raise RuntimeError(f"model {k}: K1 path {e_on:.3e} from fp32, eager bf16 "
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

    x = requests[0].float() / 255.0
    times = {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):
        set_pallas(model, mode)
        times[mode].append(cuda_ms(lambda: model(x), iters=10, warmup=2))
    torch.cuda.reset_peak_memory_stats()
    set_pallas(model, "on")
    model(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    on_ms, off_ms = sum(times["on"]) / 2, sum(times["off"]) / 2
    log(f"[model-time] batch-{BATCH} {IMG}^2 bf16 forward: pallas=on {times['on']} ms "
        f"(mean {on_ms:.3f}), pallas=off {times['off']} ms (mean {off_ms:.3f}); "
        f"{BATCH * 1000 / on_ms:.1f} img/s with K1; peak memory {peak:.2f} GiB")
    return launches


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


def phase_training_kernels(cnb, k2, dev, gen):
    """K1's saving form and K2 against their plain versions, then K2 timed."""
    shapes = [(2, s, s, c) for c, s, _ in STAGES] + [(1, 13, 21, 96), (3, 7, 5, 48)]
    err_sav, err_dx, err_scale = 0.0, 0.0, 0.0
    for shape in shapes:
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            x, *params = block_args(gen, *shape, dt, dev)
            out, y = cnb.convnext_block_saving(x, *params)
            want_out, want_y = cnb.convnext_block_plain_saving(x, *params)
            g = torch.randn(shape, generator=gen, device=dev).to(dt)
            got = k2.convnext_block_bwd(x, want_y, g, *params)
            want = k2.convnext_block_bwd_plain(x, want_y, g, *params)
            torch.cuda.synchronize()
            e_out = check_close(f"K1 saving {shape} {dt} out", out, want_out, tol)
            e_y = check_close(f"K1 saving {shape} {dt} y", y, want_y, tol)
            e_dx, e_sc = check_grads(f"K2 {shape} {dt}", got, want, tol)
            if dt == torch.bfloat16:
                err_sav = max(err_sav, e_out, e_y)
                err_dx, err_scale = max(err_dx, e_dx), max(err_scale, e_sc)
            log(f"[k2] {shape} {str(dt):15s} K1 saving out {e_out:.3e} y {e_y:.3e}; "
                f"K2 dx {e_dx:.3e}, gradients {e_sc:.3e} of scale (tol {tol})")

    per_stage, totals = [], {"k2": 0.0, "plain": 0.0, "eager": 0.0, "sav": 0.0, "sav_plain": 0.0}
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
        torch.cuda.synchronize()
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
        t_sav = cuda_ms(lambda: cnb.convnext_block_saving(x, *params))
        t_sav_plain = cuda_ms(lambda: cnb.convnext_block_plain_saving(x, *params), iters=5)
        b_ms, b_by = k2_bound(*shape)
        sb_ms, sb_by = k1_bound(*shape, saving=True)
        k_ms = (t_k2 + t_k2b) / 2
        per_stage.append({"shape": list(shape), "ms": k_ms, "plain_ms": t_plain,
                          "eager_bwd_ms": t_eager, "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err_dx": e_dx, "grad_err_of_scale": e_sc,
                          "saving_ms": t_sav, "saving_plain_ms": t_sav_plain,
                          "saving_bound_ms": sb_ms, "saving_bound_by": sb_by,
                          "saving_max_abs_err": max(e_out, e_y)})
        for key, v in (("k2", k_ms), ("plain", t_plain), ("eager", t_eager),
                       ("sav", t_sav), ("sav_plain", t_sav_plain)):
            totals[key] += depth * v
        log(f"[k2] {shape} bf16 K1 saving out {e_out:.3e} y {e_y:.3e}; K2 dx {e_dx:.3e}, "
            f"gradients {e_sc:.3e} of scale (tol {BF16_TOL})")
        log(f"[k2-time] {shape} bf16: K2 {t_k2:.4f}/{t_k2b:.4f} ms "
            f"(bound {b_ms:.4f} ms, {b_by}), plain {t_plain:.4f} ms, eager autograd backward "
            f"{t_eager:.4f} ms; K1 saving form {t_sav:.4f} ms (plain {t_sav_plain:.4f}, "
            f"bound {sb_ms:.4f} ms, {sb_by})")
    return err_sav, err_dx, err_scale, per_stage, totals


# Device kernels by category, first match wins, against the lower-cased
# demangled name. The port's kernels carry their own prefixes (K1
# ``cnb_forward_kernel``, K2 ``cnb_bwd_*_kernel``), which no PyTorch kernel has.
CATEGORIES = (
    ("K1 (convnext_block.cu)", ("cnb_forward_kernel",)),
    ("K2 (convnext_block_bwd.cu)", ("cnb_bwd_",)),
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_cat, count = defaultdict(float), 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_cat[category(evt.name)] += evt.device_time / 1e3 / PROFILE_STEPS
            count += 1
    device_ms = sum(by_cat.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
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
    kernel_blocks = sum(d for (c, _, d) in STAGES if c <= 384)
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


def timed_build(name):
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    path, report = build.build(name)
    return path, report, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    names = ("convnext_block", "convnext_block_bwd")
    with ThreadPoolExecutor(len(names)) as ex:
        builds = dict(zip(names, ex.map(timed_build, names)))
    for name, (path, report, secs) in builds.items():
        log(f"[build] {path.name} in {secs:.2f} s (the builds ran in parallel)")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err, per_stage, k_ms, p_ms = phase_kernel(cnb, dev, gen)
    launches = phase_model(cnb, dev, gen)
    err_sav, err_dx, err_scale, bwd_stages, tot = phase_training_kernels(cnb, k2, dev, gen)
    _, n_saving, n_bwd = phase_train(cnb, k2, dev, gen)

    infer_bound = depth_sum([k1_bound(BATCH, s, s, c) for c, s, _ in STAGES], STAGES)
    common = {"route": "cuda", "library_ms": None}
    log(json.dumps({"kernels": [
        {"name": "convnext_block", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py:165",
         "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": infer_bound[0], "bound_by": infer_bound[1], "per_stage": per_stage},
        {"name": "convnext_block_saving", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py:563",
         "launches": n_saving, "max_abs_err": err_sav, "ms": tot["sav"],
         "plain_ms": tot["sav_plain"], "bound_ms": tot["sav_bound"][0],
         "bound_by": tot["sav_bound"][1]},
        {"name": "convnext_block_bwd", **common,
         "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block_bwd.cu",
         "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block_bwd.py:312",
         "launches": n_bwd, "max_abs_err": err_dx, "grad_err_of_scale": err_scale,
         "ms": tot["k2"], "plain_ms": tot["plain"], "bound_ms": tot["bound"][0],
         "bound_by": tot["bound"][1], "eager_bwd_ms": tot["eager"], "per_stage": bwd_stages},
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
