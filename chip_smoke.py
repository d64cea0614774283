"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):
  1. record the card (``nvidia-smi`` name and power limit);
  2. build the ConvNeXt-block kernel (K1) from ``csrc/`` and time the build;
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
     with ``pallas="on"`` and ``"off"`` (CUDA events, in turns off/on/on/off).
Prints the kernels' JSON line, the card's line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

SEED = 0
IMG = 640
BATCH = 16
STAGES = ((96, 160, 3), (192, 80, 3), (384, 40, 9), (768, 20, 3))  # C, H=W, depth
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
        per_stage.append({"shape": [BATCH, s, s, c], "ms": k_ms, "plain_ms": p_ms,
                          "eager_ms": t_eager, "max_abs_err": err})
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import build
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    path, report = build.build("convnext_block")
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err, per_stage, k_ms, p_ms = phase_kernel(cnb, dev, gen)
    launches = phase_model(cnb, dev, gen)

    log(json.dumps({"kernels": [{
        "name": "convnext_block",
        "route": "cuda",
        "source": "multitask_bonetumor_yolo_tpu_torch/csrc/convnext_block.cu",
        "replaces": "multitask_bonetumor_yolo_tpu/ops/pallas/convnext_block.py:165",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "per_stage": per_stage,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
