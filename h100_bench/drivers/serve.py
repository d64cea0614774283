"""Serving: one caller in a closed loop sends back-to-back requests to the
program's serving entry, ``cli/infer.py::infer_batch``: a batch of
letterboxed uint8 images handed over as host numpy (so the upload counts),
answered with the model's outputs, NMS and the instance masks. Each request
is timed from the call to its results on the device, after a synchronise.

Traffic parameters: ``batch`` images per request from a ``ring`` of
distinct batches of synthetic radiographs (``images``: ``inputs.py``);
``conf_thresh``, ``nms_iou``, ``top_k``, ``instance_masks``; ``candidates``
anchors per image above the confidence, set by shifting the detection
head's class biases by what the fp32 reference gives on ``shift_images``
images of the first batch (random weights score no anchor above any usual
confidence; a trained detector passes a few hundred per image);
``warmup`` requests before the window; ``check_requests`` requests drawn
from the seed among the first ``check_within`` of the window, judged
after it, with ``check_pixels`` pixels of each instance mask;
``profile_calls`` requests under the profiler with ``--trace 1``.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict

import numpy as np
import torch

from h100_bench import compare, harness, inputs, tracing, weights
from h100_bench.reference import post
from h100_bench.reference.model import decode
from h100_bench.reference.precision import Precision, no_tf32


def prepare(cfg: Dict, tr: Dict, seed: int, device: torch.device):
    """The weights (class biases shifted) and the ring [R, B, S, S, 3]."""
    s, b = cfg["img_size"], tr["batch"]
    gen = torch.Generator(device=device).manual_seed(seed)
    state = weights.make_state(cfg, seed, device)
    ring = inputs.radiographs(tr["ring"] * b, s, gen, tr["images"]).view(tr["ring"], b, s, s, 3)
    ref = harness.reference_model(cfg, state)
    with torch.no_grad(), no_tf32():
        x = ring[0, : tr["shift_images"]].float() / 255.0
        best = ref(x)["det_preds"][..., 4:].amax(-1)
    q = torch.quantile(best.flatten().double(), 1.0 - tr["candidates"] / best.shape[1]).item()
    logit = lambda p: math.log(p / (1.0 - p))  # noqa: E731
    weights.shift_class_bias(state, cfg, logit(tr["conf_thresh"]) - logit(q))
    return state, ring


def checked_requests(tr: Dict, seed: int):
    return sorted(random.Random(seed).sample(range(tr["check_within"]), tr["check_requests"]))


def mask_pixels(cfg: Dict, tr: Dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    s = cfg["img_size"]
    return torch.randperm(s * s, generator=gen)[: tr["check_pixels"]].to(device)


def run(ctx: harness.Context) -> harness.Outcome:
    from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as k1

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    state, ring = prepare(cfg, tr, ctx.seed, dev)
    model = harness.program_model(cfg, state, dev)
    host = ring.cpu().numpy()
    kw = dict(conf_thresh=tr["conf_thresh"], nms_iou=tr["nms_iou"], top_k=tr["top_k"],
              instance_masks=tr["instance_masks"])
    for i in range(tr["warmup"]):
        infer_batch(model, host[i % len(host)], **kw)
    harness.sync(dev)
    checked = checked_requests(tr, ctx.seed)
    pixels = mask_pixels(cfg, tr, ctx.seed, dev)
    neck = []  # the neck's maps of the request being judged

    def keep_neck(m, a, o):
        if n in checked:
            neck[:] = o

    spans = tracing.Spans(dev)
    hooks = [model.neck.register_forward_hook(keep_neck)]
    if ctx.trace:
        def forward_done(m, a, o):
            spans.end("forward")
            spans.start("post")

        hooks += [model.register_forward_pre_hook(lambda m, a: spans.start("forward")),
                  model.register_forward_hook(forward_done)]
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    setup_s = time.perf_counter() - ctx.t0
    kept, lat, finite, n = {}, [], [], -1
    start = time.perf_counter()
    while True:
        n += 1
        t = time.perf_counter()
        res = infer_batch(model, host[n % len(host)], **kw)
        harness.sync(dev)
        lat.append(time.perf_counter() - t)
        if ctx.trace:
            spans.end("post")
        finite.append(torch.isfinite(res.detections.scores).all())
        if n in checked:
            kept[n] = compare.Served(
                {k: res.outputs[k] for k in compare.SERVE_OUTPUTS},
                post.Detections(*res.detections),
                compare.mask_digest(res.instance_masks, pixels), list(neck))
        if time.perf_counter() - start >= ctx.seconds and n >= checked[-1]:
            break
    n += 1
    harness.sync(dev)
    window_s = time.perf_counter() - start
    failed = n - int(torch.stack(finite).sum())
    del res
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    for h in hooks:
        h.remove()

    trace = None
    if ctx.trace:
        k1.convnext_block.launches = 0
        infer_batch(model, host[0], **kw)
        harness.sync(dev)
        launches = k1.convnext_block.launches
        pc = tr["profile_calls"]
        summ, prof_s = tracing.profile(lambda: infer_batch(model, host[0], **kw), pc, dev)
        trace = harness.TraceData(
            config=cfg, traffic=tr, spans=spans.ms(), calls=n, rows=tr["batch"],
            window_s=window_s, counters={"k1_launches": launches},
            kernels=summ["kernels"], profile_calls=pc, profile_s=prof_s,
            busy_s=summ["busy_s"],
            breakdown={"device_ops": summ["device_ops"], "idle_gaps": summ["idle_gaps"]})

    del model
    harness.sync(dev)
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference_numbers(cfg, tr, state, ring, kept, pixels)
    detail = {"reference_s": time.perf_counter() - t_ref}
    return harness.Outcome(
        attempted=n, failed=failed,
        end_to_end={"serve_img_per_s": n * tr["batch"] / window_s,
                    "serve_p95_ms": float(np.percentile(np.array(lat) * 1e3, 95)),
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        numbers=numbers, memory_peak_bytes=max(peak, setup_peak), trace=trace, detail=detail)


def reference_numbers(cfg, tr, state, ring, answers: Dict[int, compare.Served],
                      pixels) -> Dict[str, float]:
    """The worst of each number over the judged requests, against the fp32
    reference on each request's images."""
    ref = harness.reference_model(cfg, state)
    worst = None
    for i, answer in sorted(answers.items()):
        with torch.no_grad(), no_tf32():
            feats = ref.features(ring[i % len(ring)].float() / 255.0)
            heads = ref.heads(answer.neck)
            seg = ref.project(answer.outputs["protos"])
            nums = compare.serve_numbers(answer, feats, heads, seg, cfg, tr, pixels)
        worst = nums if worst is None else compare.worst(worst, nums)
        del feats, heads, seg
    return worst


def reference_answer(cfg, tr, ref, images, pixels, precision: Precision) -> compare.Served:
    """The reference put in the program's place: its forward, decode, NMS
    and masks computed at ``precision`` (the control)."""
    q = precision.q
    with torch.no_grad(), no_tf32():
        feats = ref.features(images.float() / 255.0)
        o = ref.heads(feats)
        o["det_preds"] = q(decode([q(t) for t in o["det_feats"]], cfg["nc_det"],
                                  cfg["img_size"], cfg["reg_max"]))
        o["cls_probs"] = q(torch.softmax(q(o["cls_logits"]), -1))
        o["seg_prob"] = q(torch.sigmoid(q(o["seg_logits"])))
        det = post.nms(o["det_preds"], cfg["img_size"], tr["conf_thresh"], tr["nms_iou"],
                       tr["top_k"], precision)
        m = post.masks(o["seg_coeffs"], o["protos"], det, cfg["img_size"], precision)
        return compare.Served({k: o[k] for k in compare.SERVE_OUTPUTS}, det,
                              compare.mask_digest(m, pixels), feats)


def control_numbers(cfg: Dict, tr: Dict, seed: int, device, precision: Precision) -> Dict:
    """The numbers of the reference at ``precision`` in the program's place,
    on the requests a run with ``seed`` judges."""
    state, ring = prepare(cfg, tr, seed, device)
    pixels = mask_pixels(cfg, tr, seed, device)
    ctl = harness.reference_model(cfg, state, precision)
    answers = {i: reference_answer(cfg, tr, ctl, ring[i % len(ring)], pixels, precision)
               for i in checked_requests(tr, seed)}
    del ctl
    return reference_numbers(cfg, tr, state, ring, answers, pixels)

