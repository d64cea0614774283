"""Training: back-to-back calls of the program's train step
(``train/steps.py::make_train_step`` on a ``train/state.py::TrainState``),
the state carried from step to step as in training, no wait for the device
between steps.

Set-up builds the one state and step, and drives them through their first
``checked_steps`` steps on the first batches of the ring (rows that all
differ); those steps are the warm-up, and the reference follows them after
the window. The window continues the same state on the ring's next batches.

Traffic parameters: ``batch`` rows per step from a ``ring`` of device
batches (``batches``: ``inputs.py::train_batches``), the loss's
``assigner``, AdamW's ``lr``, ``weight_decay`` and ``grad_clip``,
``checked_steps``, and ``profile_calls`` steps under the profiler with
``--trace 1``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from h100_bench import compare, harness, inputs, tracing, weights
from h100_bench.reference import optim
from h100_bench.reference.loss import TERMS
from h100_bench.reference.precision import FP32, Precision, no_tf32

BN_STATS = ("running_mean", "running_var")


def prepare(cfg: Dict, tr: Dict, seed: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(seed)
    state = weights.make_state(cfg, seed, device)
    ring = inputs.train_batches(tr["ring"], tr["batch"], cfg["img_size"], gen, tr["batches"])
    return state, ring


def _bn_names(state: Dict) -> List[str]:
    return [k for k in state if k.endswith(BN_STATS)]


def run(ctx: harness.Context) -> harness.Outcome:
    from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
    from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2
    from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                          make_train_step)
    from multitask_bonetumor_yolo_tpu_torch.train.state import ADAM_B1

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    state0, ring = prepare(cfg, tr, ctx.seed, dev)
    mcfg = harness.model_config(cfg)
    model = harness.program_model(cfg, state0, dev)
    ts = create_train_state(mcfg, TrainConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                                              grad_clip=tr["grad_clip"]), model=model)
    step = make_train_step(mcfg, LossConfig(img_size=cfg["img_size"], nc_det=cfg["nc_det"],
                                            reg_max=cfg["reg_max"], assigner=tr["assigner"]))
    names = [n for n, _ in model.named_parameters()]
    logs = []
    for i in range(tr["checked_steps"]):
        _, m, aux = step(ts, ring[i], None)
        logs.append(m)
        if i == 0:
            mu1 = ts.mu.clone()
            fwd1 = {k: aux[k] for k in ("cls_logits", "seg_prob")}
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    harness.sync(dev)

    spans = tracing.Spans(dev)
    hooks = []
    apply = ts.apply_gradients
    if ctx.trace:
        hooks = [model.register_forward_pre_hook(lambda m, a: spans.start("forward")),
                 model.register_forward_hook(lambda m, a, o: spans.end("forward"))]

        def timed_apply(*a, **k):
            spans.start("optimizer")
            out = apply(*a, **k)
            spans.end("optimizer")
            return out

        ts.apply_gradients = timed_apply
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    setup_s = time.perf_counter() - ctx.t0
    skipped, n = [], 0
    k0 = tr["checked_steps"]
    start = time.perf_counter()
    while True:
        _, m, _ = step(ts, ring[(k0 + n) % len(ring)], None)
        skipped.append(m["step_skipped"])
        n += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    for h in hooks:
        h.remove()
    ts.apply_gradients = apply

    trace = None
    if ctx.trace:
        k2.convnext_block_bwd.launches = 0
        step(ts, ring[0], None)
        harness.sync(dev)
        launches = k2.convnext_block_bwd.launches
        pc = tr["profile_calls"]
        summ, prof_s = tracing.profile(lambda: step(ts, ring[0], None), pc, dev)
        trace = harness.TraceData(
            config=cfg, traffic=tr, spans=spans.ms(), calls=n, rows=tr["batch"],
            window_s=window_s, counters={"k2_launches": launches},
            kernels=summ["kernels"], profile_calls=pc, profile_s=prof_s,
            busy_s=summ["busy_s"],
            breakdown={"device_ops": summ["device_ops"], "idle_gaps": summ["idle_gaps"]})

    failed = int(sum(float(s) for s in skipped)) + \
        int(sum(float(m["step_skipped"]) for m in logs))
    g1 = dict(zip(names, mu1.split([p.numel() for p in model.parameters()])))
    prog = {
        "losses": [{k: float(m[f"loss_{k}"]) for k in TERMS} for m in logs],
        "gnorms": [float(m["grad_norm"]) for m in logs],
        "grad1": {n_: (g / (1.0 - ADAM_B1)).view_as(state0[n_]) for n_, g in g1.items()},
        "delta": {n_: after[n_] - state0[n_] for n_ in names},
        "bn_delta": {n_: after[n_] - state0[n_] for n_ in _bn_names(state0)},
        "fwd1": fwd1,
    }
    del model, ts, step, after, mu1, g1, logs, m, aux
    harness.sync(dev)
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_record(cfg, tr, state0, ring, FP32)
    detail = dict(compare.train_detail(prog, ref), reference_s=time.perf_counter() - t_ref)
    return harness.Outcome(
        attempted=n, failed=failed,
        end_to_end={"train_img_per_s": n * tr["batch"] / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        numbers=compare.train_numbers(prog, ref), memory_peak_bytes=max(peak, setup_peak),
        trace=trace, detail=detail)


def reference_record(cfg: Dict, tr: Dict, state0: Dict, ring, precision: Precision,
                     rows: int = 0) -> Dict:
    """The reference's first ``checked_steps`` steps from ``state0`` on the
    ring's first batches, at ``precision``; ``rows`` > 0 keeps only that
    many rows of each batch (a fault: part of the batch left out)."""
    ref = harness.reference_model(cfg, state0, precision, clone=True)
    ref.ctx.checkpoint = ring[0]["image"].is_cuda
    params = [p for _, p in ref.named_parameters()]
    opt = optim.AdamW(params, lr=tr["lr"], weight_decay=tr["weight_decay"],
                      grad_clip=tr["grad_clip"])
    losses, gnorms = [], []
    with no_tf32():
        for i in range(tr["checked_steps"]):
            batch = ring[i] if rows <= 0 else {k: v[:rows] for k, v in ring[i].items()}
            terms, norm, grads, fwd = optim.train_step(ref, opt, batch, tr["assigner"])
            losses.append({k: float(v) for k, v in terms.items()})
            gnorms.append(float(norm))
            if i == 0:
                grad1, fwd1 = grads, fwd
            del grads, fwd
    sd = ref.state_dict()
    names = [n for n, _ in ref.named_parameters()]
    return {"losses": losses, "gnorms": gnorms, "grad1": grad1, "fwd1": fwd1,
            "delta": {n: sd[n] - state0[n] for n in names},
            "bn_delta": {n: sd[n] - state0[n] for n in _bn_names(state0)}}
