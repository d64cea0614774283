"""Per-component timing of the batch-8 640^2 multitask train step
(forward + backward + AdamW).

    python -m multitask_bonetumor_yolo_tpu_torch.tools.profile_train \\
        [--batch 8] [--img 640] [--iters 10] [--skip-full] [--device cuda]

Counterpart of ``scripts/profile_train.py``: the same sections and rows, in
the same order, in bf16, each timed by :func:`..utils.timing.timeloop`
(CUDA events on the card; the host clock on the CPU):

  * the full step, ``make_train_step`` with the default ``AugmentConfig``
    (K1's saving form and K2 at stages 0-2: 15 launches each per step; the
    step updates the state in place, as the trainer's does); fwd+bwd
    without the optimizer; forward + loss; the train-mode forward alone;
    the loss's forward and backward against frozen model outputs; the
    clipped AdamW update alone (``TrainState.apply_gradients``). A full
    row's input is the script's: one GT box per image, empty masks.
    ``--skip-full`` leaves these six out;
  * per stage, one block's forward and backward (gradients of x, the
    depthwise taps and both products) under the port's routes, named by
    the port: ``ref`` (K1 + the vjp of the eager block; the JAX script's
    "default"), ``eager`` (the eager block under autograd; its "xla"),
    ``fused_v1`` (K1 + K4; its "fused", which calls ``fused_block_bwd``)
    and ``fused`` (K1's saving form + K2, the route the model's
    ``block_bwd="auto"`` takes at C <= 384); then the trunk's totals by
    depth;
  * the backbone (trunk + C2f), BiFPN, Segment and Detect heads' forward +
    backward in train mode, gradients of their parameters, on the script's
    random inputs (BiFPN 256 / 384 / 512 channels, heads 256).

The JAX script's docstring names an augment stage that its code never
times; neither does this tool. Nothing is caught: where the JAX script's
``timed`` reports -1 for a failure, a kernel that fails here to build or
launch raises. A row's note gives the hand-written kernels its call
launched, per call.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.preprocess import AugmentConfig
from ..losses import LossConfig, multitask_loss
from ..models import ModelConfig, build_model
from ..ops.kernels.convnext_block import convnext_block, convnext_block_ref
from ..train import TrainConfig, create_train_state, make_train_step
from .bench_block import stage_shapes
from .common import Rows, resolve_device, timed
from .profile_infer import _sum, nchw, stage_inputs

ROUTES = ("ref", "eager", "fused_v1", "fused")  # the per-stage columns, the first in the row name


def block_fn(route: str):
    """The block under ``route``: the eager block, or ``convnext_block`` with
    that backward."""
    if route == "eager":
        return convnext_block_ref
    return lambda *a: convnext_block(*a, bwd=route)


def block_grads(route: str, x, w) -> list:
    """One block's forward and backward under ``route``: the gradients of
    the sum of its output with respect to x, the taps and both products
    (the JAX script's ``argnums=(0, 1, 5, 7)``)."""
    leaves = [x.detach().requires_grad_(), *(t.detach().requires_grad_() for t in
                                             (w[0], w[4], w[6]))]
    args = list(w)
    args[0], args[4], args[6] = leaves[1:]
    out = block_fn(route)(leaves[0], *args)
    return torch.autograd.grad(out.float().sum(), leaves)


def param_grads(module, loss_fn) -> list:
    """Gradients of ``loss_fn()`` with respect to ``module``'s parameters
    (unused ones as zeros)."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss_fn(), params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-component timing of the train step")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--skip-full", action="store_true",
                    help="skip the full-model sections (fast re-run of the per-component "
                         "sections)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    return ap


def main(argv=None) -> list:
    """Print the rows; returns them (dicts of name, ms, note, launches per
    call; the per-stage rows also ``routes``: ms by route, and
    ``route_launches``)."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    B, S, it = args.batch, args.img, args.iters
    dt = torch.bfloat16
    t = Rows(52)
    rng = np.random.RandomState(0)

    def rand(*shape, dtype=dt, layout=nchw):
        x = torch.from_numpy(rng.rand(*shape)).to(device=device, dtype=dtype)
        return layout(x) if layout else x

    cfg = ModelConfig(img_size=S, dtype="bfloat16")
    loss_cfg = LossConfig(img_size=S)
    model = build_model(cfg, seed=TrainConfig.seed, device=device)
    x0 = rand(B, S, S, 3, dtype=torch.float32, layout=None)
    boxes = torch.tensor([[0, 0.5, 0.5, 0.3, 0.3]], device=device).repeat(B, 8, 1)
    gt = {
        "boxes": boxes,
        "box_valid": torch.tensor([True] + [False] * 7, device=device).repeat(B, 1),
        "mask": torch.zeros(B, S, S, 1, device=device),
        "img_cls": torch.zeros(B, dtype=torch.int32, device=device),
        "id": torch.arange(B, dtype=torch.int32, device=device),
    }
    print(f"batch={B} img={S} device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)

    if not args.skip_full:
        # ---------------- FULL train step (fwd+bwd+AdamW) ----------------
        state = create_train_state(cfg, TrainConfig(steps_per_epoch=1), model=model)
        step = make_train_step(cfg, loss_cfg, AugmentConfig())
        gen = torch.Generator(device=device).manual_seed(0)
        batch = {**gt, "image": (x0 * 255).to(torch.uint8)}

        def full_body():
            _, metrics, _ = step(state, batch, gen)
            return metrics["loss_total"]

        t.time("FULL train step (fwd+bwd+AdamW, no donate)", full_body, it, device)

        # ---------------- fwd+bwd only (no optimizer) ---------------------
        params = state.params()

        def loss_of(x):
            out = model(x, train=True, mode="train")
            return multitask_loss(out, {**gt, "image": x}, loss_cfg, True).total

        def fwdbwd_body():
            loss = loss_of(x0)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss, grads

        t.time("fwd+bwd (value_and_grad, no opt)", fwdbwd_body, it, device)

        # ---------------- forward only ------------------------------------
        with torch.no_grad():
            t.time("forward + loss only", lambda: loss_of(x0), it, device)
            t.time("forward only (train mode, no loss)",
                   lambda: model(x0, train=True, mode="train"), it, device)
            out0 = model(x0, train=True, mode="train")

        # ---------------- loss fwd+bwd only (frozen model outputs) --------
        def loss_grad_body():
            leaves = [out0["seg_coeffs"], out0["protos"], out0["seg_logits"],
                      out0["cls_logits"], *out0["det_feats"]]
            leaves = [v.detach().requires_grad_() for v in leaves]
            o = {"seg_coeffs": leaves[0], "protos": leaves[1], "seg_logits": leaves[2],
                 "cls_logits": leaves[3], "det_feats": leaves[4:]}
            loss = multitask_loss(o, {**gt, "image": x0}, loss_cfg, True).total
            return torch.autograd.grad(loss, leaves, allow_unused=True)

        t.time("loss fwd+bwd only (vs frozen outputs)", loss_grad_body, it, device)
        del out0

        # ---------------- optimizer update only ---------------------------
        zgrads = [torch.zeros_like(p) for p in params]
        bn_before = state.bn_snapshot()
        t.time("AdamW + clip update only", lambda: state.apply_gradients(zgrads, bn_before), it,
               device)
        del zgrads

    # ---------------- per-stage block fwd+bwd ----------------
    totals = dict.fromkeys(ROUTES, 0.0)
    for si, (hw, c, depth) in enumerate(stage_shapes(S)):
        xs, *w = stage_inputs(si, B, hw, c, device)
        ms, launches = {}, {}
        for route in ROUTES:
            ms[route], launches[route] = timed(lambda: block_grads(route, xs, w), it, device)
            totals[route] += ms[route] * depth
        t.report(f"stage{si} block {hw}x{hw}x{c} fwd+bwd {ROUTES[0]}", ms[ROUTES[0]],
                 " ".join(f"{r}={ms[r]:.3f}" for r in ROUTES[1:]) + f" x{depth}",
                 launches[ROUTES[0]])
        t.rows[-1].update(routes=ms, route_launches=launches)
    del xs, w
    t.report("TRUNK fwd+bwd totals", totals[ROUTES[0]],
             " ".join(f"{r}={totals[r]:.2f}" for r in ROUTES[1:]))

    # ---------------- backbone / neck / heads fwd+bwd ----------------
    xb = nchw(x0.to(dt))
    t.time("BACKBONE fwd+bwd (trunk + C2f)",
           lambda: param_grads(model.backbone, lambda: _sum(model.backbone(xb, True))), it, device)

    feats0 = [rand(B, S // 8, S // 8, 256), rand(B, S // 16, S // 16, 384),
              rand(B, S // 32, S // 32, 512)]
    t.time("BiFPN x2 fwd+bwd",
           lambda: param_grads(model.neck, lambda: _sum(model.neck(feats0, True))), it, device)
    del feats0

    pfeats = [rand(B, S // s, S // s, 256) for s in (8, 16, 32)]

    def seg_loss():
        raw, coeffs, protos = model.segment(pfeats, True)
        return _sum(raw) + coeffs.float().sum() + protos.float().sum()

    t.time("Segment head fwd+bwd", lambda: param_grads(model.segment, seg_loss), it, device)
    t.time("Detect head fwd+bwd",
           lambda: param_grads(model.detect, lambda: _sum(model.detect(pfeats, True))), it, device)
    if not args.skip_full:
        ms = {row["name"]: row["ms"] for row in t.rows}
        parts = ("BACKBONE fwd+bwd (trunk + C2f)", "BiFPN x2 fwd+bwd", "Segment head fwd+bwd",
                 "Detect head fwd+bwd", "loss fwd+bwd only (vs frozen outputs)",
                 "AdamW + clip update only")
        print(f"  {'components (backbone .. Detect, loss, AdamW)':<52s} "
              f"{sum(ms[k] for k in parts):8.3f} ms  against FULL "
              f"{ms['FULL train step (fwd+bwd+AdamW, no donate)']:.3f}: each timed alone, with "
              f"its own launch gaps and host issue in its events", flush=True)
    return t.rows


if __name__ == "__main__":
    main()
