"""Per-component timing of the batch-16 640^2 multitask inference path.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.profile_infer \\
        [--batch 16] [--img 640] [--iters 20] [--device cuda]

Counterpart of ``scripts/profile_infer.py``: the same rows, in the same
order and under the same names, each timed by
:func:`..utils.timing.timeloop` (CUDA events on the card: the slope between
n and 3n back-to-back calls; the host clock on the CPU), in bf16:

  * FULL: ``MultitaskModel`` (``build_model``, ``pallas="auto"``: K1 at
    stages 0-2, 15 launches per forward) in inference mode + NMS
    (``ops/nms.py::postprocess_detections``), with the ``torch.profiler``
    device time beside it (:func:`..utils.timing.device_ms`): the host shows
    in the events' number where it issues slower than the card runs;
  * per stage, one block through K1 (``convnext_block``: one launch per
    call; the row's name keeps the JAX word ``pallas`` for the kernel path,
    as ``ModelConfig.pallas`` does) against the eager block, at the
    script's draws (x uniform in [0, 1), taps N(0, 0.1^2), products
    N(0, 0.02^2), zero biases, gamma 1e-6);
  * the model's own modules, timed on the script's random inputs:
    ``ConvNeXtFeatures`` (TRUNK), ``ConvNeXtTiny`` (BACKBONE: trunk + the
    three C2f adapters), ``BiFPN`` (inputs of 256 / 384 / 512 channels),
    ``SegmentHead`` and ``DetectHead`` (inputs of 256), then
    ``decode_detections`` on raw maps of 64 + 2 channels, NMS on
    ``rand(B, A, 6)`` and ``ops/resize.py::resize_bilinear`` of a
    1-channel map to S x S.

The NMS row's input passes nearly every anchor (the larger of two uniform
scores is above conf 0.05 for 99.75 % of them) as sub-pixel boxes, so it
times NMS over ~8,400 candidates per image, not the serving NMS (~250). Its
note gives the count. A row's note also gives the hand-written kernels it
launched per call. Nothing is caught: a kernel that fails to build or launch
raises. :func:`component_fns` are the functions the component rows time, on
the model's own weights; chained, they give the model's outputs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import ModelConfig, build_model
from ..models.heads import decode_detections
from ..ops.kernels.convnext_block import convnext_block, convnext_block_ref
from ..ops.nms import postprocess_detections
from ..ops.resize import resize_bilinear
from ..utils.timing import device_ms
from .bench_block import stage_shapes
from .common import Rows, resolve_device, timed


def stage_inputs(stage: int, b: int, hw: int, c: int, device) -> tuple:
    """The profile's block inputs at ``stage`` (``RandomState(stage)``): x
    bf16 NHWC in [0, 1), then the block's parameters in the port's layouts,
    fp32."""
    rng = np.random.RandomState(stage)
    x = torch.from_numpy(rng.rand(b, hw, hw, c)).to(device=device, dtype=torch.bfloat16)

    def n(*shape, std):
        return torch.from_numpy(rng.randn(*shape) * std).to(device=device, dtype=torch.float32)

    z = torch.zeros(c, device=device)
    return (x, n(c, 1, 7, 7, std=0.1), z, torch.ones(c, device=device), z,
            n(4 * c, c, std=0.02), torch.zeros(4 * c, device=device), n(c, 4 * c, std=0.02),
            z, torch.full((c,), 1e-6, device=device))


def component_fns(model) -> dict:
    """The component rows' functions on ``model``'s own modules (eval
    forward; NCHW ``channels_last`` maps in the compute dtype):
    ``trunk(x) -> (p3, p4, p5)``, ``c2f(p3, p4, p5) -> 3 maps``,
    ``backbone(x)``, ``neck(c3, c4, c5) -> 3 maps``, ``segment(f3, f4, f5) ->
    (raw levels, coeffs, protos)``, ``detect(f3, f4, f5) -> raw levels``,
    ``decode(*raw NHWC levels) -> [B, A, 4 + nc]``."""
    cfg, bb = model.cfg, model.backbone
    fns = {
        "trunk": lambda x: bb.trunk(x),
        "c2f": lambda p3, p4, p5: (bb.c2f_p3(p3), bb.c2f_p4(p4), bb.c2f_p5(p5)),
        "backbone": lambda x: bb(x),
        "neck": lambda *feats: model.neck(list(feats)),
        "segment": lambda *feats: model.segment(list(feats)),
        "decode": lambda *raw: decode_detections(list(raw), cfg.nc_det, cfg.img_size,
                                                 cfg.reg_max),
    }
    if not cfg.single_head:
        fns["detect"] = lambda *feats: model.detect(list(feats))
    return fns


def _sum(ts) -> torch.Tensor:
    return sum(t.float().sum() for t in ts)


def nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the model's NCHW ``channels_last`` layout."""
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-component timing of batch inference")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    return ap


def main(argv=None) -> list:
    """Print the rows and the summary; returns the rows (dicts of name, ms,
    note, launches per call; the FULL row also ``device_ms``, None on the
    CPU)."""
    args = make_parser().parse_args(argv)
    with torch.no_grad():
        return profile(args)


def profile(args) -> list:
    device = resolve_device(args.device)
    B, S, it = args.batch, args.img, args.iters
    dt = torch.bfloat16
    t = Rows(46)
    rng = np.random.RandomState(0)

    def rand(*shape, dtype=dt, layout=nchw):
        x = torch.from_numpy(rng.rand(*shape)).to(device=device, dtype=dtype)
        return layout(x) if layout else x

    # ---------------- full model ----------------
    model = build_model(ModelConfig(img_size=S, dtype="bfloat16"), seed=0, device=device)
    x0 = rand(B, S, S, 3, dtype=torch.float32, layout=None)

    def full_body():
        out = model(x0, train=False, mode="infer")
        return postprocess_detections(out["det_preds"], S), out

    print(f"batch={B} img={S} device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    full_ms, launches = timed(full_body, it, device)
    full_dev = device_ms(full_body) if device.type == "cuda" else None
    t.report("FULL multitask infer (model+decode+NMS)", full_ms,
             "" if full_dev is None else f"device {full_dev:.3f} ms (torch.profiler)", launches)
    t.rows[-1]["device_ms"] = full_dev

    # ---------------- ConvNeXt blocks per stage, K1 vs eager -------------
    stage_ms = {}
    for si, (hw, c, depth) in enumerate(stage_shapes(S)):
        xs, *w = stage_inputs(si, B, hw, c, device)
        k1, launches = timed(lambda: convnext_block(xs, *w), it, device)
        ref, _ = timed(lambda: convnext_block_ref(xs, *w), it, device)
        best = min(k1, ref)
        stage_ms[si] = best * depth
        t.report(f"stage{si} block {hw}x{hw}x{c} pallas", k1,
                 f"eager={ref:.3f} x{depth} -> stage {best * depth:.2f} ms best", launches)
    del xs, w

    # ---------------- the model's components ----------------
    fn = component_fns(model)
    xb = nchw(x0.to(dt))
    trunk_ms, launches = timed(lambda: _sum(fn["trunk"](xb)), it, device)
    blocks_total = sum(stage_ms.values())
    t.report("TRUNK total", trunk_ms,
             f"blocks~{blocks_total:.2f} stem/downsample~{trunk_ms - blocks_total:.2f}", launches)

    bb_ms, launches = timed(lambda: _sum(fn["backbone"](xb)), it, device)
    t.report("BACKBONE (trunk + 3 C2f adapters)", bb_ms, f"C2f adapters~{bb_ms - trunk_ms:.2f}",
             launches)

    feats0 = [rand(B, S // 8, S // 8, 256), rand(B, S // 16, S // 16, 384),
              rand(B, S // 32, S // 32, 512)]
    t.time("BiFPN x2", lambda: _sum(fn["neck"](*feats0)), it, device)
    del feats0

    pfeats = [rand(B, S // s, S // s, 256) for s in (8, 16, 32)]

    def seg_body():
        raw, coeffs, protos = fn["segment"](*pfeats)
        return _sum(raw) + coeffs.float().sum() + protos.float().sum()

    t.time("Segment head", seg_body, it, device)
    t.time("Detect head", lambda: _sum(fn["detect"](*pfeats)), it, device)
    del pfeats

    # ---------------- decode + NMS ----------------
    raw_feats = [rand(B, S // s, S // s, 64 + 2, dtype=torch.float32, layout=None)
                 for s in (8, 16, 32)]
    t.time("decode_detections", lambda: fn["decode"](*raw_feats).sum(), it, device)

    na = (S // 8) ** 2 + (S // 16) ** 2 + (S // 32) ** 2
    preds0 = rand(B, na, 6, dtype=torch.float32, layout=None)
    cand = (preds0[..., 4:].amax(-1) > 0.05).sum().item() / B
    t.time("NMS postprocess", lambda: postprocess_detections(preds0, S).scores.sum(), it, device,
           f"{cand:.0f} of {na} anchors per image pass conf 0.05 (serving: ~250)")

    # ---------------- seg projector resize (S/4 -> S) ----------------
    protos0 = rand(B, S // 4, S // 4, 1, dtype=torch.float32, layout=None)
    t.time("seg-logit resize 1ch -> SxS", lambda: resize_bilinear(protos0, S, S).sum(), it, device)

    print("\nSummary (ms per batch of %d):" % B)
    for row in t.rows:
        print(f"  {row['name']:<46s} {row['ms']:8.3f}  {row['note']}")
    parts = ("BACKBONE (trunk + 3 C2f adapters)", "BiFPN x2", "Segment head", "Detect head",
             "decode_detections", "seg-logit resize 1ch -> SxS")
    total = sum(row["ms"] for row in t.rows if row["name"] in parts)
    dev = "" if full_dev is None else f" (device {full_dev:.3f})"
    print(f"  {'components without NMS (backbone .. resize)':<46s} {total:8.3f}  against FULL "
          f"{full_ms:.3f}{dev}: each component is timed alone, with its own launch gaps and "
          f"host issue in its events; NMS is timed apart on ~{cand:.0f} candidates per image, "
          f"the full path's on the model's own")
    print(f"  full model throughput: {B / full_ms * 1000:.1f} img/s")
    return t.rows


if __name__ == "__main__":
    main()
