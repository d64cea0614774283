"""CLI: image inference with the port (counterpart of the JAX ``cli/infer.py``).

    python -m multitask_bonetumor_yolo_tpu_torch.cli.infer \
        --checkpoint-path weights.npz --images img1.png img2.png --out-dir out/

The flags are the JAX CLI's, except that ``--checkpoint-path`` names the
bridge's ``.npz`` (``bridge.save_npz``; orbax checkpoints need JAX). PNG and
JPEG files are read by the port's own codecs (``data/imageio.py``,
``data/jpeg.py``, a JPEG decoded on ``--device``) on any machine; other
formats need cv2 or PIL. Runs on
``--device`` (default ``cuda``, the first card; without one it raises unless
the caller passes ``--device cpu``). Writes
``predictions.json`` (and ``<stem>_masks.npy`` with ``--instance-masks``)
and, as the JAX CLI does, each image's detection and segmentation overlays
(``RunLogger``) under ``<out-dir>/media/``.

:func:`infer_batch` is the serving entry point: uint8 NHWC letterboxed
images in, model outputs + NMS result (+ instance masks) out.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..bridge import flax_to_torch, load_npz
from ..core.letterbox import PAD_VALUE, letterbox_geometry
from ..data.imageio import read_image, resize_bilinear_u8
from ..models import ModelConfig, MultitaskModel
from ..ops.masks import compose_masks
from ..ops.nms import NMSResult, postprocess_detections
from ..utils.logging import RunLogger
from ..utils.profiling import span


class InferResult(NamedTuple):
    outputs: Dict[str, Any]  # the model's mode="infer" dict
    detections: NMSResult
    instance_masks: Optional[torch.Tensor]  # [B, K, S, S] or None


@torch.no_grad()
def infer_batch(
    model: MultitaskModel,
    images_uint8_nhwc,
    *,
    conf_thresh: float = 0.25,
    nms_iou: float = 0.6,
    top_k: int = 100,
    instance_masks: bool = False,
    mask_crop: bool = True,
) -> InferResult:
    """One forward + NMS (+ instance masks) over a batch of letterboxed
    uint8 images ``[B, S, S, 3]`` (numpy or tensor), on the model's device."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    with span("infer"):
        with span("infer.upload"):
            img = torch.as_tensor(images_uint8_nhwc).to(dev).float() / 255.0
        out = model(img, train=False, mode="infer")
        with span("nms"):
            det = postprocess_detections(
                out["det_preds"], cfg.img_size, iou_thresh=nms_iou,
                conf_thresh=conf_thresh, top_k=top_k,
            )
        inst = None
        if instance_masks:
            with span("masks"):
                inst = compose_masks(out["seg_coeffs"], out["protos"], det,
                                     crop=mask_crop, img_size=cfg.img_size)
    return InferResult(out, det, inst)


def load_and_letterbox(path: str, img_size: int, device="cuda") -> np.ndarray:
    """Top-left letterbox with gray(114) padding, uint8 [S, S, 3]; the resize
    is always the port's own (cv2's ``INTER_LINEAR``, within 1 LSB). A JPEG
    is decoded on ``device``."""
    img = read_image(path, device)
    h0, w0 = img.shape[:2]
    _, nh, nw = letterbox_geometry(h0, w0, img_size)
    canvas = np.full((img_size, img_size, 3), PAD_VALUE, np.uint8)
    canvas[:nh, :nw] = resize_bilinear_u8(img, nw, nh)
    return canvas


def load_model(cfg: ModelConfig, checkpoint_path: str, device) -> MultitaskModel:
    model = MultitaskModel(cfg)
    model.load_state_dict(flax_to_torch(*load_npz(checkpoint_path)), strict=True)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run multitask inference (PyTorch port)")
    ap.add_argument("--checkpoint-path", required=True, help="bridge .npz weights")
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--out-dir", default="runs/infer")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--nc-det", type=int, default=2)
    ap.add_argument("--num-img-classes", type=int, default=2)
    ap.add_argument("--single-head", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--conf-thresh", type=float, default=0.25)
    ap.add_argument("--nms-iou", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--instance-masks", action="store_true",
                    help="compose per-instance masks and write <stem>_masks.npy")
    ap.add_argument("--no-mask-crop", action="store_true",
                    help="with --instance-masks: skip the crop-to-box step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' to run without a card)")
    args = ap.parse_args(argv)

    cfg = ModelConfig(nc_det=args.nc_det, nc_img=args.num_img_classes,
                      img_size=args.img_size, single_head=args.single_head,
                      dtype=args.dtype)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    model = load_model(cfg, args.checkpoint_path, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    logger = RunLogger(str(out_dir))
    results = []
    for path in args.images:
        canvas = load_and_letterbox(path, args.img_size, device)
        res = infer_batch(model, canvas[None], conf_thresh=args.conf_thresh,
                          nms_iou=args.nms_iou, top_k=args.top_k,
                          instance_masks=args.instance_masks,
                          mask_crop=not args.no_mask_crop)
        det = res.detections
        nvalid = int(det.valid[0].sum())
        seg_probs = res.outputs["seg_prob"].float().cpu().numpy()
        seg_prob = seg_probs[0]
        imgs = canvas[None].astype(np.float32) / 255.0
        stem = Path(path).stem
        logger.log_det_examples(imgs, det.boxes.cpu().numpy(), det.scores.cpu().numpy(),
                                det.labels.cpu().numpy(), det.valid.cpu().numpy(), None, None,
                                stage=stem, step=0, conf_th=args.conf_thresh)
        logger.log_seg_examples(imgs, seg_probs, None, stage=stem, step=0)
        rec = {
            "image": path,
            "num_detections": nvalid,
            "boxes_xyxy": det.boxes[0, :nvalid].cpu().tolist(),
            "scores": det.scores[0, :nvalid].cpu().tolist(),
            "labels": det.labels[0, :nvalid].cpu().tolist(),
            "img_cls_probs": res.outputs["cls_probs"][0].float().cpu().tolist(),
            "mask_area_frac": float((seg_prob > 0.5).mean()),
        }
        if res.instance_masks is not None:
            binm = (res.instance_masks[0, :nvalid] > 0.5).cpu().numpy()
            mask_path = out_dir / f"{Path(path).stem}_masks.npy"
            np.save(mask_path, binm)
            rec["instance_masks"] = str(mask_path)
            rec["instance_mask_areas"] = [float(m) for m in binm.mean((1, 2))]
        results.append(rec)
        print(json.dumps(rec))
    logger.close()
    out_json = out_dir / "predictions.json"
    out_json.write_text(json.dumps(results, indent=2))
    print(f"[infer] wrote {out_json} and overlays under {out_dir}/media/")


if __name__ == "__main__":
    main()
