"""Diagnose the detection quality of a trained checkpoint.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.diagnose_det \\
        --run-dir /tmp/synth_run_v1 --root /tmp/synth_rich640 [--batches 4] \\
        [--device cuda]

Counterpart of ``scripts/diagnose_det.py`` (same flags, plus ``--device``;
the split's images are the loader's default ``.jpeg``). For the first 6
validation images it prints the GT and detection counts, then the top 10
detections by score with their label, their best IoU against the GT
(``core/boxes.py::box_iou_matrix``) and that GT's label; then the
class-aware and class-agnostic mAP50 over ``--batches`` batches
(``metrics/detection.py``), which tells duplicate boxes, wrong classes and
bad score ranking apart.

The run's best checkpoint (or its last) is restored into a bf16 model, as
the script fixes bf16, and each batch goes through ``make_eval_step``: the
reference's validation forward (K1 at stages 0-2 on the card), decode and
NMS at the eval thresholds. Without a card ``--device cuda`` (the default)
raises; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import resolve_device


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Diagnose detection quality of a checkpoint")
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--single-head", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run without a card)")
    return ap


def main(argv=None) -> dict:
    """Print the diagnosis; returns ``{"class_aware": mAP50, "agnostic":
    mAP50}`` (rounded as printed)."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)

    from .. import train
    from ..core.boxes import box_iou_matrix
    from ..data import BTXRD, BTXRDLoader, DataConfig, to_device
    from ..losses import LossConfig
    from ..metrics.detection import MeanAveragePrecision
    from ..models import ModelConfig
    from ..train.loop import gt_to_map_targets, nms_to_map_preds

    S = args.img_size
    model_cfg = ModelConfig(img_size=S, single_head=args.single_head, dtype="bfloat16")
    train_cfg = train.TrainConfig()
    state = train.create_train_state(model_cfg, train_cfg, device=device)
    cm = train.CheckpointManager(f"{args.run_dir}/checkpoints")
    best = cm.best_path() or cm.last_path()
    state = cm.restore(state, str(best))
    print(f"[diag] restored {best} (step {int(state.step)})")

    eval_step = train.make_eval_step(model_cfg, LossConfig(img_size=S), train_cfg)
    ds = BTXRD(DataConfig(root=args.root, img_size=S, batch_size=args.batch_size), "val",
               device=device)
    loader = BTXRDLoader(ds, args.batch_size, pad_last=True)

    agn50 = MeanAveragePrecision(iou_thresholds=[0.5])
    cls50 = MeanAveragePrecision(iou_thresholds=[0.5])
    shown = 0
    for bi, batch in enumerate(loader):
        if bi >= args.batches:
            break
        _, aux = eval_step(state, to_device(batch, device))
        keys = ("nms_boxes", "nms_scores", "nms_labels", "nms_valid")
        preds = nms_to_map_preds({k: aux[k].float().cpu().numpy() for k in keys})
        targets = gt_to_map_targets(np.asarray(batch["boxes"]), np.asarray(batch["box_valid"]), S)
        cls50.update(preds, targets)
        agn50.update(
            [dict(p, labels=np.zeros_like(p["labels"])) for p in preds],
            [dict(t, labels=np.zeros_like(t["labels"])) for t in targets],
        )
        for p, t in zip(preds, targets):
            if shown >= 6:
                continue
            shown += 1
            print(f"\nimage: {len(t['boxes'])} GT, {len(p['boxes'])} dets")
            if len(t["boxes"]) and len(p["boxes"]):
                iou = box_iou_matrix(torch.as_tensor(p["boxes"], dtype=torch.float32),
                                     torch.as_tensor(t["boxes"], dtype=torch.float32)).numpy()
            else:
                iou = np.zeros((len(p["boxes"]), max(1, len(t["boxes"]))))
            order = np.argsort(-p["scores"])[:10]
            for r in order:
                j = int(iou[r].argmax()) if iou.shape[1] else -1
                print(
                    f"  score={p['scores'][r]:.3f} label={p['labels'][r]} "
                    f"best_iou={iou[r].max() if iou.size else 0:.2f} "
                    f"gt_label={t['labels'][j] if j >= 0 and len(t['labels']) else '-'}"
                )
    out = {"class_aware": round(cls50.compute()["map_50"], 4),
           "agnostic": round(agn50.compute()["map_50"], 4)}
    print("\nclass-aware  mAP50:", out["class_aware"])
    print("class-AGNOSTIC mAP50:", out["agnostic"])
    return out


if __name__ == "__main__":
    main()
