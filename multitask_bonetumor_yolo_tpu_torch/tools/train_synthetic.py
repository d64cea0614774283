"""The quality-parity recipe: train the flagship model on a rich synthetic
BTXRD and evaluate its best checkpoint.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.train_synthetic \\
        --variant v1 --epochs 60 [--assigner tal --eval-bn frozen] [--device cuda]
    python -m multitask_bonetumor_yolo_tpu_torch.tools.train_synthetic \\
        --variant v2 --epochs 60   # single-head

Counterpart of ``scripts/train_synthetic.py`` (same flags, defaults and
steps, plus ``--device``):

  1. unless ``<data-dir>/img_cls.csv`` exists, write ``--n-images``
     class-discriminative images (ellipse against star lesions over
     radiograph-like backgrounds; ``make_synthetic_btxrd(..., seed=11,
     rich=True, min_size=480, max_size=800)``) as JPEGs, the JAX recipe's
     format, which the loader's default ``--image-ext .jpeg`` reads (on the
     card: the host entropy decode, then K6a and K6b);
  2. ``cli.train.main`` with :func:`train_argv`;
  3. ``cli.evaluate.main`` with :func:`eval_argv` on the run's best
     checkpoint (or its last), over the val split, with per-class metrics;
  4. :func:`summarize` the run's ``metrics.jsonl``: the best epoch, the
     validation mAP50 at every 10th epoch, the epochs' training img/s.

``--data-dir`` and ``--run-dir`` default to ``synth_rich640`` and
``synth_run_<variant>`` under the temporary directory (``/tmp`` unless
``TMPDIR`` says otherwise), as the JAX recipe's ``/tmp`` paths. Without a
card ``--device cuda`` (the default) raises; ``--device cpu`` runs the
recipe on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

from .common import resolve_device


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train and evaluate on rich synthetic BTXRD")
    ap.add_argument("--variant", choices=["v1", "v2"], default="v1")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n-images", type=int, default=320)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--iou-match-thresh", type=float, default=0.25,
                    help="the reference's 0.5 pred-IoU assigner cannot bootstrap from random "
                    "init (it trains from pretrained weights); 0.25 lets from-scratch "
                    "training start")
    ap.add_argument("--assigner", choices=["reference", "tal"], default="reference",
                    help="cls-target assigner; 'tal' (task-aligned, soft IoU-weighted "
                    "targets) is the documented swap-in point for the reference's hard "
                    "pred-IoU>thresh rule")
    ap.add_argument("--eval-bn", choices=["reference", "frozen"], default="reference",
                    help="'frozen' kills the replicated BN val-jitter quirk so checkpoint "
                    "selection is deterministic")
    ap.add_argument("--data-dir", default=os.path.join(tempfile.gettempdir(), "synth_rich640"))
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run without a card)")
    return ap


def train_argv(args, data_dir: str, run_dir: str) -> list:
    """``cli.train``'s arguments: the JAX recipe's, then ``--device``."""
    argv = [
        "--root", str(data_dir),
        "--run-dir", run_dir,
        "--img-size", str(args.img_size),
        "--batch-size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--lr", str(args.lr),
        "--iou-match-thresh", str(args.iou_match_thresh),
        "--assigner", args.assigner,
        "--eval-bn", args.eval_bn,
        "--map-full-freq", "10",
        "--log-every", "20",
        "--early-stop-patience", "30",
    ]
    if args.variant == "v2":
        argv.append("--single-head")
    return argv + ["--device", args.device]


def eval_argv(args, data_dir: str, run_dir: str, checkpoint) -> list:
    """``cli.evaluate``'s arguments: the JAX recipe's, then ``--device``."""
    argv = [
        "--checkpoint-path", str(checkpoint),
        "--root", str(data_dir),
        "--split", "val",
        "--img-size", str(args.img_size),
        "--batch-size", str(args.batch_size),
        "--run-dir", f"{run_dir}/eval",
        "--class-metrics",
    ]
    if args.variant == "v2":
        argv.append("--single-head")
    return argv + ["--device", args.device]


def summarize(metrics_path, batch_size: int) -> dict:
    """Print and return the trajectory of a run from its ``metrics.jsonl``:
    per epoch the validation mAP50 (and mAP50-95 where the epoch computed
    it) and the training img/s, the images of the epoch's steps
    (``batch_size`` each) over the epoch's host-clock seconds less its
    validation, checkpoint and overlays; the best epoch by mAP50 (the first
    of equals, as the trainer keeps it); the epochs' seconds in all and by
    ``PhaseTimer`` phase."""
    recs = [json.loads(line) for line in Path(metrics_path).open()]
    epochs = {r["step"]: r for r in recs if "train_epoch/epoch" in r}
    val = {r["step"]: r for r in recs if "val_epoch/map_iou50_map" in r}
    rows, last = [], 0
    for step in sorted(epochs):
        e, v = epochs[step], val[step]
        busy = e["train_epoch/epoch_time_s"] - sum(
            e.get(f"train_epoch/phase_{k}_s", 0.0) for k in ("validate", "checkpoint", "viz"))
        rows.append({"epoch": int(e["train_epoch/epoch"]), "step": step,
                     "map50": v["val_epoch/map_iou50_map"],
                     "map50_95": v.get("val_epoch/map_iou50_95_map"),
                     "img_s": (step - last) * batch_size / busy})
        last = step
    best = max(rows, key=lambda r: (r["map50"], -r["epoch"]))
    rates = sorted(r["img_s"] for r in rows[1:]) or [rows[0]["img_s"]]
    print(f"[summary] {len(rows)} epochs; best epoch {best['epoch']} (step {best['step']}): "
          f"val mAP50 {best['map50']:.4f}")
    print("[summary] val mAP50 by epoch: " + ", ".join(
        f"{r['epoch']}: {r['map50']:.4f}" for r in rows if r["epoch"] % 10 == 0
        or r is rows[-1]))
    print(f"[summary] train img/s per epoch: epoch 0 {rows[0]['img_s']:.2f}; after it median "
          f"{rates[len(rates) // 2]:.2f}, min {rates[0]:.2f}, max {rates[-1]:.2f}")
    phases = {k: sum(e.get(f"train_epoch/phase_{k}_s", 0.0) for e in epochs.values())
              for k in ("data", "train_step", "validate", "checkpoint", "viz")}
    total = sum(e["train_epoch/epoch_time_s"] for e in epochs.values())
    print(f"[summary] the epochs took {total:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phases.items()))
    return {"epochs": rows, "best": best, "seconds": total, "phases": phases}


def write_data(args) -> Path:
    """Step 1: the rich synthetic split under ``args.data_dir``, unless its
    ``img_cls.csv`` is there already."""
    from ..data.synthetic import make_synthetic_btxrd

    data_dir = Path(args.data_dir)
    if not (data_dir / "img_cls.csv").exists():
        print(f"[synth] generating {args.n_images} rich images ...", flush=True)
        make_synthetic_btxrd(str(data_dir), n=args.n_images, seed=11, rich=True,
                             min_size=480, max_size=800, image_format="jpeg")
    return data_dir


def main(argv=None) -> dict:
    """Run the recipe; returns ``cli.evaluate``'s metric table."""
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    data_dir = write_data(args)
    run_dir = args.run_dir or os.path.join(tempfile.gettempdir(), f"synth_run_{args.variant}")

    from ..cli.train import main as train_main

    train_main(train_argv(args, data_dir, run_dir))

    from ..train.checkpoint import CheckpointManager

    cm = CheckpointManager(f"{run_dir}/checkpoints")
    best = cm.best_path() or cm.last_path()
    print(f"[eval] best checkpoint: {best}")

    from ..cli.evaluate import main as eval_main

    table = eval_main(eval_argv(args, data_dir, run_dir, best))
    summarize(f"{run_dir}/metrics.jsonl", args.batch_size)
    return table


if __name__ == "__main__":
    main()
