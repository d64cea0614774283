"""CLI: train the multitask model (counterpart of the JAX ``cli/train.py``).

    python -m multitask_bonetumor_yolo_tpu_torch.cli.train --root btxrd_ready \
        --run-dir runs/exp1 --image-ext .png [--epochs 500 --batch-size 4 ...]

The flags and defaults are the JAX CLI's (the reference's knobs: batch 4,
lr 1e-4, 500 epochs, IoU match 0.5, loss weights 1 / 7.5 / 1.5 / 0.5 / 1,
label smoothing 0.1, early stop 50, mAP50-95 every 5 epochs), plus:

* ``--device`` (default ``cuda``): without a card it raises unless given
  ``cpu``. As in the JAX CLI, ``--batch-size`` is per rank and every
  visible card takes part: one rank per card (NCCL), the global batch
  ``--batch-size`` times the ranks. Under torchrun the CLI joins torchrun's
  group; otherwise ``--nproc`` (default every visible card, 1 on the CPU)
  ranks are spawned, with a ``file://`` store in the run directory.
  ``--device cpu --nproc 2`` runs two gloo ranks on the CPU;
* ``--image-ext`` (default ``.jpeg``, as ``DataConfig``): the image files
  under ``root/images``. PNG and JPEG are read by the port's own codecs on
  every machine (a JPEG decoded on ``--device``), other formats only where
  cv2 or PIL is installed.

The JAX CLI turns on XLA's persistent compilation cache first; the port
compiles nothing per run but its CUDA kernels, which
``ops/kernels/build.py`` builds once into ``build/kernels/`` and reuses.
The checkpoints (``train/checkpoint.py``) go to ``<run-dir>/checkpoints``
with the ``config.json`` that ``cli.evaluate`` reads.
"""

from __future__ import annotations

import argparse

import torch

from ..data.dataset import DataConfig
from ..data.preprocess import AugmentConfig
from ..losses import LossConfig
from ..models import ModelConfig
from ..parallel import dist
from ..train.loop import ExperimentConfig, Trainer
from ..train.state import TrainConfig


def build_config(args) -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(
            nc_det=args.nc_det,
            nc_img=args.num_img_classes,
            proto_ch=args.proto_ch,
            img_size=args.img_size,
            single_head=args.single_head,
            dtype=args.dtype,
            bifpn_feature_size=args.bifpn_feature_size,
            bifpn_num_layers=args.bifpn_layers,
            backbone_depths=tuple(int(d) for d in args.backbone_depths.split(",")),
            backbone_dims=tuple(int(d) for d in args.backbone_dims.split(",")),
            eval_bn=args.eval_bn,
        ),
        data=DataConfig(
            root=args.root,
            img_size=args.img_size,
            batch_size=args.batch_size,
            max_boxes=args.max_boxes,
            seed=args.data_seed,
            image_ext=args.image_ext,
        ),
        loss=LossConfig(
            img_size=args.img_size,
            nc_det=args.nc_det,
            iou_match_thresh=args.iou_match_thresh,
            weight_seg=args.loss_weight_seg,
            weight_box_iou=args.loss_weight_box_iou,
            weight_dfl=args.loss_weight_dfl,
            weight_cls_det=args.loss_weight_cls_det,
            weight_img_cls=args.loss_weight_img_cls,
            det_label_smoothing=args.det_label_smoothing,
            assigner=args.assigner,
        ),
        train=TrainConfig(
            lr=args.lr,
            weight_decay=args.weight_decay,
            max_epochs=args.epochs,
            grad_clip=args.grad_clip,
            seed=args.seed,
            early_stop_patience=args.early_stop_patience,
            map_full_freq=args.map_full_freq,
            eval_top_k=args.map_max_detections,
        ),
        augment=AugmentConfig(hsv_h=args.hsv_h, hsv_s=args.hsv_s, hsv_v=args.hsv_v,
                              hflip_prob=args.hflip, mosaic_prob=args.mosaic),
        run_dir=args.run_dir,
        log_every=args.log_every,
        wandb_project=args.wandb_project,
    )


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the multitask model (PyTorch port)")
    ap.add_argument("--root", default="btxrd_ready")
    ap.add_argument("--run-dir", default="runs/default")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--grad-clip", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--data-seed", type=int, default=42)
    ap.add_argument("--nc-det", type=int, default=2)
    ap.add_argument("--num-img-classes", type=int, default=2)
    ap.add_argument("--proto-ch", type=int, default=32)
    ap.add_argument("--max-boxes", type=int, default=32)
    ap.add_argument("--single-head", action="store_true",
                    help="v2 variant: detection sliced from the Segment head")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--bifpn-feature-size", type=int, default=256)
    ap.add_argument("--bifpn-layers", type=int, default=2)
    ap.add_argument("--backbone-depths", default="3,3,9,3",
                    help="comma-separated ConvNeXt stage depths (default: Tiny)")
    ap.add_argument("--backbone-dims", default="96,192,384,768",
                    help="comma-separated ConvNeXt stage dims (default: Tiny)")
    ap.add_argument("--eval-bn", default="reference", choices=["reference", "frozen"],
                    help="'reference' replicates the BN val quirk (momentum .9997; "
                    "running stats track the last train batch); 'frozen' uses torch "
                    "default momentum so val metrics are deterministic for fixed params")
    ap.add_argument("--iou-match-thresh", type=float, default=0.5)
    ap.add_argument("--assigner", default="reference", choices=["reference", "tal"],
                    help="'reference' replicates the pred-IoU>thresh hard-target "
                    "assigner (running_main_v3.py:317-347); 'tal' uses task-aligned "
                    "soft targets (breaks the documented ~0.43 mAP50 ceiling)")
    ap.add_argument("--loss-weight-seg", type=float, default=1.0)
    ap.add_argument("--loss-weight-box-iou", type=float, default=7.5)
    ap.add_argument("--loss-weight-dfl", type=float, default=1.5)
    ap.add_argument("--loss-weight-cls-det", type=float, default=0.5)
    ap.add_argument("--loss-weight-img-cls", type=float, default=1.0)
    ap.add_argument("--det-label-smoothing", type=float, default=0.1)
    ap.add_argument("--early-stop-patience", type=int, default=50)
    ap.add_argument("--map-full-freq", type=int, default=5)
    ap.add_argument("--map-max-detections", type=int, default=100)
    ap.add_argument("--hsv-h", type=float, default=0.0)
    ap.add_argument("--hsv-s", type=float, default=0.0)
    ap.add_argument("--hsv-v", type=float, default=0.0)
    ap.add_argument("--hflip", type=float, default=0.0)
    ap.add_argument("--mosaic", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--wandb-project", default=None)
    ap.add_argument("--resume", default=None, metavar="PATH|auto",
                    help="resume from a checkpoint path, or 'auto' for the run dir's "
                    "last checkpoint")
    ap.add_argument("--convnext-ckpt", default=None,
                    help="torch state dict (.pt/.pth/.safetensors) of timm convnext_tiny "
                    "for the backbone warm start (reference main_model.py:21-26)")
    ap.add_argument("--detect-ckpt", default=None,
                    help="torch state dict of a YOLOv8 Detect model for the head warm start "
                    "(reference load_pretrained_heads, main_model.py:399-603)")
    ap.add_argument("--segment-ckpt", default=None,
                    help="torch state dict of a YOLOv8-seg model for the Segment-head "
                    "warm start")
    ap.add_argument("--image-ext", default=DataConfig.image_ext,
                    help="image file suffix under images/ (.png and .jpeg are read on every "
                    "machine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' to run without a card)")
    add_rank_flags(ap)
    return ap


def add_rank_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to spawn, one per card over NCCL, gloo on the CPU (default: "
                    "every visible card on cuda, 1 on the CPU); ignored under torchrun, "
                    "whose group is joined")


def run(args, device: torch.device) -> Trainer:
    """Train on this rank (``device`` its own)."""
    cfg = build_config(args)
    trainer = Trainer(cfg, resume=args.resume, convnext_ckpt=args.convnext_ckpt,
                      detect_ckpt=args.detect_ckpt, segment_ckpt=args.segment_ckpt,
                      device=device)
    if trainer.is_main:
        print(f"[train] {len(trainer.train_ds)} train / {len(trainer.val_ds)} val items, "
              f"{trainer.train_cfg.steps_per_epoch} steps/epoch of {trainer.global_batch} on "
              f"{trainer.mesh.shape['data']} rank(s), run dir {cfg.run_dir}")
    trainer.fit()
    if trainer.is_main:
        print("[train] finished")
    return trainer


def main(argv=None) -> Trainer | None:
    """Returns the trainer of this process's rank, or ``None`` in a process
    that spawned the ranks."""
    args = make_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    return dist.run_ranks(run, (args,), args.device, args.nproc, args.run_dir)


if __name__ == "__main__":
    main()
