"""CLI: evaluate a checkpoint over a split with the full metric suite
(counterpart of the JAX ``cli/evaluate.py``).

    python -m multitask_bonetumor_yolo_tpu_torch.cli.evaluate \
        --checkpoint-path runs/exp1/checkpoints/step_00001234 \
        --root btxrd_ready --image-ext .png [--split val --batch-size 16 ...]

The metrics are the JAX CLI's: image-class accuracy / P / R / F1, seg F1 /
P / R / accuracy / Dice and mask mAP, detection mAP50 and mAP50-95, with
``main`` printing the same JSON. Model and loss flags (``--eval-bn``,
``--assigner``, ``--single-head``, ...) and ``--img-size`` / ``--max-boxes``
default from the ``config.json`` the trainer writes beside the checkpoints
(its ``model``, ``loss`` and ``data`` sections), and an explicit flag that
contradicts it raises unless ``--allow-config-mismatch``. Batches stay on the
card after the first pass (``DeviceEvalCache``), so ``--epochs N`` replays
the split with no file reads or copies. Each pass's metrics, seconds and
image count go to the run dir's ``metrics.jsonl`` (``test_pass/...``), the
last pass's as ``test/...``.

Where it differs from the JAX CLI:

* ``--checkpoint-path`` names a directory of the port's
  ``train/checkpoint.py::CheckpointManager`` (``weights.npz`` +
  ``optimizer.pt``), not an orbax checkpoint;
* ``--image-ext`` (default ``.jpeg``, as ``DataConfig``) picks the image
  files: the port reads PNG and JPEG with its own codecs on every machine
  (a JPEG decoded on ``--device``), and other formats only where cv2 or PIL
  is installed;
* ``--device`` (default ``cuda``) raises without a card unless it is given
  ``cpu``. As in the JAX CLI, ``--batch-size`` is per rank and every
  visible card takes part (``--nproc`` and torchrun as in ``cli.train``): each rank reads and evaluates its block of every
  global batch, with BN statistics and loss normalisers of the global
  batch, and rank 0 gathers the outputs, computes the table, writes the run
  dir's records and prints; ``main`` returns the table on every rank of
  the process (``None`` in a process that spawned the ranks).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..data.dataset import BTXRD, BTXRDLoader, DataConfig, DeviceEvalCache
from ..losses import LossConfig
from ..models import ModelConfig
from ..parallel import create_mesh, dist, replicate, shard_batch
from ..train import CheckpointManager, TrainConfig, create_train_state, make_eval_step
from ..train.loop import ExperimentConfig, ValidationMetrics
from .train import add_rank_flags
from ..utils.logging import RunLogger

# flags whose value comes from the TRAINED config when the user does not
# pass them explicitly: (arg name, config section, config key)
_CONFIG_DEFAULTED = (
    ("eval_bn", "model", "eval_bn"),
    ("assigner", "loss", "assigner"),
    ("single_head", "model", "single_head"),
    ("nc_det", "model", "nc_det"),
    ("num_img_classes", "model", "nc_img"),
    ("proto_ch", "model", "proto_ch"),
    ("iou_match_thresh", "loss", "iou_match_thresh"),
    ("max_boxes", "data", "max_boxes"),
)

_PARITY_DEFAULTS = {
    "eval_bn": "reference",
    "assigner": "reference",
    "single_head": False,
    "nc_det": 2,
    "num_img_classes": 2,
    "proto_ch": 32,
    "iou_match_thresh": 0.5,
    "max_boxes": DataConfig.max_boxes,
}


def _load_run_config(checkpoint_path: str):
    """Read the trainer-written config.json sitting next to the checkpoint."""
    p = Path(str(checkpoint_path)).parent / "config.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def resolve_config(args) -> None:
    """Default unset flags from the run's config.json; guard mismatches.

    Explicitly-passed flags that contradict the trained config raise a
    ValueError unless ``--allow-config-mismatch``. The full trained model /
    loss sections are kept on ``args`` so that :func:`evaluate` rebuilds the
    exact architecture the checkpoint was saved from."""
    run_cfg = _load_run_config(args.checkpoint_path)
    args._run_model_cfg = None if run_cfg is None else run_cfg["model"]
    args._run_loss_cfg = None if run_cfg is None else run_cfg["loss"]
    if args.img_size is None:
        args.img_size = 640 if run_cfg is None else run_cfg["model"]["img_size"]
    for arg, section, key in _CONFIG_DEFAULTED:
        given = getattr(args, arg)
        trained = None if run_cfg is None else run_cfg.get(section, {}).get(key)
        if given is None:
            setattr(args, arg, _PARITY_DEFAULTS[arg] if trained is None else trained)
        elif trained is not None and given != trained:
            msg = (f"--{arg.replace('_', '-')}={given!r} contradicts the "
                   f"trained config ({trained!r} in "
                   f"{Path(str(args.checkpoint_path)).parent}/config.json)")
            if not args.allow_config_mismatch:
                raise ValueError(msg + "; pass --allow-config-mismatch to "
                                 "override deliberately")
            print(f"[evaluate] WARNING: {msg} (override forced)")


def _section(saved, cls, overrides):
    """``cls`` from a sidecar section (lists back to tuples) with
    ``overrides`` on top, or from ``overrides`` alone."""
    base = {} if saved is None else {k: tuple(v) if isinstance(v, list) else v
                                     for k, v in saved.items()}
    return cls(**{**base, **overrides})


def evaluate(args) -> dict | None:
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dist.run_ranks(evaluate_rank, (args,), args.device, args.nproc, args.run_dir)


def evaluate_rank(args, device: torch.device) -> dict:
    """The evaluation on this rank (``device`` its own)."""
    resolve_config(args)
    model_cfg = _section(args._run_model_cfg, ModelConfig, dict(
        nc_det=args.nc_det, nc_img=args.num_img_classes, img_size=args.img_size,
        single_head=args.single_head, proto_ch=args.proto_ch, dtype=args.dtype,
        eval_bn=args.eval_bn))
    loss_cfg = _section(args._run_loss_cfg, LossConfig, dict(
        img_size=args.img_size, nc_det=args.nc_det, assigner=args.assigner,
        iou_match_thresh=args.iou_match_thresh))
    data_cfg = DataConfig(root=args.root, img_size=args.img_size, batch_size=args.batch_size,
                          max_boxes=args.max_boxes, image_ext=args.image_ext)
    train_cfg = TrainConfig(eval_top_k=max(args.map_thresholds))

    mesh = create_mesh(device=device)
    # batch_size is per rank (trainer semantics); each rank's loader reads
    # its block of every global batch
    global_batch = args.batch_size * mesh.shape["data"]
    shard = (mesh.data_index, mesh.shape["data"])
    main_rank = dist.is_main()
    say = print if main_rank else (lambda *a, **k: None)

    state = create_train_state(model_cfg, train_cfg, device=device)
    ckpt = CheckpointManager(str(Path(args.checkpoint_path).parent))
    state = ckpt.restore(state, args.checkpoint_path)
    replicate([*state.model.parameters(), *state.model.buffers()], mesh)
    say(f"[evaluate] restored step {state.step} from {args.checkpoint_path} on {device}; "
        f"{mesh.shape['data']} rank(s)")

    eval_step = make_eval_step(model_cfg, loss_cfg, train_cfg)
    ds = BTXRD(data_cfg, args.split, device=device)
    say(f"[evaluate] {len(ds)} items in split '{args.split}'")

    exp = ExperimentConfig(model=model_cfg, data=data_cfg, loss=loss_cfg, train=train_cfg,
                           run_dir=args.run_dir)
    logger = RunLogger(args.run_dir, args.wandb_project, enabled=main_rank)
    cache = DeviceEvalCache(lambda: BTXRDLoader(ds, global_batch, pad_last=True, shard=shard),
                            lambda b: shard_batch(b, mesh, local=True))
    out = {}
    try:
        for pass_i in range(args.epochs):
            t0 = time.perf_counter()
            vm = ValidationMetrics(exp, class_metrics=args.class_metrics,
                                   max_det_thresholds=sorted(args.map_thresholds))
            first = True
            for batch, dev_batch in cache:
                metrics, aux = eval_step(state, dev_batch)
                vm.update(metrics, aux, batch)
                if first and args.log_examples and pass_i == 0 and main_rank:
                    host = {k: aux[k].float().cpu().numpy() for k in
                            ("seg_prob", "nms_boxes", "nms_scores", "nms_labels", "nms_valid")}
                    imgs = batch["image"].astype("float32") / 255.0
                    logger.log_seg_examples(imgs, host["seg_prob"], batch["mask"], "test", 0)
                    logger.log_det_examples(imgs, host["nms_boxes"], host["nms_scores"],
                                            host["nms_labels"], host["nms_valid"] > 0,
                                            batch["boxes"], batch["box_valid"], "test", 0)
                first = False
            out = vm.compute(full_map=True)
            secs = time.perf_counter() - t0
            logger.log({**out, "pass": pass_i, "seconds": secs, "images": len(ds)}, state.step,
                       prefix="test_pass")
            say(f"[evaluate] pass {pass_i + 1}: {len(ds)} images in {secs:.3f} s")
        logger.log(out, state.step, prefix="test")
    finally:
        logger.close()
    say(json.dumps({k: round(v, 5) for k, v in sorted(out.items())}, indent=2))
    return out


def make_parser():
    ap = argparse.ArgumentParser(description="Evaluate a checkpoint (PyTorch port)")
    ap.add_argument("--checkpoint-path", required=True,
                    help="a step_XXXXXXXX directory of the port's CheckpointManager")
    ap.add_argument("--root", default="btxrd_ready")
    ap.add_argument("--split", default="val", choices=["train", "val", "test", "all"])
    ap.add_argument("--run-dir", default="runs/eval")
    ap.add_argument("--img-size", type=int, default=None,
                    help="defaults from the run's config.json, else 640")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-boxes", type=int, default=None,
                    help="defaults from the run's config.json, else 32")
    ap.add_argument("--image-ext", default=DataConfig.image_ext,
                    help="image file suffix under images/ (.png and .jpeg are read on every "
                    "machine)")
    ap.add_argument("--nc-det", type=int, default=None)
    ap.add_argument("--num-img-classes", type=int, default=None)
    ap.add_argument("--proto-ch", type=int, default=None)
    ap.add_argument("--single-head", action="store_true", default=None)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--eval-bn", default=None, choices=["reference", "frozen"],
                    help="BN eval behaviour; defaults from the run's "
                    "config.json, else 'reference'")
    ap.add_argument("--assigner", default=None, choices=["reference", "tal"],
                    help="loss assigner (affects reported val loss only); "
                    "defaults from the run's config.json")
    ap.add_argument("--iou-match-thresh", type=float, default=None)
    ap.add_argument("--allow-config-mismatch", action="store_true",
                    help="permit explicit flags that contradict the "
                    "checkpoint's trained config.json")
    ap.add_argument("--epochs", type=int, default=1,
                    help="passes over the split; passes after the first replay the "
                    "batches kept on the device")
    ap.add_argument("--map-thresholds", type=int, nargs="+", default=[1, 10, 100],
                    help="mAP max-detection thresholds")
    ap.add_argument("--log-examples", action="store_true", dest="log_examples")
    ap.add_argument("--class-metrics", action="store_true",
                    help="report per-class AP (reference evaluate_model.py behaviour)")
    ap.add_argument("--wandb-project", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' to run without a card)")
    add_rank_flags(ap)
    return ap


def main(argv=None):
    return evaluate(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
