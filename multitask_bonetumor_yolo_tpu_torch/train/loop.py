"""Training orchestration (counterpart of the JAX ``train/loop.py``):
``ExperimentConfig``, the mAP input builders, ``ValidationMetrics`` and the
``Trainer``: epochs, per-epoch validation, top-K and 'last' checkpoints,
``--resume``, the emergency checkpoint, early stopping on val mAP50.

``ValidationMetrics`` keeps each batch's small aux (losses, NMS result,
segmentation counts and scores, class logits, confusion-matrix counts) on
the device as the eval step returns it, and moves it all to the host in one
copy when :meth:`ValidationMetrics.compute` runs: one wait for the device per
pass, where reading each batch would wait once per batch.

The ``Trainer`` runs on every rank of the joined group (``parallel/``; one
rank, on the first card, without one; without a card it raises unless given
``device="cpu"``). As in the JAX trainer, ``cfg.data.batch_size`` is per
rank and the global batch is it times the ranks: each rank's loader reads
its block of every global batch, ``shard_batch`` uploads it on the
loader's prefetch thread, and the train step's random draws come from one
``torch.Generator`` on the device seeded with ``train.seed`` on every rank
(like the JAX trainer's key, it is not restored on resume). Rank 0 alone
writes the run's files (``config.json``, ``metrics.jsonl``, overlays,
checkpoints) and decides what to save and when to stop, and tells the other
ranks; ``ValidationMetrics`` gathers the ranks' outputs to it in the global
batch's order.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import BTXRD, BTXRDLoader, DataConfig, DeviceEvalCache, Prefetcher
from ..data.preprocess import AugmentConfig
from ..losses import LossConfig
from ..metrics import BinarySegMetrics, ClassificationMetrics, MeanAveragePrecision
from ..metrics.segmentation import mask_map_inputs_from_counts
from ..models import ModelConfig
from ..parallel import create_mesh, dist, replicate, shard_batch
from ..utils.logging import RunLogger
from ..utils.profiling import PhaseTimer
from .checkpoint import CheckpointManager
from .state import TrainConfig, TrainState, create_train_state, lr_at
from .steps import make_eval_step, make_train_step


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    augment: AugmentConfig = AugmentConfig()
    run_dir: str = "runs/default"
    log_every: int = 10
    viz_every_epochs: int = 50  # mask/box overlay cadence (reference: 50)
    wandb_project: Optional[str] = None

    def __post_init__(self):
        if not self.model.img_size == self.data.img_size == self.loss.img_size:
            raise ValueError("img_size must match across model/data/loss configs")


def gt_to_map_targets(boxes: np.ndarray, valid: np.ndarray, img_size: int):
    """Padded GT -> per-image mAP target dicts (xyxy absolute, clamped —
    running_main_v3.py:560-570)."""
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i].astype(bool)
        b = boxes[i][v]
        xyxy = np.stack(
            [
                (b[:, 1] - b[:, 3] / 2) * img_size,
                (b[:, 2] - b[:, 4] / 2) * img_size,
                (b[:, 1] + b[:, 3] / 2) * img_size,
                (b[:, 2] + b[:, 4] / 2) * img_size,
            ],
            axis=-1,
        ).clip(0, img_size) if len(b) else np.zeros((0, 4), np.float32)
        out.append(dict(boxes=xyxy, labels=b[:, 0].astype(np.int64)))
    return out


def nms_to_map_preds(aux: Dict[str, np.ndarray]):
    """Batched NMS output -> per-image mAP pred dicts."""
    out = []
    boxes = np.asarray(aux["nms_boxes"])
    scores = np.asarray(aux["nms_scores"])
    labels = np.asarray(aux["nms_labels"])
    valid = np.asarray(aux["nms_valid"]).astype(bool)
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append(dict(boxes=boxes[i][v], scores=scores[i][v],
                        labels=labels[i][v].astype(np.int64)))
    return out


def _to_host(pending: list) -> list:
    """The tensors of ``pending`` (a list of dicts of tensors on one device)
    as numpy arrays, in one device-to-host copy: each is flattened into one
    fp64 buffer (exact for the bools, the int32/int64 counts below 2^53 and
    the fp32 values the eval step returns) and cast back on the host."""
    tensors = [t for d in pending for t in d.values()]
    if not tensors:
        return [{} for _ in pending]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for d in pending:
        host = {}
        for k, t in d.items():
            n = t.numel()
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            host[k] = flat[off:off + n].reshape(tuple(t.shape)).astype(dtype)
            off += n
        out.append(host)
    return out


class ValidationMetrics:
    """Bundles every accumulator the reference's validation epoch keeps."""

    # the aux keys the accumulators read; seg_prob and seg_mask stay on the
    # device for the overlays
    SMALL_AUX = ("seg_counts", "seg_score", "cls_logits", "cm_counts", "nms_boxes",
                 "nms_scores", "nms_labels", "nms_valid")

    def __init__(self, cfg: ExperimentConfig, class_metrics: bool = False,
                 max_det_thresholds=None):
        """``max_det_thresholds`` mirrors the reference's --map_thresholds
        rebuild of its mAP metrics (evaluate_model.py:81-94); defaults to
        the train-loop [1, 10, eval_top_k]."""
        self.cfg = cfg
        mdt = list(max_det_thresholds or [1, 10, cfg.train.eval_top_k])
        self.seg = BinarySegMetrics()
        self.cls = ClassificationMetrics(cfg.model.nc_img)
        self.det_cm = ClassificationMetrics(cfg.model.nc_det)
        self.map50 = MeanAveragePrecision(iou_thresholds=[0.5], max_detection_thresholds=mdt,
                                          class_metrics=class_metrics)
        self.map50_95 = MeanAveragePrecision(max_detection_thresholds=mdt,
                                             class_metrics=class_metrics)
        self.seg_map = MeanAveragePrecision(iou_type="segm")
        self.losses: Dict[str, list] = {}
        self._pending: list = []  # (device dict, host dict) per batch

    def update(self, metrics, aux, batch) -> None:
        """One eval step's ``metrics`` and ``aux`` (device tensors, kept as
        they are) and its host ``batch`` (numpy: ``img_cls``, ``boxes``,
        ``box_valid``, ``sample_valid``, which trims a ``pad_last`` batch's
        replicas)."""
        sv = np.asarray(batch.get("sample_valid", np.ones(len(batch["img_cls"]), bool))).astype(bool)
        small = {k: aux[k] for k in self.SMALL_AUX}
        small.update({f"m:{k}": v for k, v in metrics.items()})
        host = {"sv": sv, "img_cls": np.asarray(batch["img_cls"]),
                "boxes": np.asarray(batch["boxes"]), "box_valid": np.asarray(batch["box_valid"])}
        self._pending.append((small, host))

    def _drain(self) -> None:
        """Apply the pending batches; on N ranks rank 0 applies every rank's
        rows, gathered in the global batch's order (the others only send)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        batches = [(d, host) for d, (_, host) in
                   zip(_to_host([small for small, _ in pending]), pending)]
        if dist.active():
            every = dist.gather_objects(batches)
            if every is None:
                return
            batches = [_merge_ranks(parts) for parts in zip(*every)]
        for d, host in batches:
            metrics = {k[2:]: v for k, v in d.items() if k.startswith("m:")}
            small = {k: v for k, v in d.items() if not k.startswith("m:")}
            self._apply(metrics, small, host)

    def _apply(self, metrics, aux, host) -> None:
        sv = host["sv"]
        for k, v in metrics.items():
            self.losses.setdefault(k, []).append(float(v))
        counts = aux["seg_counts"][sv]
        self.seg.update_counts(counts)
        self.seg_map.update(*mask_map_inputs_from_counts(counts, aux["seg_score"][sv]))
        self.cls.update(aux["cls_logits"][sv], host["img_cls"][sv])
        self.det_cm.update_cm(aux["cm_counts"])
        preds = [p for p, ok in zip(nms_to_map_preds(aux), sv) if ok]
        targets = [t for t, ok in zip(gt_to_map_targets(host["boxes"], host["box_valid"],
                                                        self.cfg.model.img_size), sv) if ok]
        self.map50.update(preds, targets)
        self.map50_95.update(preds, targets)

    def compute(self, full_map: bool) -> Dict[str, float]:
        """The metric table, on every rank (rank 0's, on N ranks)."""
        self._drain()
        return dist.broadcast_object(self._table(full_map) if dist.is_main() else None)

    def _table(self, full_map: bool) -> Dict[str, float]:
        out = {f"{k}": float(np.mean(v)) for k, v in self.losses.items()}
        out.update({f"seg_{k}": v for k, v in self.seg.compute().items()})
        out.update({f"seg_map_{k}": v for k, v in self.seg_map.compute().items()
                    if isinstance(v, (int, float))})
        out.update({f"img_{k}": v for k, v in self.cls.compute().items()})
        m50 = self.map50.compute()
        out.update({f"map_iou50_{k}": v for k, v in m50.items() if isinstance(v, (int, float))})
        if "map_per_class" in m50:
            for i, ap in enumerate(np.asarray(m50["map_per_class"]).ravel()):
                cls_id = int(np.asarray(m50["classes"]).ravel()[i])
                out[f"map_iou50_class_detC{cls_id}"] = float(ap)
        if full_map:
            m = self.map50_95.compute()
            out.update({f"map_iou50_95_{k}": v for k, v in m.items()
                        if isinstance(v, (int, float))})
        return out


def _merge_ranks(parts) -> tuple:
    """One batch's (outputs, host fields) from every rank, as one batch: the
    per-sample arrays concatenated in rank order; the losses (``m:``) and
    ``cm_counts``, which the eval step summed over the ranks, as they are."""
    outs, hosts = zip(*parts)
    out = {k: v if k.startswith("m:") or k == "cm_counts"
           else np.concatenate([o[k] for o in outs]) for k, v in outs[0].items()}
    return out, {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``tensors`` as numpy arrays, in one device-to-host copy."""
    return _to_host([tensors])[0]


class Trainer:
    def __init__(self, cfg: ExperimentConfig, resume: Optional[str] = None,
                 convnext_ckpt: Optional[str] = None, detect_ckpt: Optional[str] = None,
                 segment_ckpt: Optional[str] = None, device: torch.device | str = "cuda"):
        """``resume``: a checkpoint path, or "auto" for the run dir's last
        checkpoint. ``convnext_ckpt`` / ``detect_ckpt`` / ``segment_ckpt``:
        torch state dicts for the reference's pretrained warm start (timm
        convnext_tiny, YOLOv8 heads; ``utils/import_torch_weights.py``).
        ``device``: the card by default; without one this raises unless
        given ``"cpu"``. On N ranks each passes its own card (the one
        ``parallel.dist.join`` set)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.mesh = create_mesh(device=self.device)
        self.is_main = dist.is_main()
        self.logger = RunLogger(cfg.run_dir, cfg.wandb_project, enabled=self.is_main)
        # DataConfig.batch_size is per rank, as the JAX trainer's is per device
        self.global_batch = cfg.data.batch_size * self.mesh.shape["data"]
        self.shard = (self.mesh.data_index, self.mesh.shape["data"])
        self.train_ds = BTXRD(cfg.data, "train", device=self.device)
        self.val_ds = BTXRD(cfg.data, "val", device=self.device)
        if len(self.train_ds) == 0:
            raise RuntimeError(f"No training data under {cfg.data.root}")
        steps = max(1, len(self.train_ds) // self.global_batch)
        self.train_cfg = dataclasses.replace(cfg.train, steps_per_epoch=steps)
        self.state = create_train_state(cfg.model, self.train_cfg, device=self.device)
        self.train_step = make_train_step(cfg.model, cfg.loss, cfg.augment)
        self.eval_step = make_eval_step(cfg.model, cfg.loss, self.train_cfg)
        self.ckpt = CheckpointManager(f"{cfg.run_dir}/{self.train_cfg.ckpt_dir}",
                                      top_k=self.train_cfg.ckpt_top_k)
        # the model / loss / data config beside the checkpoints, so that
        # cli/evaluate.py defaults its flags from the trained config
        if self.is_main:
            Path(f"{cfg.run_dir}/{self.train_cfg.ckpt_dir}/config.json").write_text(json.dumps({
                "model": dataclasses.asdict(cfg.model),
                "loss": dataclasses.asdict(cfg.loss),
                "data": {"img_size": cfg.data.img_size,
                         "max_boxes": cfg.data.max_boxes,
                         "upload_streams": cfg.data.upload_streams},
            }, indent=2, default=list))
        self.generator = torch.Generator(device=self.device).manual_seed(self.train_cfg.seed)
        self._val_cache: Optional[DeviceEvalCache] = None

        if convnext_ckpt or detect_ckpt or segment_ckpt:
            from ..utils.import_torch_weights import load_pretrained

            load_pretrained(self.state.model, convnext_path=convnext_ckpt,
                            detect_sd_path=detect_ckpt, segment_sd_path=segment_ckpt)
        if resume:
            path = None if resume == "auto" else resume
            if resume == "auto" and self.ckpt.last_path() is None:
                self._say("[trainer] --resume auto: no checkpoint yet, starting fresh")
            else:
                self.state = self.ckpt.restore(self.state, path)
                self._say(f"[trainer] resumed from step {self.state.step}")
        # every rank built or restored the same state; make sure of it
        st = self.state
        replicate([*st.model.parameters(), *st.model.buffers(), st.mu, st.nu, st.count],
                  self.mesh)

    # ------------------------------------------------------------------
    def fit(self, max_epochs: Optional[int] = None) -> TrainState:
        """Run the training loop; on an exception (not a ``KeyboardInterrupt``)
        checkpoint the live state, then re-raise."""
        try:
            return self._fit(max_epochs)
        except KeyboardInterrupt:
            raise
        except Exception:
            step = self.state.step
            if step > 0 and self.is_main:
                self.ckpt.save(self.state, step, metric=None)
                print(f"[trainer] crash — emergency checkpoint at step {step}")
            raise

    def _fit(self, max_epochs: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        epochs = max_epochs or self.train_cfg.max_epochs
        best_metric, best_epoch = -float("inf"), -1
        global_step = self.state.step
        start_epoch = global_step // self.train_cfg.steps_per_epoch

        # the val split streams onto the device while the first epoch trains
        self._ensure_val_cache().prime()

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            timer = PhaseTimer()
            loader = BTXRDLoader(self.train_ds, self.global_batch, shuffle=True,
                                 drop_last=True, seed=self.train_cfg.seed + epoch,
                                 shard=self.shard)
            it = iter(Prefetcher(loader, map_fn=self._upload))
            aux, last_batch = None, None
            while True:
                with timer.phase("data"):
                    batch = next(it, None)
                if batch is None:
                    break
                last_batch = batch
                with timer.phase("train_step"):
                    self.state, metrics, aux = self.train_step(self.state, batch, self.generator)
                global_step += 1
                if global_step % cfg.log_every == 0:
                    # the global batch's logits; under mosaic its labels are
                    # the first B // 4 images' (data/preprocess.py)
                    logits = dist.gather_rows(aux["cls_logits"])
                    labels = dist.gather_rows(batch["img_cls"])[:logits.shape[0]]
                if global_step % cfg.log_every == 0 and self.is_main:
                    host = _host({**{f"m:{k}": v for k, v in metrics.items()},
                                  "cls_logits": logits, "img_cls": labels})  # one host copy
                    logged = {k[2:]: float(v) for k, v in host.items() if k.startswith("m:")}
                    logged["lr"] = lr_at(self.train_cfg, global_step)
                    tc = ClassificationMetrics(cfg.model.nc_img)
                    tc.update(host["cls_logits"], host["img_cls"])
                    logged.update({f"img_{k}": v for k, v in tc.compute().items()})
                    self.logger.log(logged, global_step, prefix="train_step", to_console=True)

            if aux is not None and epoch % cfg.viz_every_epochs == 0 and self.is_main:
                with timer.phase("viz"):  # the overlays draw rank 0's first 4 images
                    host = _host({"image": aux["image"][:4], "seg_prob": aux["seg_prob"][:4],
                                  "mask": last_batch["mask"][:4]})
                    imgs = host["image"].astype(np.float32)
                    if imgs.max() > 1.5:
                        imgs = imgs / 255.0
                    self.logger.log_seg_examples(imgs, host["seg_prob"], host["mask"],
                                                 stage="train", step=global_step)
            with timer.phase("validate"):
                val = self.validate(epoch, global_step)
            map50 = val.get("map_iou50_map", -1.0)
            # save when the metric enters the top-K, on the 'last' cadence,
            # and after the last epoch
            want_save = (self.ckpt.qualifies(map50)
                         or epoch % max(1, self.train_cfg.save_last_every) == 0
                         or epoch == epochs - 1)
            stop = (not map50 > best_metric
                    and epoch - best_epoch >= self.train_cfg.early_stop_patience)
            if map50 > best_metric:
                best_metric, best_epoch = map50, epoch
            # rank 0's index decides; every rank leaves the loop together
            want_save, stop = dist.broadcast_object((want_save, stop))
            with timer.phase("checkpoint"):
                if want_save and self.is_main:
                    self.ckpt.save(self.state, global_step, metric=map50, epoch=epoch)
                dist.barrier()
            self.logger.log({"epoch": epoch, "epoch_time_s": time.time() - t0,
                             **{f"phase_{k}_s": round(v, 4) for k, v in timer.totals.items()}},
                            global_step, prefix="train_epoch")
            if stop:
                self._say(f"[early-stop] no val mAP50 improvement for "
                          f"{self.train_cfg.early_stop_patience} epochs")
                break
        return self.state

    # ------------------------------------------------------------------
    def _say(self, text: str) -> None:
        if self.is_main:  # the other ranks' consoles would repeat it
            print(text)

    def _upload(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's rows (which its loader read) on its device."""
        return shard_batch(batch, self.mesh, local=True)

    def _ensure_val_cache(self) -> DeviceEvalCache:
        # this rank's rows of the val split on the device: read and copied
        # once, replayed after
        if self._val_cache is None:
            self._val_cache = DeviceEvalCache(
                lambda: BTXRDLoader(self.val_ds, self.global_batch, pad_last=True,
                                    shard=self.shard),
                self._upload)
        return self._val_cache

    def validate(self, epoch: int, global_step: int) -> Dict[str, float]:
        cfg = self.cfg
        vm = ValidationMetrics(cfg)
        first = True
        for batch, dev_batch in self._ensure_val_cache():
            metrics, aux = self.eval_step(self.state, dev_batch)
            vm.update(metrics, aux, batch)
            if first and epoch % cfg.viz_every_epochs == 0 and self.is_main:
                self._log_examples(batch, aux, epoch, global_step)
            first = False
        out = vm.compute(full_map=epoch % self.train_cfg.map_full_freq == 0)
        if not self.is_main:
            return out
        self.logger.log(out, global_step, prefix="val_epoch", to_console=True)
        self.logger.log_confusion_matrix(vm.cls.normalized_cm(),
                                         {i: f"imgC{i}" for i in range(cfg.model.nc_img)},
                                         "img_confusion_matrix", global_step)
        if vm.det_cm.cm.sum() > 0:
            self.logger.log_confusion_matrix(vm.det_cm.normalized_cm(),
                                             {i: f"detC{i}" for i in range(cfg.model.nc_det)},
                                             "det_confusion_matrix", global_step)
        return out

    def _log_examples(self, batch, aux, epoch, step) -> None:
        host = _host({k: aux[k] for k in ("seg_prob", "nms_boxes", "nms_scores", "nms_labels",
                                          "nms_valid")})
        imgs = np.asarray(batch["image"]).astype(np.float32) / 255.0
        self.logger.log_seg_examples(imgs, host["seg_prob"], np.asarray(batch["mask"]),
                                     stage="val", step=step)
        self.logger.log_det_examples(imgs, host["nms_boxes"], host["nms_scores"],
                                     host["nms_labels"], host["nms_valid"].astype(bool),
                                     np.asarray(batch["boxes"]), np.asarray(batch["box_valid"]),
                                     stage="val", step=step)
