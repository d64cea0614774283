"""The port's ``Trainer`` orchestration against the JAX package's, on the CPU.

Both trainers run ``fit`` over the same synthetic PNG split (40 images: 32
train, 8 val; 4 steps per epoch at a whole batch of 8, which on the JAX
side's 8 CPU devices is 1 per device) with their steps and validation
replaced by stubs that return the same scripted numbers: per global step a
loss and class logits that depend on the step only, per epoch a val mAP50
from a fixed list. No model runs on either side (the JAX state is a stub
holding the step; the port's is its real tiny state). The JAX checkpoint
writes are replaced by their index updates (orbax is not needed to decide
what is kept). Compared: the saves (step, metric, epoch) in order and the
index they leave, the epoch where early stopping ends the run, every
logged record's keys, the train-step records' values (``lr`` within 1e-6
relative: optax evaluates the schedule in fp32), and ``config.json``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.data import DataConfig as JaxDataConfig
from multitask_bonetumor_yolo_tpu.losses import LossConfig as JaxLossConfig
from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.train import loop as jax_loop
from multitask_bonetumor_yolo_tpu.train.state import TrainConfig as JaxTrainConfig
from multitask_bonetumor_yolo_tpu_torch.data import DataConfig, make_synthetic_btxrd
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig
from multitask_bonetumor_yolo_tpu_torch.train import loop
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

IMG = 64
MODEL = dict(img_size=IMG, single_head=True, nc_det=2, nc_img=2, backbone_depths=(1, 1, 1, 1),
             backbone_dims=(16, 24, 32, 48), bifpn_num_layers=1, bifpn_feature_size=64,
             proto_ch=8)
LOSS = dict(img_size=IMG, nc_det=2, iou_match_thresh=0.15)
TRAIN = dict(lr=3e-4, max_epochs=20, early_stop_patience=2, seed=0, eval_top_k=10,
             save_last_every=3)
VAL_MAP50 = [0.1, 0.3, 0.2, 0.25, 0.1, 0.1]
BATCH = 8


def scripted(step, img_cls):
    """The stub step's numbers at global step ``step`` (1-based)."""
    metrics = {"loss_total": 1.0 / step, "loss_seg": 0.5 / step, "grad_norm": 2.0 + step,
               "step_skipped": 0.0}
    pred = (np.arange(len(img_cls)) + step) % 2
    logits = np.stack([1.0 - pred, pred], -1).astype(np.float32)
    return metrics, logits


class JaxStubState:
    def __init__(self, step=0):
        self.step = jnp.asarray(step, jnp.int32)


def run_jax(root, run_dir, monkeypatch):
    cfg = jax_loop.ExperimentConfig(
        model=JaxModelConfig(**MODEL),
        data=JaxDataConfig(root=str(root), img_size=IMG, max_boxes=8, batch_size=1,
                           image_ext=".png"),
        loss=JaxLossConfig(**LOSS), train=JaxTrainConfig(**TRAIN), run_dir=str(run_dir),
        log_every=1)

    def step_fn(state, batch, rng):
        step = int(state.step) + 1
        metrics, logits = scripted(step, np.asarray(batch["img_cls"]))
        aux = {"cls_logits": jnp.asarray(logits),
               "image": jnp.zeros(batch["image"].shape, jnp.float32),
               "seg_prob": jnp.zeros(batch["mask"].shape, jnp.float32)}
        return JaxStubState(step), {k: jnp.asarray(v) for k, v in metrics.items()}, aux

    monkeypatch.setattr(jax_loop, "create_train_state", lambda *a, **k: JaxStubState())
    monkeypatch.setattr(jax_loop, "make_train_step", lambda *a, **k: step_fn)
    monkeypatch.setattr(jax_loop, "make_eval_step", lambda *a, **k: None)
    trainer = jax_loop.Trainer(cfg)
    assert trainer.global_batch == BATCH
    return trainer


def run_port(root, run_dir):
    cfg = loop.ExperimentConfig(
        model=ModelConfig(**MODEL),
        data=DataConfig(root=str(root), img_size=IMG, max_boxes=8, batch_size=BATCH,
                        image_ext=".png"),
        loss=LossConfig(**LOSS), train=TrainConfig(**TRAIN), run_dir=str(run_dir), log_every=1)
    trainer = loop.Trainer(cfg, device="cpu")

    def step_fn(state, batch, gen):
        state.step += 1
        metrics, logits = scripted(state.step, batch["img_cls"].numpy())
        aux = {"cls_logits": torch.from_numpy(logits),
               "image": torch.zeros(batch["image"].shape),
               "seg_prob": torch.zeros(batch["mask"].shape)}
        return state, {k: torch.tensor(v) for k, v in metrics.items()}, aux

    trainer.train_step = step_fn
    return trainer


def drive(trainer, save_to_disk):
    """``fit`` with the scripted validation; returns the saves, in order,
    and the index they leave."""
    script, saves = iter(VAL_MAP50), []
    trainer.validate = lambda epoch, global_step: {"map_iou50_map": next(script)}
    ckpt, real_save = trainer.ckpt, trainer.ckpt.save

    def save(state, step, metric=None, epoch=None):
        saves.append((step, metric, epoch))
        if save_to_disk:
            return real_save(state, step, metric=metric, epoch=epoch)
        name = f"step_{step:08d}"
        (ckpt.dir / name).mkdir(exist_ok=True)
        ckpt._index[name] = {"step": step, "metric": metric, "epoch": epoch}
        ckpt._prune()
        ckpt._write_index()
        return ckpt.dir / name

    ckpt.save = save
    trainer.fit()
    return saves, ckpt._index


def records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]


def test_trainer_orchestration_matches_jax(tmp_path, monkeypatch):
    root = make_synthetic_btxrd(str(tmp_path / "data"), n=40, seed=5, min_size=64, max_size=96)
    jt = run_jax(root, tmp_path / "jax", monkeypatch)
    pt = run_port(root, tmp_path / "port")
    assert pt.train_cfg.steps_per_epoch == jt.train_cfg.steps_per_epoch == 4
    assert [it["img"].name for it in pt.train_ds.items] == [it["img"].name
                                                            for it in jt.train_ds.items]
    j_saves, j_index = drive(jt, save_to_disk=False)
    p_saves, p_index = drive(pt, save_to_disk=True)
    assert pt.state.step == int(jt.state.step) == 4 * 4
    assert p_saves == j_saves and p_index == j_index
    assert sorted(p.name for p in pt.ckpt.dir.glob("step_*")) == sorted(j_index)

    jr, pr = records(tmp_path / "jax"), records(tmp_path / "port")
    assert [sorted(r) for r in pr] == [sorted(r) for r in jr]
    for a, b in zip(pr, jr):
        assert a["step"] == b["step"]
        if "train_step/loss_total" in a:
            for k, v in b.items():
                if k == "train_step/lr":
                    np.testing.assert_allclose(a[k], v, rtol=1e-6)
                elif k != "t":
                    assert a[k] == pytest.approx(v, rel=1e-7, abs=1e-12), k
        elif "train_epoch/epoch" in a:
            assert a["train_epoch/epoch"] == b["train_epoch/epoch"]
    epochs = [r["train_epoch/epoch"] for r in pr if "train_epoch/epoch" in r]
    assert epochs == list(range(4))  # best at epoch 1 (0.3), patience 2

    j_cfg = json.loads((tmp_path / "jax" / "checkpoints" / "config.json").read_text())
    p_cfg = json.loads((tmp_path / "port" / "checkpoints" / "config.json").read_text())
    assert p_cfg == j_cfg
