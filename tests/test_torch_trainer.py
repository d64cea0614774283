"""The port's training entry point (``train/loop.py::Trainer``,
``cli/train.py``) on the CPU, torch only: the assertions of the JAX
package's tests/test_train_fast.py on the port, on ``device="cpu"``.

Its tiny config: 64 px, ConvNeXt depths 1/1/1/1 at dims 16/24/32/48, one
BiFPN layer, ``single_head``, 16 synthetic PNGs (12 train, 4 val), the
whole batch 8 (the JAX file's 1 per device on its 8 CPU devices). The
BiFPN is 64 wide with 8 Proto channels, as the port's oracle config
(tests/test_torch_model.py), where the JAX file keeps 256 and 32: the
optimizer's step over the 15 M parameters of the wide heads costs ~0.7 s on
one CPU thread, and no assertion here depends on the heads' width. The
tests of the loop's logic alone (early stop and save cadence, the
emergency checkpoint) replace the step with one that only counts; the
two-epoch run is made once and shared.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.cli import train as cli_train
from multitask_bonetumor_yolo_tpu_torch.data import DataConfig, make_synthetic_btxrd
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig
from multitask_bonetumor_yolo_tpu_torch.train import CheckpointManager, TrainConfig, create_train_state
from multitask_bonetumor_yolo_tpu_torch.train.loop import ExperimentConfig, Trainer
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

IMG = 64
TINY_MODEL = dict(img_size=IMG, single_head=True, nc_det=2, nc_img=2,
                  backbone_depths=(1, 1, 1, 1), backbone_dims=(16, 24, 32, 48),
                  bifpn_num_layers=1, bifpn_feature_size=64, proto_ch=8)
TINY_FLAGS = ["--img-size", str(IMG), "--batch-size", "8", "--single-head", "--dtype", "float32",
              "--backbone-depths", "1,1,1,1", "--backbone-dims", "16,24,32,48",
              "--bifpn-layers", "1", "--bifpn-feature-size", "64", "--proto-ch", "8",
              "--iou-match-thresh", "0.15", "--map-max-detections", "10", "--image-ext", ".png"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return make_synthetic_btxrd(str(tmp_path_factory.mktemp("btxrd_fast")), n=16, seed=11,
                                min_size=96, max_size=160)


@pytest.fixture(scope="module")
def cfg(synth_root):
    return ExperimentConfig(
        model=ModelConfig(**TINY_MODEL),
        data=DataConfig(root=str(synth_root), img_size=IMG, max_boxes=8, batch_size=8,
                        image_ext=".png"),
        loss=LossConfig(img_size=IMG, nc_det=2, iou_match_thresh=0.15),
        train=TrainConfig(lr=3e-4, max_epochs=3, early_stop_patience=100, seed=0,
                          eval_top_k=10, save_last_every=1),
        run_dir="",  # set per test
    )


def records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]


def stub_step(state, batch, gen):
    """A train step that only counts (for the tests of the loop's logic)."""
    state.step += 1
    aux = {"image": batch["image"].float() / 255.0,
           "seg_prob": torch.zeros(batch["mask"].shape),
           "cls_logits": torch.zeros(batch["image"].shape[0], 2)}
    return state, {"loss_total": torch.tensor(1.0)}, aux


@pytest.fixture(scope="module")
def fitted(cfg, tmp_path_factory):
    """A run of two epochs with the train step logged at every step, shared
    by the tests that read it (each copies the run before changing it)."""
    run = tmp_path_factory.mktemp("fitted") / "run"
    trainer = Trainer(dataclasses.replace(cfg, run_dir=str(run), log_every=1), device="cpu")
    return trainer, trainer.fit(max_epochs=2), run


def test_trainer_fit_validate_checkpoint(fitted):
    """Two epochs: the step count, the train-step log (every key, ``lr`` the
    schedule's, finite), the val metrics, each epoch's phase split, the
    ``config.json`` sidecar, and the last checkpoint, whose restore equals
    the live state."""
    trainer, state, run = fitted
    cfg = trainer.cfg
    assert trainer.train_cfg.steps_per_epoch == 1 and len(trainer.val_ds) == 4
    assert state.step == 2 * trainer.train_cfg.steps_per_epoch
    recs = records(run)
    steps = [r for r in recs if "train_step/loss_total" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["train_step/loss_total"]) for r in steps)
    assert {"train_step/lr", "train_step/grad_norm", "train_step/img_accuracy"} <= set(steps[0])
    assert steps[1]["train_step/lr"] < steps[0]["train_step/lr"]
    vals = [r for r in recs if "val_epoch/map_iou50_map" in r]
    assert len(vals) == 2 and {"val_epoch/seg_dice", "val_epoch/img_accuracy"} <= set(vals[0])
    assert "val_epoch/map_iou50_95_map" in vals[0] and "val_epoch/map_iou50_95_map" not in vals[1]
    epochs = [r for r in recs if "train_epoch/epoch" in r]
    assert {"train_epoch/phase_data_s", "train_epoch/phase_train_step_s",
            "train_epoch/phase_validate_s", "train_epoch/phase_checkpoint_s",
            "train_epoch/phase_viz_s"} <= set(epochs[0])
    sidecar = json.loads((run / "checkpoints" / "config.json").read_text())
    assert sidecar["model"] == json.loads(json.dumps(dataclasses.asdict(cfg.model)))
    assert sidecar["data"] == {"img_size": IMG, "max_boxes": 8, "upload_streams": 4}
    assert sorted((run / "media").glob("seg_train_*")) and sorted((run / "media").glob("det_val_*"))

    assert trainer.ckpt.last_path() is not None
    fresh = create_train_state(cfg.model, trainer.train_cfg, device="cpu")
    restored = trainer.ckpt.restore(fresh)
    assert restored.step == state.step
    want = dict(state.model.state_dict())
    for k, v in restored.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    assert torch.equal(restored.mu, state.mu) and torch.equal(restored.count, state.count)


def test_trainer_resume_auto(cfg, fitted, tmp_path):
    """``resume="auto"`` with no checkpoint starts fresh; on a copy of the
    two-epoch run it restores the saved step, moments and weights and
    trains epoch 2 only, ending at 3 epochs' steps."""
    assert Trainer(dataclasses.replace(cfg, run_dir=str(tmp_path / "fresh")), resume="auto",
                   device="cpu").state.step == 0
    t1, state1, run = fitted
    shutil.copytree(run, tmp_path / "run")
    t2 = Trainer(dataclasses.replace(t1.cfg, run_dir=str(tmp_path / "run")), resume="auto",
                 device="cpu")
    assert t2.state.step == state1.step == 2
    assert torch.equal(t2.state.count, state1.count) and torch.equal(t2.state.nu, state1.nu)
    assert torch.equal(t2.state.model.backbone.trunk.stage0_block0.w1,
                       state1.model.backbone.trunk.stage0_block0.w1)
    t2.fit(max_epochs=3)
    assert t2.state.step == 3 * t2.train_cfg.steps_per_epoch
    epochs = [r["train_epoch/epoch"] for r in records(tmp_path / "run") if "train_epoch/epoch" in r]
    assert epochs == [0, 1, 2]


def test_early_stop_and_checkpoint_cadence(cfg, tmp_path, monkeypatch):
    """Scripted val mAP50 drives the loop (the step only counts): the
    epochs that enter the top 2 save, the others do not (``save_last_every``
    1000); patience 2 after the best epoch (1) stops after epoch 3."""
    cfg = dataclasses.replace(cfg, run_dir=str(tmp_path / "run"),
                              train=dataclasses.replace(cfg.train, early_stop_patience=2,
                                                        save_last_every=1000))
    trainer = Trainer(cfg, device="cpu")
    script = iter([0.1, 0.5, 0.4, 0.3, 0.2, 0.1, 0.1, 0.1])
    seen, saved = [], []

    def fake_validate(epoch, global_step):
        seen.append(next(script))
        return {"map_iou50_map": seen[-1]}

    save = trainer.ckpt.save
    monkeypatch.setattr(trainer, "train_step", stub_step)
    monkeypatch.setattr(trainer, "validate", fake_validate)
    monkeypatch.setattr(trainer.ckpt, "save", lambda state, step, metric=None, epoch=None: (
        saved.append((step, metric, epoch)), save(state, step, metric, epoch))[1])
    trainer.fit(max_epochs=100)
    assert seen == [0.1, 0.5, 0.4, 0.3]
    # epoch 0 saves (epoch % 1000 == 0), 1 and 2 enter the top 2, 3 does not
    assert saved == [(1, 0.1, 0), (2, 0.5, 1), (3, 0.4, 2)]
    assert trainer.ckpt.best_path().name == "step_00000002"


def test_emergency_checkpoint_on_failure(cfg, tmp_path, monkeypatch):
    """A failure in the second step (the first only counts) writes the live
    state (step 1) as a checkpoint without a metric and is re-raised; a
    ``KeyboardInterrupt`` then passes through without writing one."""
    run = tmp_path / "run"
    trainer = Trainer(dataclasses.replace(cfg, run_dir=str(run)), device="cpu")
    trainer.state.mu.normal_()  # a state that a fresh one is not
    exc = RuntimeError("injected")

    def failing(state, batch, gen):
        if state.step >= 1:
            raise exc
        return stub_step(state, batch, gen)

    saves = []
    save = trainer.ckpt.save
    monkeypatch.setattr(trainer, "validate", lambda epoch, gs: {"map_iou50_map": -1.0})
    monkeypatch.setattr(trainer, "train_step", failing)
    monkeypatch.setattr(trainer.ckpt, "save", lambda state, step, metric=None, epoch=None: (
        saves.append((step, metric)), save(state, step, metric, epoch))[1])
    with pytest.raises(RuntimeError, match="injected"):
        trainer.fit(max_epochs=3)
    assert saves == [(1, -1.0), (1, None)]  # epoch 0's save, then the emergency one
    index = CheckpointManager(str(run / "checkpoints"))._index
    assert sorted(index) == ["step_00000001"] and index["step_00000001"]["metric"] is None
    restored = CheckpointManager(str(run / "checkpoints")).restore(
        create_train_state(cfg.model, trainer.train_cfg, device="cpu"))
    assert restored.step == 1 and torch.equal(restored.mu, trainer.state.mu)
    exc = KeyboardInterrupt()
    with pytest.raises(KeyboardInterrupt):
        trainer.fit(max_epochs=3)
    assert len(saves) == 2


def test_eval_bn_frozen_deterministic(cfg, tmp_path):
    """``eval_bn="frozen"``: the trainer's eval step on the same parameters,
    after a train-mode forward on a saturated batch and after one on a
    normal batch (each from the same BN statistics), agrees far more
    closely than under ``"reference"``, whose body statistics track the last
    batch; two validations of one state are equal."""
    from multitask_bonetumor_yolo_tpu_torch.data import BTXRDLoader, to_device

    results = {}
    for mode in ("reference", "frozen"):
        c = dataclasses.replace(cfg, run_dir=str(tmp_path / mode),
                                model=dataclasses.replace(cfg.model, eval_bn=mode))
        trainer = Trainer(c, device="cpu")
        state = trainer.state
        b0 = to_device(next(iter(BTXRDLoader(trainer.train_ds, 8))), "cpu")
        hot = {**b0, "image": torch.full_like(b0["image"], 255)}
        stats = state.bn_snapshot()
        losses = []
        for batch in (hot, b0):
            state.bn_restore(stats)
            with torch.no_grad():
                state.model(batch["image"].float() / 255.0, train=True, mode="train")
            losses.append(float(trainer.eval_step(state, b0)[0]["loss_total"]))
        results[mode] = abs(losses[0] - losses[1])
    np.testing.assert_equal(trainer.validate(1, 0), trainer.validate(1, 0))
    assert results["frozen"] < results["reference"] * 0.2, results


def test_cli_train_warm_start_end_to_end(cfg, synth_root, tmp_path):
    """``cli.train.main --device cpu --convnext-ckpt`` on a timm-layout state
    dict written by ``torch.save``, with the mosaic, HSV and flip on: it
    trains, logs the step (B // 4 labels under mosaic), validates and saves,
    and the saved trunk carries the imported values (one AdamW step of
    drift, not the 1e-6 layer-scale init)."""
    rs = np.random.RandomState(3)
    sd = {}
    dims = TINY_MODEL["backbone_dims"]
    sd["stem.0.weight"] = rs.randn(dims[0], 3, 4, 4).astype(np.float32) * 0.1
    sd["stem.0.bias"] = rs.randn(dims[0]).astype(np.float32) * 0.1
    sd["stem.1.weight"] = rs.rand(dims[0]).astype(np.float32) + 0.5
    sd["stem.1.bias"] = rs.randn(dims[0]).astype(np.float32) * 0.1
    for i, dim in enumerate(dims):
        if i > 0:
            sd[f"stages.{i}.downsample.0.weight"] = rs.rand(dims[i - 1]).astype(np.float32) + 0.5
            sd[f"stages.{i}.downsample.0.bias"] = rs.randn(dims[i - 1]).astype(np.float32) * 0.1
            sd[f"stages.{i}.downsample.1.weight"] = (
                rs.randn(dim, dims[i - 1], 2, 2).astype(np.float32) * 0.1)
            sd[f"stages.{i}.downsample.1.bias"] = rs.randn(dim).astype(np.float32) * 0.1
        p = f"stages.{i}.blocks.0"
        sd[f"{p}.conv_dw.weight"] = rs.randn(dim, 1, 7, 7).astype(np.float32) * 0.1
        sd[f"{p}.conv_dw.bias"] = rs.randn(dim).astype(np.float32) * 0.1
        sd[f"{p}.norm.weight"] = rs.rand(dim).astype(np.float32) + 0.5
        sd[f"{p}.norm.bias"] = rs.randn(dim).astype(np.float32) * 0.1
        sd[f"{p}.mlp.fc1.weight"] = rs.randn(4 * dim, dim).astype(np.float32) * 0.1
        sd[f"{p}.mlp.fc1.bias"] = rs.randn(4 * dim).astype(np.float32) * 0.1
        sd[f"{p}.mlp.fc2.weight"] = rs.randn(dim, 4 * dim).astype(np.float32) * 0.1
        sd[f"{p}.mlp.fc2.bias"] = rs.randn(dim).astype(np.float32) * 0.1
        sd[f"{p}.gamma"] = rs.rand(dim).astype(np.float32)
    cpath = tmp_path / "convnext_tiny.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, cpath)

    run = tmp_path / "run"
    argv = ["--root", str(synth_root), "--run-dir", str(run), "--device", "cpu", *TINY_FLAGS]
    trainer = cli_train.main(argv + ["--epochs", "1", "--convnext-ckpt", str(cpath),
                                     "--mosaic", "1.0", "--hsv-v", "0.4", "--hflip", "0.5",
                                     "--log-every", "1"])
    assert trainer.state.step == 1 and trainer.cfg.augment.mosaic_prob == 1.0
    # the train log under mosaic: the step's 2 labels against its 2 logits
    logged = [r for r in records(run) if "train_step/img_accuracy" in r]
    assert len(logged) == 1 and np.isfinite(logged[0]["train_step/loss_total"])
    cm = CheckpointManager(str(run / "checkpoints"))
    state = cm.restore(create_train_state(cfg.model, trainer.train_cfg, device="cpu"))
    got = state.model.backbone.trunk.stage0_block0.gamma.detach().numpy()
    assert np.abs(got - sd["stages.0.blocks.0.gamma"]).max() < 0.1
    assert got.max() > 1e-3


def test_cli_train_needs_a_card_unless_told_cpu(synth_root, tmp_path, monkeypatch):
    """Without ``--device`` the CLI, and the ``Trainer`` without ``device``,
    run on the card: with none they raise before writing anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_train.main(["--root", str(synth_root), "--run-dir", str(run), *TINY_FLAGS])
    assert not run.exists()
    cfg = cli_train.build_config(cli_train.make_parser().parse_args(
        ["--root", str(synth_root), "--run-dir", str(run), *TINY_FLAGS]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    assert not run.exists()
