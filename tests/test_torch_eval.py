"""The port's evaluation path against the JAX package's, on the CPU.

One JAX model at the oracle config of tests/test_torch_model.py (img 160,
dims 16/32/48/64, depths 1/1/2/1, BiFPN 64, proto 8, fp32, ``pallas="off"``)
with that file's weights, conditioned for evaluation: the Detect head's
class biases are raised by 6, so that NMS at the eval confidence (0.05)
keeps boxes (~20 per image; unconditioned, no anchor scores above 0.05).
Both assigners run: ``"reference"`` at ``iou_match_thresh`` 0.1 (at 0.5
random weights match no anchor) and ``"tal"``, so that the box losses and
the detection confusion matrix see positives. The port takes the same
weights through the bridge.

The module fixture jits the JAX ``train/steps.py::make_eval_step`` once,
for both assigners in one function. Batches come from a synthetic PNG
dataset of ``img_size``-square images through the JAX loader (``pad_last``),
so that both packages see the same pixels. The JAX ``cli.evaluate`` needs
orbax and the 8-device mesh, so its reference here is the JAX eval step and
``ValidationMetrics`` over the JAX loader's batches.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.data import dataset as jax_dataset
from multitask_bonetumor_yolo_tpu.losses import LossConfig as JaxLossConfig
from multitask_bonetumor_yolo_tpu.models import ModelConfig as JaxModelConfig
from multitask_bonetumor_yolo_tpu.train import checkpoint as jax_checkpoint
from multitask_bonetumor_yolo_tpu.train import loop as jax_loop
from multitask_bonetumor_yolo_tpu.train.state import TrainConfig as JaxTrainConfig
from multitask_bonetumor_yolo_tpu.train.state import create_train_state as jax_create_state
from multitask_bonetumor_yolo_tpu.train.steps import make_eval_step as jax_make_eval_step
from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch
from multitask_bonetumor_yolo_tpu_torch.cli import evaluate
from multitask_bonetumor_yolo_tpu_torch.data import synthetic
from multitask_bonetumor_yolo_tpu_torch.data.dataset import DataConfig
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, MultitaskModel
from multitask_bonetumor_yolo_tpu_torch.train import (
    CheckpointManager, TrainConfig, create_train_state, make_eval_step,
)
from multitask_bonetumor_yolo_tpu_torch.train import loop
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (autouse)

IMG = 160
B = 4
CFG = dict(
    nc_det=2, nc_img=2, proto_ch=8, bifpn_feature_size=64, bifpn_num_layers=2,
    img_size=IMG, single_head=False, dtype="float32", pallas="off",
    backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 32, 48, 64),
)
LOSSES = {"reference": dict(img_size=IMG, assigner="reference", iou_match_thresh=0.1),
          "tal": dict(img_size=IMG, assigner="tal")}
DATA = dict(img_size=IMG, image_ext=".png", max_boxes=8, batch_size=B)
CLASS_BIAS = 6.0
N_IMAGES = 6  # one full batch and one with two pad_last replicas


def jax_batches(root):
    """The JAX loader's batches over the PNG dataset at ``root``."""
    cfg = jax_dataset.DataConfig(root=str(root), **DATA)
    return list(jax_dataset.BTXRDLoader(jax_dataset.BTXRD(cfg, "all"), B, pad_last=True))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = synthetic.make_synthetic_btxrd(str(tmp_path_factory.mktemp("data")), n=N_IMAGES,
                                          seed=1, min_size=IMG, max_size=IMG, rich=True)
    variables = jax_variables(CFG)
    params = jax.tree.map(np.array, variables["params"])
    for i in range(3):
        params["detect"]["towers"][f"cv3_{i}_2"]["bias"] += CLASS_BIAS
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    jcfg = JaxModelConfig(**CFG)
    state = jax_create_state(jcfg, JaxTrainConfig(), params=params, batch_stats=stats)
    steps = {k: jax_make_eval_step(jcfg, JaxLossConfig(**v), JaxTrainConfig())
             for k, v in LOSSES.items()}
    both = jax.jit(lambda st, b: {k: step(st, b) for k, step in steps.items()})
    batches = jax_batches(root)
    with jax.default_matmul_precision("highest"):
        outs = [jax.tree.map(np.asarray, both(state, {k: jnp.asarray(v) for k, v in b.items()}))
                for b in batches]
    return dict(root=root, params=params, stats=stats, batches=batches, outs=outs)


def port_state(run):
    model = MultitaskModel(ModelConfig(**CFG))
    model.load_state_dict(flax_to_torch(run["params"], run["stats"]), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    return create_train_state(model.cfg, TrainConfig(), model=model)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def as_numpy(out):
    metrics, aux = out
    return ({k: v.numpy() for k, v in metrics.items()}, {k: v.numpy() for k, v in aux.items()})


@pytest.mark.parametrize("assigner", ["reference", "tal"])
def test_eval_step_matches_jax(run, assigner):
    """``make_eval_step`` on the padded batch against the JAX step: losses
    within 1e-4 relative; ``cm_counts`` exact (and not all zero); the seg
    mask equal except where the JAX probability is within 1e-5 of 0.5, and
    ``seg_counts`` off by at most those pixels; the same valid NMS slots,
    boxes within 1e-3 px and scores within 1e-5; the BN running statistics
    bit for bit as they were."""
    state = port_state(run)
    bn = [t.clone() for t in state.bn_stats()]
    step = make_eval_step(state.model.cfg, LossConfig(**LOSSES[assigner]), TrainConfig())
    batch = run["batches"][-1]
    assert batch["sample_valid"].tolist() == [True, True, False, False]
    metrics, aux = as_numpy(step(state, to_torch(batch)))
    want_m, want = run["outs"][-1][assigner]
    assert all(torch.equal(a, b) for a, b in zip(state.bn_stats(), bn))

    assert sorted(metrics) == sorted(want_m) and sorted(aux) == sorted(want)
    for k, v in want_m.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert want_m["loss_box_iou"] > 0
    np.testing.assert_array_equal(aux["cm_counts"], want["cm_counts"])
    assert want["cm_counts"].sum() > 0
    near = np.abs(want["seg_prob"][..., 0] - 0.5) <= 1e-5
    assert np.array_equal(aux["seg_mask"] & ~near, want["seg_mask"] & ~near)
    assert np.abs(aux["seg_counts"] - want["seg_counts"]).sum(1).max() <= 2 * near.sum()
    np.testing.assert_allclose(aux["seg_score"], want["seg_score"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux["cls_logits"], want["cls_logits"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(aux["nms_valid"], want["nms_valid"])
    v = want["nms_valid"]
    assert v.sum(1).min() > 0
    np.testing.assert_array_equal(aux["nms_labels"][v], want["nms_labels"][v])
    np.testing.assert_allclose(aux["nms_boxes"][v], want["nms_boxes"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(aux["nms_scores"][v], want["nms_scores"][v], rtol=0, atol=1e-5)


def gt_near_predictions(batch, aux, seed):
    """``batch`` with its GT replaced by up to 3 of each image's NMS boxes,
    moved by a few pixels, so that the detection mAP has matches at every IoU
    threshold (random weights predict no box near the real GT)."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros_like(batch["boxes"])
    valid = np.zeros_like(batch["box_valid"])
    for i in range(boxes.shape[0]):
        keep = np.nonzero(aux["nms_valid"][i])[0][:3]
        xyxy = aux["nms_boxes"][i, keep] + rs.uniform(-4, 4, (len(keep), 4))
        cxcywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2, xyxy[:, 2:] - xyxy[:, :2]], 1)
        boxes[i, :len(keep)] = np.concatenate(
            [aux["nms_labels"][i, keep, None], cxcywh.clip(1, None) / IMG], 1)
        valid[i, :len(keep)] = True
    return {**batch, "boxes": boxes, "box_valid": valid}


def test_validation_metrics_match_jax(run):
    """``ValidationMetrics.compute(full_map=True)``, with per-class keys and
    max-dets 1 / 10 / 100, fed the JAX step's outputs for every batch (the
    last padded), equals the JAX ``ValidationMetrics``' to 1e-9. The GT boxes
    lie near the predictions (:func:`gt_near_predictions`), so that every
    mAP key sees matches."""
    model, data = ModelConfig(**CFG), DataConfig(**DATA)
    exp = loop.ExperimentConfig(model=model, data=data, loss=LossConfig(**LOSSES["tal"]))
    jexp = jax_loop.ExperimentConfig(
        model=JaxModelConfig(**CFG), data=jax_dataset.DataConfig(**DATA),
        loss=JaxLossConfig(**LOSSES["tal"]))
    ours = loop.ValidationMetrics(exp, class_metrics=True)
    theirs = jax_loop.ValidationMetrics(jexp, class_metrics=True)
    for i, (batch, out) in enumerate(zip(run["batches"], run["outs"])):
        metrics, aux = out["tal"]
        batch = gt_near_predictions(batch, aux, i)
        ours.update({k: torch.from_numpy(np.array(v)) for k, v in metrics.items()},
                    {k: torch.from_numpy(np.array(v)) for k, v in aux.items()}, batch)
        theirs.update({k: jnp.asarray(v) for k, v in metrics.items()},
                      {k: jnp.asarray(v) for k, v in aux.items()}, batch)
    got, want = ours.compute(full_map=True), theirs.compute(full_map=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-9, err_msg=k)
    assert 0 < want["map_iou50_95_map"] < want["map_iou50_map"] and want["img_accuracy"] > 0
    assert want["map_iou50_class_detC0"] > 0


def write_run(run, path, state, assigner="tal"):
    """A port checkpoint of ``state`` at step 1 under ``path`` with the
    trainer's ``config.json`` sidecar (model, loss and data sections)."""
    ckpt = CheckpointManager(str(path))
    step_dir = ckpt.save(state, 1)
    (path / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(ModelConfig(**CFG)),
        "loss": dataclasses.asdict(LossConfig(**LOSSES[assigner])),
        "data": {"img_size": IMG, "max_boxes": DATA["max_boxes"], "upload_streams": 4},
    }, default=list))
    return step_dir


def test_cli_evaluate_matches_jax(run, tmp_path, capsys):
    """``cli.evaluate.main`` on the CPU over the PNG dataset (two passes, the
    second from the device cache) against the JAX eval step + JAX
    ``ValidationMetrics`` over the JAX loader's batches: the same keys, every
    value within 1e-4; its JSON printed as the JAX CLI prints it. A flag that
    contradicts the sidecar raises."""
    step_dir = write_run(run, tmp_path / "ckpt", port_state(run))
    argv = ["--checkpoint-path", str(step_dir), "--root", str(run["root"]), "--split", "all",
            "--batch-size", str(B), "--image-ext", ".png", "--dtype", "float32",
            "--device", "cpu", "--run-dir", str(tmp_path / "eval"), "--epochs", "2"]
    got = evaluate.main(argv)
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == {k: round(v, 5) for k, v in got.items()}

    jexp = jax_loop.ExperimentConfig(
        model=JaxModelConfig(**CFG), data=jax_dataset.DataConfig(**DATA),
        loss=JaxLossConfig(**LOSSES["tal"]))
    vm = jax_loop.ValidationMetrics(jexp, max_det_thresholds=[1, 10, 100])
    for batch, out in zip(run["batches"], run["outs"]):
        metrics, aux = out["tal"]
        vm.update({k: jnp.asarray(v) for k, v in metrics.items()},
                  {k: jnp.asarray(v) for k, v in aux.items()}, batch)
    want = vm.compute(full_map=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
    assert want["map_iou50_map"] >= 0 and want["loss_box_iou"] > 0
    records = [json.loads(line) for line in (tmp_path / "eval" / "metrics.jsonl").open()]
    assert [r["test_pass/pass"] for r in records[:2]] == [0, 1]

    with pytest.raises(ValueError, match="contradicts the trained config"):
        evaluate.main(argv + ["--assigner", "reference"])


def test_checkpoint_round_trip_and_pruning(run, tmp_path):
    """``CheckpointManager``: a save / restore round trip is bit for bit
    (weights, BN statistics, moments, count, step) into a fresh state; over
    a sequence of saves it keeps the names, best and last that the JAX
    manager's index rules keep (its ``_prune`` driven on the same index)."""
    state = port_state(run)
    gen = torch.Generator().manual_seed(0)
    state.mu = torch.randn(state.mu.shape, generator=gen)
    state.nu = torch.rand(state.nu.shape, generator=gen)
    state.count = torch.tensor(7)
    state.step = 9
    ours = CheckpointManager(str(tmp_path / "ours"), top_k=2)
    theirs = jax_checkpoint.CheckpointManager(str(tmp_path / "theirs"), top_k=2)
    for step, metric in ((1, 0.3), (2, None), (3, 0.5), (4, 0.1), (5, 0.4), (6, None), (7, 0.2)):
        assert ours.qualifies(metric) == theirs.qualifies(metric), step
        ours.save(state, step, metric=metric, epoch=step)
        name = f"step_{step:08d}"
        (theirs.dir / name).mkdir()
        theirs._index[name] = {"step": step, "metric": metric, "epoch": step}
        theirs._prune()
        assert ours._index == theirs._index, step
        assert sorted(p.name for p in ours.dir.glob("step_*")) == sorted(theirs._index)
        assert ours.best_path().name == theirs.best_path().name
        assert ours.last_path().name == theirs.last_path().name
    assert json.loads((ours.dir / "index.json").read_text()) == ours._index

    fresh = create_train_state(ModelConfig(**CFG), TrainConfig(), device="cpu")
    restored = CheckpointManager(str(tmp_path / "ours")).restore(fresh)
    want_sd, got_sd = state.model.state_dict(), restored.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    for k in ("mu", "nu", "count"):
        assert torch.equal(getattr(restored, k), getattr(state, k)), k
    assert restored.step == 9
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)
