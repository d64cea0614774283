"""The port's quality-parity recipe (``tools/train_synthetic.py``) and detection
diagnosis (``tools/diagnose_det.py``) against the JAX repo's scripts of the
same names, which are loaded from their paths and run with their heavy
calls replaced (``cli.train.main``, ``cli.evaluate.main``,
``make_synthetic_btxrd`` and ``CheckpointManager`` for the recipe; the
train state, the checkpoint and the eval step for the diagnosis): no JAX
model is built or compiled. Then the port's recipe end to end on the CPU at
64^2 over a small pre-written split. Both tools run on the card by default
and raise without one unless given ``--device cpu``.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.data.synthetic import make_synthetic_btxrd
from multitask_bonetumor_yolo_tpu_torch.tools import diagnose_det, train_synthetic
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TOP_K = 12  # detections per image in the canned eval outputs


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Record:
    """Stands in for ``cli.train.main``, ``cli.evaluate.main``,
    ``make_synthetic_btxrd`` and ``CheckpointManager``, and records what
    the recipe hands each."""

    def __init__(self):
        self.calls = []

    def patch(self, mp, train_mod, eval_mod, synth_mod, ckpt_mod):
        rec = self

        class Manager:
            def __init__(self, directory, *a, **k):
                rec.calls.append(("ckpt", directory))
                self.dir = Path(directory)

            def best_path(self):
                return self.dir / "step_00000042"

            def last_path(self):
                return self.dir / "step_00000050"

        mp.setattr(train_mod, "main", lambda argv: rec.calls.append(("train", argv)))
        mp.setattr(eval_mod, "main", lambda argv: rec.calls.append(("eval", argv)) or {})
        mp.setattr(synth_mod, "make_synthetic_btxrd",
                   lambda *a, **k: rec.calls.append(("synth", a, k)))
        mp.setattr(ckpt_mod, "CheckpointManager", Manager)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_recipe_arguments_equal_the_jax_scripts(variant, tmp_path, monkeypatch):
    """The port's recipe hands ``cli.train``, ``cli.evaluate``, the data
    generator and the checkpoint manager what the JAX recipe hands its own,
    and only adds ``--device`` (to both CLIs), ``image_format="jpeg"`` (the
    JAX generator writes JPEGs, the port's defaults to PNG) and, last, the
    summary of the run's ``metrics.jsonl``. v1 at the
    default directories (under the temporary directory, ``/tmp`` as the
    JAX script's), v2 at given ones and other flags."""
    import multitask_bonetumor_yolo_tpu.cli.evaluate as jax_eval
    import multitask_bonetumor_yolo_tpu.cli.train as jax_train
    import multitask_bonetumor_yolo_tpu.data.synthetic as jax_synth
    import multitask_bonetumor_yolo_tpu.train.checkpoint as jax_ckpt
    from multitask_bonetumor_yolo_tpu_torch.cli import evaluate, train
    from multitask_bonetumor_yolo_tpu_torch.data import synthetic
    from multitask_bonetumor_yolo_tpu_torch.train import checkpoint

    if variant == "v1":
        monkeypatch.setattr("tempfile.tempdir", "/tmp")
        argv = ["--variant", "v1", "--epochs", "60", "--assigner", "tal", "--eval-bn", "frozen"]
    else:
        argv = ["--variant", "v2", "--epochs", "7", "--n-images", "24", "--img-size", "96",
                "--batch-size", "4", "--lr", "1e-3", "--iou-match-thresh", "0.5",
                "--data-dir", str(tmp_path / "missing"), "--run-dir", str(tmp_path / "run")]
    want, got = Record(), Record()
    want.patch(monkeypatch, jax_train, jax_eval, jax_synth, jax_ckpt)
    monkeypatch.setattr(sys, "argv", ["train_synthetic.py", *argv])
    load_script("train_synthetic").main()
    got.patch(monkeypatch, train, evaluate, synthetic, checkpoint)
    monkeypatch.setattr(train_synthetic, "summarize",
                        lambda path, batch: got.calls.append(("summarize", path, batch)))
    train_synthetic.main(argv + ["--device", "cpu"])
    train_args = next(c[1] for c in got.calls if c[0] == "train")
    run_dir = train_args[train_args.index("--run-dir") + 1]
    assert got.calls.pop() == ("summarize", f"{run_dir}/metrics.jsonl",
                               8 if variant == "v1" else 4)

    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    for g, w in zip(got.calls, want.calls):
        if g[0] in ("train", "eval"):
            assert g[1] == w[1] + ["--device", "cpu"]
        elif g[0] == "synth":
            assert g[1] == w[1] and g[2] == {**w[2], "image_format": "jpeg"}
        else:
            assert g == w
    assert [c[0] for c in want.calls][-3:] == ["train", "ckpt", "eval"]


def canned_aux(boxes, valid, ids, img_size):
    """Eval-step NMS outputs made from the batch's GT: per image, its boxes
    (xyxy pixels) shifted and scaled, some with the other class, and
    background boxes, scored in a seeded order; ``TOP_K`` rows, the rest
    invalid."""
    b = boxes.shape[0]
    out = {"nms_boxes": np.zeros((b, TOP_K, 4), np.float32),
           "nms_scores": np.zeros((b, TOP_K), np.float32),
           "nms_labels": np.full((b, TOP_K), -1, np.int32),
           "nms_valid": np.zeros((b, TOP_K), bool)}
    for i in range(b):
        rng = np.random.RandomState(int(ids[i]))
        g = boxes[i][valid[i]]
        xyxy = np.stack([(g[:, 1] - g[:, 3] / 2), (g[:, 2] - g[:, 4] / 2),
                         (g[:, 1] + g[:, 3] / 2), (g[:, 2] + g[:, 4] / 2)], -1) * img_size
        dets, labels = [], []
        for box, cls in zip(xyxy, g[:, 0]):
            for _ in range(3):
                w, h = box[2] - box[0], box[3] - box[1]
                shift = rng.uniform(-0.3, 0.3, 2) * (w, h)
                dets.append(box + np.r_[shift, shift] * rng.uniform(0.5, 1.5))
                labels.append(int(cls) if rng.rand() < 0.7 else 1 - int(cls))
        while len(dets) < TOP_K - 2:
            c = rng.uniform(0, img_size, 2)
            dets.append(np.r_[c - 4, c + 4])
            labels.append(int(rng.rand() < 0.5))
        n = min(len(dets), TOP_K)
        out["nms_boxes"][i, :n] = np.clip(dets[:n], 0, img_size)
        out["nms_scores"][i, :n] = np.sort(rng.uniform(0.05, 1.0, n))[::-1]
        out["nms_labels"][i, :n] = labels[:n]
        out["nms_valid"][i, :n] = True
    return out


def test_diagnosis_equals_the_jax_scripts(tmp_path, monkeypatch, capsys):
    """On the same 8-image split and the same eval-step outputs (made from
    the batch's GT), the port's diagnosis prints the JAX script's lines and
    mAP50s, character for character."""
    import multitask_bonetumor_yolo_tpu.train as jax_train
    import multitask_bonetumor_yolo_tpu.utils.cache as jax_cache
    from multitask_bonetumor_yolo_tpu_torch import train

    root = make_synthetic_btxrd(str(tmp_path / "data"), n=8, seed=5, rich=True, min_size=64,
                                max_size=96, image_format="jpeg")
    run = tmp_path / "run"
    img = 64

    class State:
        step = 7

    class Manager:
        def __init__(self, directory, *a, **k):
            assert Path(directory) == run / "checkpoints"

        def best_path(self):
            return run / "checkpoints" / "step_00000007"

        def restore(self, state, path):
            assert Path(path) == self.best_path()
            return state

    def jax_eval_step(*a, **k):
        def step(state, batch):
            return None, canned_aux(*(np.asarray(batch[k]) for k in ("boxes", "box_valid", "id")),
                                    img)
        return step

    def port_eval_step(*a, **k):
        def step(state, batch):
            aux = canned_aux(*(batch[k].numpy() for k in ("boxes", "box_valid", "id")), img)
            return None, {k: torch.from_numpy(v) for k, v in aux.items()}
        return step

    argv = ["--run-dir", str(run), "--root", str(root), "--img-size", str(img),
            "--batch-size", "4", "--batches", "2"]
    for mod, eval_step in ((jax_train, jax_eval_step), (train, port_eval_step)):
        monkeypatch.setattr(mod, "create_train_state", lambda *a, **k: State())
        monkeypatch.setattr(mod, "CheckpointManager", Manager)
        monkeypatch.setattr(mod, "make_eval_step", eval_step)
    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["diagnose_det.py", *argv])
    load_script("diagnose_det").main()
    want = capsys.readouterr().out
    maps = diagnose_det.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    # the val split's 2 images and the 2 replicas that pad the batch of 4
    assert got.count("image: ") == 4 and got.count("best_iou=") == 40
    assert 0.0 < maps["agnostic"] <= 1.0 and maps["class_aware"] < maps["agnostic"]


def test_recipe_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``train_synthetic --img-size 64 --epochs 1 --device cpu`` over a
    pre-written 12-image JPEG split: one epoch of ``cli.train`` at full
    width, then ``cli.evaluate`` on the best checkpoint over the val split,
    its table finite. Without a card and without ``--device cpu`` both
    tools raise before touching anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((train_synthetic.main, []),
                       (diagnose_det.main, ["--run-dir", str(tmp_path), "--root", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
    data = make_synthetic_btxrd(str(tmp_path / "data"), n=12, seed=11, rich=True, min_size=64,
                                max_size=96, image_format="jpeg")
    run = tmp_path / "run"
    table = train_synthetic.main(["--epochs", "1", "--img-size", "64", "--data-dir", str(data),
                                  "--run-dir", str(run), "--assigner", "tal", "--eval-bn",
                                  "frozen", "--device", "cpu"])
    for key in ("map_iou50_map", "map_iou50_95_map", "seg_dice", "img_accuracy", "loss_total"):
        assert np.isfinite(table[key]), key
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    assert list(index) == ["step_00000001"]
    records = [json.loads(line) for line in (run / "eval" / "metrics.jsonl").open()]
    assert records[-1]["test/seg_dice"] == pytest.approx(table["seg_dice"])
