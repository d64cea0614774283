"""``tools/train_seeds.py``: the quality recipe over several training seeds
on one card, on the CPU. Its report on the v1 run's committed records
(``quality/synthetic_v1_tal_frozen/``), then the tool end to end at 64^2
over a small pre-written split: two runs started together, one from this
checkout and one from a checkout named by ``SEED@TREE``. Torch only."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.data.synthetic import make_synthetic_btxrd
from multitask_bonetumor_yolo_tpu_torch.tools import train_seeds
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
Q1 = REPO / "quality" / "synthetic_v1_tal_frozen"


def test_report_reads_the_v1_records(tmp_path):
    """On the v1 run's records: the table of ``cli.evaluate``, the rule
    (TPU bar less 0.03) missed by the image accuracy alone, the best-mAP50
    epoch and the validation accuracy there, the epoch from which it stays
    >= 0.95, the epochs that read 0.50 with their image-class loss."""
    (tmp_path / "eval").mkdir()
    shutil.copy(Q1 / "metrics.jsonl", tmp_path / "metrics.jsonl")
    shutil.copy(Q1 / "eval_metrics.jsonl", tmp_path / "eval" / "metrics.jsonl")
    assert train_seeds.RULE == {"map50": 0.9494, "map50_95": 0.827, "dice": 0.9436,
                                "img_accuracy": 0.9388}
    run = train_seeds.parse_run("123")
    assert run == {"seed": 123, "tree": None, "name": "s123"}
    rep = train_seeds.report(run, tmp_path, SimpleNamespace(batch_size=8))
    assert rep["table"]["map50"] == pytest.approx(0.97513, abs=1e-5)
    assert rep["table"]["img_accuracy"] == 0.796875
    assert rep["meets"] == {"map50": True, "map50_95": True, "dice": True,
                            "img_accuracy": False} and not rep["meets_rule"]
    assert (rep["best_epoch"], rep["epochs"], rep["img_accuracy_at_best"]) == (28, 59, 0.796875)
    assert rep["accuracy_steady_from"] == 35
    assert [e for e, _ in rep["epochs_at_one_class"]] == [0, 1, 2, 3, 4, 5, 6, 7, 10, 12]
    assert max(lo for _, lo in rep["epochs_at_one_class"]) == pytest.approx(13.337, abs=1e-3)
    assert train_seeds.steady_from([{"epoch": 0, "img_accuracy": 1.0},
                                    {"epoch": 1, "img_accuracy": 0.5}]) is None


def test_seeds_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--run 1 --run 2@<this checkout>`` at ``--img-size 64 --epochs 1
    --device cpu``: both ``cli.train`` processes run (one torch thread
    each), each best checkpoint is evaluated, the records are copied under
    ``--records`` by run, and the last line printed is the JSON report.
    Two runs of one name and a card asked for where there is none raise."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = make_synthetic_btxrd(str(tmp_path / "data"), n=12, seed=11, rich=True, min_size=64,
                                max_size=96, image_format="jpeg")
    common = ["--epochs", "1", "--img-size", "64", "--assigner", "tal", "--eval-bn", "frozen",
              "--data-dir", str(data), "--run-root", str(tmp_path / "runs")]
    with pytest.raises(ValueError, match="own seed"):
        train_seeds.main(common + ["--device", "cpu", "--run", "1", "--run", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_seeds.main(common + ["--run", "1"])
    capsys.readouterr()
    result = train_seeds.main(common + ["--device", "cpu", "--run", "1", "--run", f"2@{REPO}",
                                        "--records", str(tmp_path / "rec")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    names = ["s1", f"s2_{REPO.name}"]
    assert result["shared_card"] == 2 and [r["name"] for r in result["runs"]] == names
    for name, rep in zip(names, result["runs"]):
        assert rep["epochs"] == 1 and rep["table"]["img_accuracy"] is not None
        rec = tmp_path / "rec" / f"synthetic_v1_tal_frozen_{name}"
        assert (rec / "metrics.jsonl").read_text() == (
            tmp_path / "runs" / name / "metrics.jsonl").read_text()
        assert '"test/seg_dice"' in (rec / "eval_metrics.jsonl").read_text()
