"""The harness run end to end on the CPU at a tiny shape, through its one
test-only route (``harness.execute`` with a CPU device; ``run.py`` refuses
to run without a card): every cell, the result line's keys, a new
configuration, traffic mix, metric and cell added as files and entries
only, the lower-precision control and the planted faults coming out not
correct.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench import harness
from h100_bench.reference.precision import CONTROL, FP32
from h100_bench.spec import BENCHMARK_JSON, Bench

TINY_MODEL = dict(img_size=64, backbone_depths=[1, 1, 2, 1], backbone_dims=[16, 32, 64, 128],
                  bifpn_feature_size=32)
TINY_TRAFFIC = {"serve": dict(batch=4, ring=3, warmup=1, candidates=20, check_requests=2,
                              check_within=4, check_pixels=64, profile_calls=2),
                "train": dict(batch=4, ring=3, profile_calls=2)}
# Limits for the tiny shape, set between the program's readings on the CPU
# (eager bf16 against the fp32 reference, seeds 1-5) and the control's
# (the reference in fp8, seeds 1-3) or a fault's: the full-size cells' own
# limits are set the same way from runs on the card (PERF.md).
TINY_LIMITS = {
    "serve": {"neck_gap": 0.05, "head_gap": 0.015, "cls_gap": 1e-3, "seg_gap": 1e-3,
              "decode_gap": 1e-4, "nms_mismatch": 0, "mask_gap": 2e-5},
    "train": {"fwd_gap": 0.08, "gnorm_gap": 0.35, "grad_gap": 0.06, "update_gap": 0.3,
              "bn_gap": 0.05},
}
CPU = torch.device("cpu")
SEED = 2**31 + 1  # seeds run past 32 signed bits


def _tiny_bench(root: Path) -> Bench:
    """A copy of the benchmark at the tiny shape under ``root``."""
    data = json.loads(BENCHMARK_JSON.read_text())
    shutil.copytree(BENCHMARK_JSON.parent / data["paths"][0], root / data["paths"][0],
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in data["configs"]:
        path = root / c["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_MODEL}))
    bench_root = root / data["paths"][0]
    for w in data["workloads"]:
        path = bench_root / "traffic" / f"{w['traffic']}.json"
        t = json.loads(path.read_text())
        path.write_text(json.dumps({**t, **TINY_TRAFFIC[t["kind"]]}))
        (bench_root / "limits" / f"{w['name']}.json").write_text(
            json.dumps({"limits": TINY_LIMITS[t["kind"]]}))
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Bench(root / "BENCHMARK.json")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return _tiny_bench(tmp_path_factory.mktemp("bench"))


def _run(bench, cell, trace=False, seed=SEED):
    return harness.execute(bench, cell, seed, 0.3, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", ["v1.serve.b16", "v1.train.b32", "v2.serve.b16",
                                  "v2.train.b32"])
def test_every_cell_runs_and_is_correct(bench, cell):
    r = _run(bench, cell)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in bench.end_to_end(cell)}
    assert "setup_s" in r["metrics"]
    assert set(r["checks"]) == set(bench.limits(cell))
    json.dumps(r)


def test_traced_run_reads_the_layers(bench):
    r = _run(bench, "v1.train.b32", trace=True)
    # the device's metrics need the card's trace; spans and counts do not
    assert {"forward_ms.train", "optimizer_ms.train", "mfu.train"} <= set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "breakdown" in r
    assert all(m["name"].endswith(".train") for m in bench.per_layer("v1.train.b32")
               if m["name"] in r["metrics"])


def test_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    bench = _tiny_bench(tmp_path)
    root = bench.root
    cfg = json.loads((bench.base / "h100_bench/configs/btxrd_v1_640.json").read_text())
    (root / "configs" / "tiny_wide.json").write_text(
        json.dumps({**cfg, "bifpn_feature_size": 48, "name": "tiny_wide"}))
    t = json.loads((root / "traffic" / "serve_b16.json").read_text())
    (root / "traffic" / "serve_b2.json").write_text(json.dumps({**t, "batch": 2}))
    (root / "metrics" / "k1_launches.serve.py").write_text(
        'LAYER = "kernel K1"\nMOVES = "serve_img_per_s"\nUNIT = "launches"\n\n\n'
        'def read(t):\n    return t.counters.get("k1_launches")\n')
    (root / "limits" / "tiny.serve.b2.json").write_text(
        json.dumps({"limits": TINY_LIMITS["serve"]}))
    data = bench.data
    data["configs"].append({"name": "tiny_wide", "source": "https://example.org/tiny",
                            "file": "h100_bench/configs/tiny_wide.json", "reduced": [],
                            "why": "test"})
    data["workloads"].append({"name": "tiny.serve.b2", "config": "tiny_wide",
                              "traffic": "serve_b2", "chips": 1, "why": "test"})
    for m in data["end_to_end"]:
        if "workloads" in m and "v1.serve.b16" in m["workloads"]:
            m["workloads"].append("tiny.serve.b2")
    data["per_layer"].append({"name": "k1_launches.serve", "unit": "launches",
                              "better": "lower", "source": "program_counter",
                              "layer": "kernel K1", "moves": "serve_img_per_s",
                              "workloads": ["tiny.serve.b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    grown = Bench(tmp_path / "BENCHMARK.json")
    r = _run(grown, "tiny.serve.b2", trace=True)
    assert r["metrics"]["k1_launches.serve"]["value"] == 0  # the CPU path runs no kernel
    assert r["attempted"] > 0
    r = _run(grown, "tiny.serve.b2")
    assert r["correct"] and "serve_img_per_s" in r["metrics"]


@pytest.mark.parametrize("cell", ["v1.serve.b16", "v2.train.b32"])
def test_control_is_not_correct(bench, cell):
    """The reference in fp8 (bf16 for NMS and masks) in the program's place
    fails the cell's limits."""
    from h100_bench import compare

    c = bench.cell(cell)
    tr, cfg = bench.traffic(c["traffic"]), bench.config(c["config"])
    drv = bench.driver(tr["kind"])
    if tr["kind"] == "serve":
        nums = drv.control_numbers(cfg, tr, SEED, CPU, CONTROL)
    else:
        state0, ring = drv.prepare(cfg, tr, SEED, CPU)
        ref = drv.reference_record(cfg, tr, state0, ring, FP32)
        nums = compare.train_numbers(drv.reference_record(cfg, tr, state0, ring, CONTROL), ref)
    checks = compare.judge(nums, bench.limits(cell))
    assert not all(v["ok"] for v in checks.values()), checks


def _alter_an_answer(monkeypatch):
    from multitask_bonetumor_yolo_tpu_torch.cli import infer

    nms = infer.postprocess_detections

    def altered(*a, **k):
        r = nms(*a, **k)
        scores = r.scores.clone()
        scores[:, 0] += 1e-3
        return r._replace(scores=scores)

    monkeypatch.setattr(infer, "postprocess_detections", altered)


def _keep_the_state(monkeypatch):
    from multitask_bonetumor_yolo_tpu_torch.train.state import TrainState

    def unchanged(self, grads, bn_before):
        self.bn_restore(bn_before)
        self.step += 1
        norm = torch.linalg.vector_norm(torch.stack([g.float().norm() for g in grads
                                                     if g is not None]))
        return norm, torch.tensor(True)

    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)


def _drop_half_the_batch(monkeypatch):
    from multitask_bonetumor_yolo_tpu_torch.train import steps

    augment = steps.augment_batch

    def half(batch, gen, cfg):
        n = batch["image"].shape[0] // 2
        return augment({k: v[:n] for k, v in batch.items()}, gen, cfg)

    monkeypatch.setattr(steps, "augment_batch", half)


@pytest.mark.parametrize("cell,fault", [("v1.serve.b16", _alter_an_answer),
                                        ("v2.serve.b16", _alter_an_answer),
                                        ("v1.train.b32", _keep_the_state),
                                        ("v1.train.b32", _drop_half_the_batch),
                                        ("v2.train.b32", _keep_the_state),
                                        ("v2.train.b32", _drop_half_the_batch)])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(bench, cell)
    assert not r["correct"], r["checks"]


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "v1.serve.b16",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=BENCHMARK_JSON.parent, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
