"""The cell ``v1.base.train.b32`` on the CPU at a tiny shape through the
harness's test-only route, its files and entries, and the reader
``k1_saving_roofline.train`` on a fabricated trace.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json

import pytest

from h100_bench import harness, work
from h100_bench.spec import BENCHMARK_JSON, Bench
from h100_bench.tests.test_h100_bench_rehearsal import _run, _tiny_bench

CELLS = ("v1.base.train.b32",)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark, the Base configuration one block deeper at its
    third stage than Tiny's tiny copy, so the two stay different models."""
    b = _tiny_bench(tmp_path_factory.mktemp("bench"))
    path = b.base / "h100_bench/configs/btxrd_v1_base_640.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "backbone_depths": [1, 1, 3, 1]}))
    return b


@pytest.mark.parametrize("cell", CELLS)
def test_new_cells_run_and_are_correct(bench, cell):
    r = _run(bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in bench.end_to_end(cell)}
    assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_new_cells_trace_their_layers(bench, cell):
    r = _run(bench, cell, trace=True)
    # the device's metrics need the card's trace; spans and counts do not
    assert {"forward_ms.train", "optimizer_ms.train", "mfu.train"} <= set(r["metrics"])
    assert "k1_saving_roofline.train" not in r["metrics"]


def test_entries_and_files():
    b = Bench()
    base, tiny = b.config("btxrd_v1_base_640"), b.config("btxrd_v1_640")
    assert base["backbone_depths"] == [3, 3, 27, 3]
    assert base["backbone_dims"] == [128, 256, 512, 1024]
    assert base["reduced"] == [] and set(base) == set(tiny)
    same = set(tiny) - {"name", "source", "model", "assumed", "backbone_depths",
                        "backbone_dims"}
    assert all(base[k] == tiny[k] for k in same)
    for cell in CELLS:
        assert set(b.limits(cell)) == set(b.limits("v1.train.b32"))
        names = {m["name"] for m in b.per_layer(cell)}
        assert {"forward_ms.train", "idle_share.train", "mfu.train", "optimizer_ms.train",
                "k2_roofline.train"} <= names
    assert "k1_saving_roofline.train" in {m["name"] for m in b.per_layer("v1.base.train.b32")}
    data = json.loads(BENCHMARK_JSON.read_text())
    assert set(CELLS) <= {w["name"] for w in data["workloads"]}


def _trace(kernels, k2_launches, cfg, rows=32, calls=3):
    return harness.TraceData(config=cfg, traffic={}, spans={}, calls=10, rows=rows,
                             window_s=1.0, counters={"k2_launches": k2_launches},
                             kernels=kernels, profile_calls=calls, profile_s=1.0, busy_s=1.0,
                             breakdown={})


def test_k1_saving_roofline_reader():
    """The bound of the launched stages' saving-form launches over the
    device time of K1's kernels, whatever the kernel's template arguments;
    other kernels do not count; nothing without K1 time or when K2's count
    fits no run of leading stages."""
    b = Bench()
    read = b.metric_reader("k1_saving_roofline.train").read
    cfg = b.config("btxrd_v1_base_640")
    kernels = [("cnb::k1h::k1_forward_kernel<512, 32, 64, true, 0, 0>", 0.030),
               ("cnb::k1h::k1_forward_kernel<192, 64, 128, true, 0, 0>", 0.010),
               ("k2h::k2_row_kernel<512, 16, false>", 0.5)]
    stages = work.stages(cfg)[:3]
    assert [s[3] for s in stages] == [3, 3, 27]
    bound = sum(d * work.k1_bound(32, h, w, c, saving=True)[0] for c, h, w, d in stages)
    got = read(_trace(kernels, 33, cfg))
    assert got == pytest.approx(100.0 * bound * 3 / 0.040)
    # stage 2 on the eager route: six fused blocks
    six = sum(d * work.k1_bound(32, h, w, c, saving=True)[0] for c, h, w, d in stages[:2])
    assert read(_trace(kernels, 6, cfg)) == pytest.approx(100.0 * six * 3 / 0.040)
    assert read(_trace(kernels, 7, cfg)) is None
    assert read(_trace(kernels[2:], 33, cfg)) is None
