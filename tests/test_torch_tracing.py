"""The port's tracer (``utils/profiling.py``) at its call sites, on the CPU.

One tiny model (64^2, dims 16/32/48/64, fp32, the plain versions of the
kernels), one serving request through ``cli/infer.py::infer_batch`` and one
``train/steps.py::train_step``: off, the tracer records nothing and opens no
profiler range; on, it records the documented span tree, counts NMS's host
reads and candidates, puts its spans into a ``torch.profiler`` trace nested
as it recorded them, and changes no output bit. Torch only.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.cli.infer import infer_batch
from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.ops import nms
from multitask_bonetumor_yolo_tpu_torch.train import (TrainConfig, create_train_state,
                                                      make_train_step)
from multitask_bonetumor_yolo_tpu_torch.utils import profiling

IMG, B = 64, 2
CFG = ModelConfig(img_size=IMG, backbone_depths=(1, 1, 1, 1), backbone_dims=(16, 32, 48, 64),
                  bifpn_feature_size=32, proto_ch=8, dtype="float32", pallas="off")
LOSS = LossConfig(img_size=IMG, nc_det=2, assigner="tal")
SERVE = dict(conf_thresh=0.0, nms_iou=0.6, top_k=20, instance_masks=True)
MODEL_TREE = {"model.forward": "model.backbone model.neck model.heads".split(),
              "model.backbone": [f"model.backbone.stage{i}" for i in range(4)]}
# span -> its children, as the call sites open them
TREE = {
    "infer": ["infer.upload", "model.forward", "nms", "masks"],
    "nms": ["nms.wait"],
    "train_step": ["augment", "model.forward", "loss", "backward", "optimizer"],
    "loss": ["loss.assign"],
    **MODEL_TREE,
}


@pytest.fixture(autouse=True)
def clean_tracer():
    """One torch thread (the suite runs in several processes), and the
    tracer off and empty after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(threads)


def train_once(model, batch):
    """One train step on a fresh state around a copy of ``model``; its
    metrics and the updated parameters."""
    state = create_train_state(CFG, TrainConfig(lr=1e-3), model=copy.deepcopy(model).train())
    _, metrics, aux = make_train_step(CFG, LOSS)(state, batch, None)
    return metrics, aux, [p.detach().clone() for p in state.params()]


def serve_and_train(model, images, batch):
    """One request and one step under a CPU ``torch.profiler``: the
    outputs and the profiler's events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        served = infer_batch(model, images, **SERVE)
        trained = train_once(model, batch)
    return served, trained, prof.events()


@pytest.fixture(scope="module")
def runs():
    """The same request and step with the tracer off, then on: per side the
    outputs and profiler events, and for the side on the tracer's records
    and report."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = build_model(CFG, seed=0, device="cpu").eval()
    images = np.random.RandomState(0).randint(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    batch = synthetic_batch(B, IMG, torch.Generator().manual_seed(1))
    try:
        off = serve_and_train(model, images, batch)
        off_records, off_report = profiling.records(), profiling.report()
        profiling.enable()
        on = serve_and_train(model, images, batch)
        on_records, on_report = profiling.records(), profiling.report()
    finally:
        profiling.disable()
        profiling.reset()
        torch.set_num_threads(threads)
    return dict(off=off, off_records=off_records, off_report=off_report,
                on=on, records=on_records, report=on_report)


def span_names(events):
    return [e.name for e in events if e.name in profiling.SPANS]


def test_off_records_nothing_and_opens_no_range(runs):
    assert span_names(runs["off"][2]) == []
    assert runs["off_records"] == []
    assert runs["off_report"] == {"spans": {}, "first": {}, "counters": {}, "per_root": {},
                                  "dropped": 0}


def test_span_tree_of_a_request_and_a_step(runs):
    spans = runs["records"]
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["infer", "train_step"]
    assert len({s.trace for s in roots}) == 2
    for s in spans:
        assert s.name in profiling.SPANS
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.trace == root.trace
    for parent, children in TREE.items():
        for p in (s for s in spans if s.name == parent):
            got = [s.name for s in spans if s.parent == p.id]
            assert sorted(set(got)) == sorted(children), (parent, got)
    rep = runs["report"]
    for name, r in rep["spans"].items():
        assert 0 <= r["self_host_ms"] <= r["host_ms"], name
        assert r["device_ms"] is None
    assert rep["spans"]["nms.wait"]["count"] == rep["counters"]["nms.waits"]
    assert set(rep["counters"]) <= set(profiling.COUNTERS)
    assert rep["per_root"]["infer"]["count"] == rep["per_root"]["train_step"]["count"] == 1
    assert rep["per_root"]["infer"]["nms.waits"] == rep["counters"]["nms.waits"]
    assert set(rep["first"]) == {"infer", "train_step"}


@pytest.mark.parametrize("pallas,route", [("off", "eager"), ("on", "kernel")])
def test_trunk_counts_its_blocks_by_route(pallas, route):
    """Each block counts its route once per forward, in a request's root and
    in a step's: "off" runs every block eager, "on" every block on the
    kernel route (the plain twins on the CPU); the other counter stays
    unraised. On the card "auto" splits them by width (33 / 3 at
    ConvNeXt-Base, 15 / 3 at Tiny)."""
    cfg = dataclasses.replace(CFG, backbone_depths=(1, 2, 1, 1), pallas=pallas)
    model = build_model(cfg, seed=0, device="cpu").eval()
    images = np.random.RandomState(0).randint(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    batch = synthetic_batch(B, IMG, torch.Generator().manual_seed(1))
    profiling.enable()
    infer_batch(model, images, **SERVE)
    state = create_train_state(cfg, TrainConfig(lr=1e-3), model=copy.deepcopy(model).train())
    make_train_step(cfg, LOSS)(state, batch, None)
    rep = profiling.report()
    other = {"eager": "kernel", "kernel": "eager"}[route]
    for root in ("infer", "train_step"):
        assert rep["per_root"][root][f"trunk.blocks.{route}"] == 5, root
        assert f"trunk.blocks.{other}" not in rep["per_root"][root], root
    assert rep["spans"]["model.backbone.stage1"]["count"] == 2


def test_nms_counts_its_host_reads_and_candidates(monkeypatch):
    """Over 128 candidates (two blocks): ``nms.waits`` is the candidate
    count's read plus each ``torch.equal`` the blocks made."""
    gen = torch.Generator().manual_seed(3)
    a, nc = 400, 2
    xy = torch.rand(B, a, 2, generator=gen) * 56 + 4
    wh = torch.rand(B, a, 2, generator=gen) * 12 + 2
    preds = torch.cat([xy, wh, torch.rand(B, a, nc, generator=gen)], -1)
    equal, calls = torch.equal, [0]

    def counted(*args):
        calls[0] += 1
        return equal(*args)

    monkeypatch.setattr(torch, "equal", counted)
    profiling.enable()
    nms.postprocess_detections(preds, IMG, iou_thresh=0.5, conf_thresh=0.3, top_k=50)
    k = int((preds[..., 4:].amax(-1) > 0.3).sum(1).max())
    counters = profiling.report()["counters"]
    assert k > nms.BLOCK
    assert counters["nms.candidates"] == k
    assert counters["nms.waits"] == 1 + calls[0]


def test_spans_nest_in_a_profiler_trace_as_recorded(runs):
    spans = runs["records"]
    by_id = {s.id: s for s in spans}
    want = sorted((s.name, by_id[s.parent].name if s.parent is not None else None)
                  for s in spans)
    got = []
    for e in runs["on"][2]:
        if e.name not in profiling.SPANS:
            continue
        up = e.cpu_parent
        while up is not None and up.name not in profiling.SPANS:
            up = up.cpu_parent
        got.append((e.name, up.name if up is not None else None))
    assert sorted(got) == want


def test_outputs_are_bit_identical_with_tracing_on(runs):
    (off, off_train, _), (on, on_train, _) = runs["off"], runs["on"]
    pairs = [(off.outputs[k], on.outputs[k]) for k in ("det_preds", "seg_prob", "cls_probs")]
    pairs += list(zip(off.detections, on.detections))
    pairs.append((off.instance_masks, on.instance_masks))
    pairs += [(off_train[0][k], on_train[0][k]) for k in off_train[0]]
    pairs += [(off_train[1][k], on_train[1][k]) for k in off_train[1]]
    pairs += list(zip(off_train[2], on_train[2]))
    for a, b in pairs:
        assert torch.equal(a, b)


def test_cap_keeps_each_first_root_and_phases_open_spans(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 2)
    profiling.enable()
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("data"):
            pass
    with profiling.span("infer"):
        profiling.count("nms.waits", 3)
    rep = profiling.report()
    assert [s.name for s in profiling.records()] == ["epoch.data", "epoch.data"]
    assert rep["dropped"] == 1
    assert set(rep["first"]) == {"epoch.data", "infer"}
    assert rep["counters"] == {"nms.waits": 3}
    assert set(timer.totals) == {"data"}
