"""The port's data parallelism (``parallel/``, and the BatchNorm, loss,
train step, augmentation, loader, ``Trainer`` and CLIs on N ranks) on the
CPU.

Against the JAX package on its 8 virtual CPU devices: ``create_mesh``'s
layout and errors, and ``shard_batch``: rank r's rows are the r-th shard
of the JAX function's output, masks included, and a batch that does not
split raises JAX's error.

A 2-rank gloo group, spawned once for the module (``parallel.dist.spawn``:
a ``file://`` store under the module's temporary directory, one torch thread
per rank, a deadline of 180 s that fails the module with the rank's
traceback; the ranks run ``tests/torch_parallel_worker.py``, which imports
no JAX), against one rank at the same global batch in this process, in
fp32, while the ranks run:

* a ``ConvBN`` train forward over the global batch against Flax's
  ``nn.BatchNorm`` (its output and new running statistics);
* two train steps at the oracle config of tests/test_torch_model.py with
  HSV, flip and mosaic on (the draws give a group of rank 1 whose gate is
  off, so that its image comes from rank 0's rows): metrics, the applied
  gradients, parameters, moments and BN statistics within 1e-5 relative
  norm, and the two ranks' states equal bit for bit;
* ``cli.train`` for one epoch (``--nproc 2``: the CLI spawns its ranks, the
  user's route) and ``cli.evaluate`` on a conditioned checkpoint (in the
  group the module spawned: torchrun's route, a group joined already), at
  the tiny config of tests/test_torch_trainer.py.

The one-rank path is held against JAX by test_torch_train.py,
test_torch_eval.py and test_torch_trainer_parity.py, so this closes the
chain. A last test spawns a group in which one rank raises: the group ends
with its traceback, well within the deadline.

The bias of a conv in front of a train-mode BN has a zero gradient in
exact arithmetic and ~1e-7 of rounding noise (test_torch_train.py), which
comes out differently on 1 and 2 ranks; AdamW turns it into an update of
about +-lr whatever its size. Those parameters (every gradient element
below 1e-5 of the largest on one rank: the ``ConvBN`` conv biases, and the
last trunk block's ``b2``, which reaches the loss only through such convs)
are held by their gradients and by AdamW's bound of lr per step, not by
their change.

Tolerances: 1e-5 relative norm, as fp32 allows it, for the metrics,
parameters and BN statistics. The gradients and the moments are held to
1e-4: the same global batch on one rank with its two halves swapped (a
different order of the same fp32 sums, nothing else) already moves the
first step's gradient by 1.4e-5 relative norm and the moments after two
steps by 1.3e-5 to 1.5e-5 at this config (``python
tests/torch_parallel_worker.py``; the BatchNorm backward's cancellations).
The learning rate is 1e-5 (1e-6 in the ``cli.train`` run): AdamW moves an
element by about lr whatever the size of its gradient, so at the oracle's
1e-3 the elements whose gradients are rounding noise move the second
step's inputs, and the same half swap moves its gradient by 1e-3.
"""

import json
import os
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.parallel import create_mesh as jax_create_mesh
from multitask_bonetumor_yolo_tpu.parallel import shard_batch as jax_shard_batch
from multitask_bonetumor_yolo_tpu_torch.cli import evaluate as cli_evaluate
from multitask_bonetumor_yolo_tpu_torch.cli import train as cli_train
from multitask_bonetumor_yolo_tpu_torch.data import make_synthetic_btxrd
from multitask_bonetumor_yolo_tpu_torch.data.preprocess import AugmentConfig, augment_draws
from multitask_bonetumor_yolo_tpu_torch.models.common import ConvBN
from multitask_bonetumor_yolo_tpu_torch.parallel import create_mesh, dist, shard_batch
from multitask_bonetumor_yolo_tpu_torch.train import CheckpointManager, TrainConfig, create_train_state
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
import torch_parallel_worker as worker

RANKS = 2
DEADLINE_S = 180.0
TOL = 1e-5  # relative norm, fp32
GRAD_TOL = 1e-4  # the gradients and moments (the module docstring)
NOISE_BIAS = re.compile(r"ConvBN_0[./]Conv_0[./]bias$")

ORACLE, STEP_LOSS, STEP_TRAIN, STEP_AUG = (worker.ORACLE, worker.STEP_LOSS, worker.STEP_TRAIN,
                                          worker.STEP_AUG)
TINY_FLAGS = ["--img-size", "64", "--single-head", "--dtype", "float32",
              "--backbone-depths", "1,1,1,1", "--backbone-dims", "16,24,32,48",
              "--bifpn-layers", "1", "--bifpn-feature-size", "64", "--proto-ch", "8",
              "--iou-match-thresh", "0.15", "--map-max-detections", "10", "--image-ext", ".png",
              "--device", "cpu"]


def rel(got, want) -> float:
    got, want = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (got, want))
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def mosaic_seed(aug):
    """The first generator seed whose two steps' draws use one mosaic group
    and skip one on rank 1 (whose image then comes from rank 0's rows)."""
    for seed in range(100):
        gen = torch.Generator().manual_seed(seed)
        gates = [augment_draws(gen, aug, 8)["gate"].tolist() for _ in range(2)]
        if any(g[1] is False for g in gates) and any(True in g for g in gates):
            return seed
    raise AssertionError("no seed gives both gates")


def conditioned_checkpoint(path):
    """A tiny-config checkpoint (with the trainer's ``config.json``) whose
    Detect class biases are raised by 6, so that NMS at the eval confidence
    keeps boxes (tests/test_torch_eval.py)."""
    from multitask_bonetumor_yolo_tpu_torch.cli.train import build_config, make_parser

    cfg = build_config(make_parser().parse_args(["--run-dir", str(path), *TINY_FLAGS]))
    state = create_train_state(cfg.model, cfg.train, device="cpu")
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if re.search(r"cv3_\d_2\.bias$", name):
                p += 6.0
    step_dir = CheckpointManager(str(path)).save(state, 1)
    import dataclasses

    (path / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(cfg.model), "loss": dataclasses.asdict(cfg.loss),
        "data": {"img_size": 64, "max_boxes": 32, "upload_streams": 4}}, default=list))
    return step_dir


def labels_at_predictions(root, step_dir, batch):
    """Rewrite the split's box labels as the checkpoint's NMS boxes (up to 3
    per image, from the eval step over batches of ``batch``, which the
    evaluation takes too), so that detection metrics see matches. The
    images are ``img_size`` square, so the letterbox is the identity."""
    from multitask_bonetumor_yolo_tpu_torch.cli.train import build_config, make_parser
    from multitask_bonetumor_yolo_tpu_torch.data import BTXRD, BTXRDLoader, DataConfig
    from multitask_bonetumor_yolo_tpu_torch.train import make_eval_step

    cfg = build_config(make_parser().parse_args(["--root", str(root), *TINY_FLAGS]))
    state = CheckpointManager(str(step_dir.parent)).restore(
        create_train_state(cfg.model, cfg.train, device="cpu"), str(step_dir))
    step = make_eval_step(cfg.model, cfg.loss, TrainConfig(eval_top_k=10))
    ds = BTXRD(DataConfig(root=str(root), img_size=64, image_ext=".png"), "all", device="cpu")
    row = 0
    for b in BTXRDLoader(ds, batch, pad_last=True):
        _, aux = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for j in np.flatnonzero(b["sample_valid"]):
            lines = []
            for box, lab, ok in zip(aux["nms_boxes"][j], aux["nms_labels"][j], aux["nms_valid"][j]):
                x0, y0, x1, y1 = (box.clamp(0, 64) / 64).tolist()
                if ok and min(x1 - x0, y1 - y0) > 4 / 64 and len(lines) < 3:
                    lines.append(f"{int(lab)} {(x0 + x1) / 2} {(y0 + y1) / 2} {x1 - x0} {y1 - y0}")
            ds.items[row + j]["txt"].write_text("\n".join(lines) + "\n")
        row += batch


def in_thread(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (which spawns ranks) on a thread; returns a
    join that raises what it raised."""
    box = {}

    def target():
        try:
            fn(*args, **kwargs)
        except BaseException as e:  # re-raised by join
            box["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()

    def join():
        th.join(DEADLINE_S + 30)
        assert not th.is_alive(), "the ranks outlived their deadline"
        if "error" in box:
            raise box["error"]
    return join


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    work = tmp_path_factory.mktemp("ddp")
    rs = np.random.RandomState(0)
    # ConvBN: a global batch of 8, weights and statistics perturbed
    conv = ConvBN(6, 10, 3)
    with torch.no_grad():
        for t in conv.state_dict().values():
            if t.is_floating_point():
                t.add_(torch.from_numpy(rs.rand(*t.shape)).float())
    conv_in = {"x": torch.from_numpy(rs.randn(8, 6, 7, 7)).float(), "features": 10,
               "state": conv.state_dict()}
    torch.save(conv_in, work / "conv_bn.pt")
    # two train steps: a global batch of 8 at the oracle config
    aug = AugmentConfig(**STEP_AUG)
    seed = mosaic_seed(aug)
    host, sd = worker.step_batch(), worker.perturbed_oracle_state()
    torch.save({"state_dict": sd, "batch": {k: torch.from_numpy(v) for k, v in host.items()}},
               work / "steps.pt")
    # the trainer and evaluation: a tiny synthetic PNG split
    root = make_synthetic_btxrd(str(work / "data"), n=16, seed=11, min_size=64, max_size=64)
    step_dir = conditioned_checkpoint(work / "ckpt")
    labels_at_predictions(root, step_dir, 6)
    train = ["--root", str(root), "--epochs", "1", "--log-every", "1", "--lr", "1e-6",
             "--hflip", "0.5", "--hsv-v", "0.4", *TINY_FLAGS]
    evaluate = ["--checkpoint-path", str(step_dir), "--root", str(root), "--split", "all",
                "--epochs", "1", "--image-ext", ".png", "--dtype", "float32", "--device", "cpu"]
    spec = {"out": str(work), "conv_bn": str(work / "conv_bn.pt"),
            "steps": {"inputs": str(work / "steps.pt"), "model": ORACLE, "loss": STEP_LOSS,
                      "train": STEP_TRAIN, "augment": STEP_AUG, "seed": seed},
            "evaluate": evaluate + ["--run-dir", str(work / "eval2"), "--batch-size", "3"]}
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    joins = [in_thread(dist.spawn, worker.run, (str(work / "spec.json"),), RANKS, str(work),
                       device="cpu", threads=1, deadline_s=DEADLINE_S)]
    failing = work / "failing"  # a group in which rank 1 raises, beside the others
    failing.mkdir()
    (failing / "spec.json").write_text(json.dumps({"out": str(failing), "fail_rank": 1}))
    failed = {}

    def fail_group():
        t = time.perf_counter()
        try:
            dist.spawn(worker.run, (str(failing / "spec.json"),), RANKS, str(failing),
                       device="cpu", threads=1, deadline_s=60)
        except Exception as e:  # what the test reads
            failed["error"] = e
        failed["seconds"] = time.perf_counter() - t

    joins.append(in_thread(fail_group))
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # one torch thread in the CLI's ranks
    try:
        # the user's route: the CLI spawns its ranks
        joins.append(in_thread(cli_train.main, train + [
            "--run-dir", str(work / "train2"), "--batch-size", "4", "--nproc", str(RANKS)]))
        # one rank, at the same global batches, while the ranks run
        one = {}
        mesh = create_mesh(device="cpu", world_size=1, rank=0)
        one["steps"] = worker.train_steps(ORACLE, STEP_LOSS, STEP_TRAIN, STEP_AUG, sd, host,
                                          mesh, seed)
        cli_train.main(train + ["--run-dir", str(work / "train1"), "--batch-size", "8"])
        one["evaluate"] = cli_evaluate.main(evaluate + ["--run-dir", str(work / "eval1"),
                                                        "--batch-size", "6"])
        for join in joins:
            join()
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {"work": work, "one": one, "ranks": ranks, "conv_in": conv_in, "failed": failed,
            "evaluate": evaluate, "seconds": time.perf_counter() - t0}


def test_create_mesh_matches_jax():
    """The port's rank grid and shape equal the JAX mesh's device ids and
    shape on 8 devices, 1-D and 2-D; both raise the same errors."""
    for n, mp in ((None, 1), (4, 1), (8, 2), (4, 2), (8, 4), (2, 2)):
        want = jax_create_mesh(n, model_parallel=mp)
        got = create_mesh(n, model_parallel=mp, world_size=8, rank=0, device="cpu")
        assert dict(got.shape) == dict(want.shape)
        np.testing.assert_array_equal(got.grid, np.vectorize(lambda d: d.id)(want.devices))
    for n, mp in ((16, 1), (6, 4)):
        with pytest.raises(ValueError) as theirs:
            jax_create_mesh(n, model_parallel=mp)
        with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
            create_mesh(n, model_parallel=mp, world_size=8, rank=0, device="cpu")


def test_shard_batch_matches_jax():
    """For every data index r of 8- and 4-device meshes (and a 4 x 2 one),
    the port's rank-r rows equal the r-th shard of the JAX ``shard_batch``
    output, every leaf (the mask rides JAX's bit-packed path); a batch
    that does not split raises JAX's error."""
    rs = np.random.RandomState(3)
    batch = {"image": rs.randint(0, 256, (8, 4, 4, 3)).astype(np.uint8),
             "boxes": rs.rand(8, 3, 5).astype(np.float32),
             "box_valid": rs.rand(8, 3) > 0.5, "mask": (rs.rand(8, 4, 4, 1) > 0.5).astype(np.uint8),
             "img_cls": rs.randint(0, 2, 8).astype(np.int32),
             "id": np.arange(8, dtype=np.int32), "sample_valid": np.arange(8) < 7}
    for n, mp in ((8, 1), (4, 1), (8, 2)):
        jmesh = jax_create_mesh(n, model_parallel=mp)
        want = jax_shard_batch(batch, jmesh)
        for r in range(n):
            mesh = create_mesh(n, model_parallel=mp, world_size=8, rank=r, device="cpu")
            got = shard_batch(batch, mesh)
            for k, v in want.items():
                shard = next(s for s in v.addressable_shards if s.device.id == r)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data), err_msg=k)
    jmesh = jax_create_mesh(4)
    short = {k: v[:6] for k, v in batch.items()}
    with pytest.raises(ValueError) as theirs:
        jax_shard_batch(short, jmesh)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        shard_batch(short, create_mesh(4, world_size=8, rank=1, device="cpu"))


def test_conv_bn_two_ranks_match_flax(ddp):
    """``ConvBN``'s train forward on 2 ranks (4 rows each) against Flax's
    ``nn.BatchNorm`` (train mode, the port's momentum and eps) + SiLU on
    the conv output of the global batch of 8: the output rows within 1e-5
    relative norm, the new running statistics within 1e-5 on each rank and
    equal bit for bit across the ranks."""
    saved = ddp["conv_in"]
    conv = ConvBN(6, 10, 3)
    conv.load_state_dict(saved["state"])
    z = conv.Conv_0(saved["x"]).detach().permute(0, 2, 3, 1).numpy()
    bn = conv.BatchNorm_0
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=1.0 - bn.momentum,
                            epsilon=bn.eps)
    y, upd = flax_bn.apply(
        {"params": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
         "batch_stats": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}},
        jnp.asarray(z), mutable=["batch_stats"])
    want = np.asarray(jax.nn.silu(y)).transpose(0, 3, 1, 2)
    got = torch.cat([r["conv_bn"]["y"] for r in ddp["ranks"]])
    assert rel(got, want) <= TOL
    for r in ddp["ranks"]:
        assert rel(r["conv_bn"]["mean"], upd["batch_stats"]["mean"]) <= TOL
        assert rel(r["conv_bn"]["var"], upd["batch_stats"]["var"]) <= TOL
    a, b = (r["conv_bn"] for r in ddp["ranks"])
    assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])


def test_train_steps_two_ranks_match_one(ddp):
    """Two train steps with HSV, flip and mosaic on 2 ranks (4 rows each)
    against 1 rank on the global batch of 8: each step's metrics within
    1e-5; the gradient it applied within 1e-4 relative norm, its noise
    elements within 1e-5 of the largest gradient element; then the
    parameters (the noise ones within 4 lr: AdamW moves an element by at
    most lr per step, 1.0014 lr at the second, plus its decay, in each run)
    and the BN statistics within 1e-5 relative norm, the moments within
    1e-4. The two ranks end with the same state bit for bit."""
    one = ddp["one"]["steps"]
    m1, g1, state = one["metrics"], one["applied"], one["state"]
    sd1 = state.model.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    top = [max(float(g.abs().max()) for g in step) for step in g1]
    noise = {n for i, n in enumerate(names)
             if all(float(step[i].abs().max()) <= TOL * t for step, t in zip(g1, top))}
    assert {n for n in names if NOISE_BIAS.search(n)} <= noise
    two = ddp["ranks"][0]["steps"]
    for a, b in zip(two["metrics"], m1):
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= TOL * max(abs(b[k]), 1e-3), (k, a[k], b[k])
    assert [m["step_skipped"] for m in m1] == [0.0, 0.0] and m1[0]["num_pos"] > 0

    def held(tensors):
        return torch.cat([t.reshape(-1) for n, t in zip(names, tensors) if n not in noise])

    for step2, step1, t in zip(two["applied"], g1, top):
        assert rel(held(step2), held(step1)) <= GRAD_TOL
        for n, a, b in zip(names, step2, step1):
            if n in noise:
                assert float((a - b).abs().max()) <= TOL * t, n
    sd2 = two["state_dict"]
    for n in noise:  # AdamW moves an element by at most ~lr per step in each run
        assert float((sd2[n] - sd1[n]).abs().max()) <= 4.01 * STEP_TRAIN["lr"], n
    assert rel(held([sd2[n] for n in names]), held([sd1[n] for n in names])) <= TOL
    assert rel(two["mu"], state.mu) <= GRAD_TOL and rel(two["nu"], state.nu) <= GRAD_TOL
    stats = [k for k in sd1 if k.endswith(("running_mean", "running_var"))]
    assert rel(torch.cat([sd2[k] for k in stats]), torch.cat([sd1[k] for k in stats])) <= TOL
    other = ddp["ranks"][1]["steps"]
    for k, v in sd2.items():
        assert torch.equal(other["state_dict"][k], v), k
    assert torch.equal(other["mu"], two["mu"]) and torch.equal(other["nu"], two["nu"])


def records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]


def test_trainer_fit_two_ranks_matches_one(ddp):
    """``cli.train`` for one epoch (flip and HSV on) with 2 ranks of batch 4
    against 1 rank of batch 8: the same checkpoint index (names,
    steps, epochs; the metric within 1e-5), the same ``metrics.jsonl``
    records (keys; every value but the clock's within 1e-5 relative), the
    same final parameters (within 1e-5 relative norm; the noise biases
    within 2 lr of each other, AdamW's bound for the one step); the 2-rank
    run wrote ``config.json`` once, from rank 0, equal to the 1-rank run's.

    The mosaic is held in test_train_steps_two_ranks_match_one, not here:
    with it the train forward normalises over 2 images, and this epoch's
    validation, which reads those running statistics, turned their fp32
    rounding into more than 1e-5 of its image-class loss (this test with
    ``--mosaic 0.5``)."""
    work = ddp["work"]
    runs = [work / "train1", work / "train2"]
    index = [json.loads((r / "checkpoints" / "index.json").read_text()) for r in runs]
    assert sorted(index[0]) == sorted(index[1])
    for name, a in index[0].items():
        b = index[1][name]
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        assert abs(a["metric"] - b["metric"]) <= TOL * max(1.0, abs(a["metric"]))
    one, two = records(runs[0]), records(runs[1])
    assert [sorted(r) for r in one] == [sorted(r) for r in two]
    clock = ("t", "train_epoch/epoch_time_s")
    for a, b in zip(one, two):
        for k, v in a.items():
            if k not in clock and not k.startswith("train_epoch/phase_"):
                assert abs(b[k] - v) <= TOL * max(1.0, abs(v)), (k, b[k], v)
    assert any("train_step/loss_total" in r for r in one)
    assert any("val_epoch/map_iou50_map" in r for r in one)
    assert (runs[0] / "checkpoints" / "config.json").read_text() == \
        (runs[1] / "checkpoints" / "config.json").read_text()
    name = sorted(index[0])[-1]
    w1, w2 = (np.load(r / "checkpoints" / name / "weights.npz") for r in runs)
    lr = 1e-6  # the runs' --lr
    held = [k for k in w1.files if "params" in k and not NOISE_BIAS.search(k)]
    assert held and rel(np.concatenate([w2[k].ravel() for k in held]),
                        np.concatenate([w1[k].ravel() for k in held])) <= TOL
    for k in w1.files:
        if NOISE_BIAS.search(k):
            assert np.abs(w2[k] - w1[k]).max() <= 2.01 * lr, k
        elif k not in held:  # the BN statistics
            assert rel(w2[k], w1[k]) <= TOL, k


def test_evaluate_two_ranks_matches_one(ddp, monkeypatch):
    """``cli.evaluate`` on a conditioned checkpoint over 16 images with 2
    ranks of batch 3 (the last global batch of 6 padded with two replicas
    of an item on rank 0, both on rank 1) against 1 rank of batch 6: the
    same metric table within 1e-5 relative, returned on both ranks and
    written once, by rank 0. Under torchrun's environment (one rank here)
    the CLI joins that group, runs as its rank and leaves it: the same
    table."""
    want = ddp["one"]["evaluate"]
    with socket.socket() as free:
        free.bind(("127.0.0.1", 0))
        port = free.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    got = cli_evaluate.main(ddp["evaluate"] + ["--run-dir", str(ddp["work"] / "eval_env"),
                                               "--batch-size", "6"])
    assert not torch.distributed.is_initialized()
    assert got == pytest.approx(want, rel=TOL)
    for r in ddp["ranks"]:
        got = r["evaluate"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), (k, got[k], v)
    assert want["map_iou50_map"] > 0 and want["loss_box_iou"] > 0
    rec = [r for r in records(ddp["work"] / "eval2") if any(k.startswith("test/") for k in r)]
    assert len(rec) == 1 and rec[0]["test/map_iou50_map"] == pytest.approx(
        want["map_iou50_map"], rel=TOL)


def test_failing_rank_ends_the_group(ddp):
    """A rank that raises ends its group (spawned beside the module's, with a
    deadline of 60 s): ``spawn`` raises within seconds with a rank's
    traceback (the one that raised, or the other, whose all-reduce lost its
    peer), no rank wrote a result, and the store file is gone."""
    failed, failing = ddp["failed"], ddp["work"] / "failing"
    assert isinstance(failed.get("error"), torch.multiprocessing.ProcessRaisedException)
    assert "terminated with the following error" in str(failed["error"])
    assert failed["seconds"] < 60
    assert not list(failing.glob("rank*.pt")) and not list(failing.glob(".ranks-*"))
