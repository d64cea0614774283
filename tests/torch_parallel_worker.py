"""The rank side of tests/test_torch_parallel.py and of the data-parallel
tests in tests/test_torch_cuda.py: what each of their spawned ranks runs,
in a module that imports torch and the port only (the ranks are fresh
interpreters that must not import JAX, and the test modules' conftest
does).

``run(spec_path)`` runs, on this rank of the joined group (its device the
spec's ``device``, default the CPU), every case the spec names and writes
this rank's results to ``<out>/rank<r>.pt``:

* ``fail_rank``: that rank raises right away, the others wait in an
  all-reduce;
* ``collectives``: ``sum_``, ``gather_rows`` and ``broadcast_object`` on
  tensors on the rank's device;
* ``conv_bn``: a ``ConvBN`` train forward on this rank's rows of a global
  input: its output rows and the new running statistics;
* ``steps``: :func:`train_steps` on this rank's rows of a global batch;
* ``evaluate``: ``cli.evaluate.main`` with its argv (the group already
  joined, so it runs as this rank).

``python tests/torch_parallel_worker.py [--lr 1e-5]`` (from the repository's
root) prints one rank's own spread, the floor under the step test's
tolerances: the two steps on the step test's global batch against the same
batch with its halves swapped (the same sums in another order),
augmentation off, as relative norms.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run as a script

from multitask_bonetumor_yolo_tpu_torch.cli import evaluate as cli_evaluate
from multitask_bonetumor_yolo_tpu_torch.data.preprocess import AugmentConfig
from multitask_bonetumor_yolo_tpu_torch.data.synthetic import synthetic_batch
from multitask_bonetumor_yolo_tpu_torch.losses import LossConfig
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.models.common import ConvBN
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block as cnb
from multitask_bonetumor_yolo_tpu_torch.ops.kernels import convnext_block_bwd as k2
from multitask_bonetumor_yolo_tpu_torch.parallel import create_mesh, dist, shard_batch
from multitask_bonetumor_yolo_tpu_torch.train import TrainConfig, create_train_state, make_train_step


# the step test's model (tests/test_torch_model.py's oracle config), loss,
# optimizer and augmentation
ORACLE = dict(nc_det=2, nc_img=2, proto_ch=8, bifpn_feature_size=64, bifpn_num_layers=2,
              img_size=160, single_head=False, dtype="float32", pallas="off",
              backbone_depths=(1, 1, 2, 1), backbone_dims=(16, 32, 48, 64))
STEP_LOSS = dict(img_size=160, nc_det=2, iou_match_thresh=0.1)
STEP_TRAIN = dict(lr=1e-5, max_epochs=2, steps_per_epoch=5)
STEP_AUG = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, hflip_prob=0.5, mosaic_prob=0.5)


def perturbed_oracle_state():
    """The oracle config's seeded weights with every parameter and BN
    statistic perturbed (running variances x U(0.7, 1.4), the rest +
    0.05 N(0, 1)), as tests/test_torch_model.py makes its weights."""
    sd = build_model(ModelConfig(**ORACLE), seed=0, device="cpu").state_dict()
    rs = np.random.RandomState(0)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        noise = rs.uniform(0.7, 1.4, v.shape) if k.endswith("running_var") else None
        sd[k] = v * torch.from_numpy(noise).float() if noise is not None else \
            v + 0.05 * torch.from_numpy(rs.randn(*v.shape)).float()
    return sd


def step_batch():
    """The step test's seeded global batch of 8 (host numpy)."""
    gen = torch.Generator().manual_seed(1)
    host = {k: v.numpy() for k, v in synthetic_batch(8, 160, gen).items()}
    host["id"] = np.arange(8, dtype=np.int32)
    host["sample_valid"] = np.ones(8, bool)
    return host


def train_steps(model_cfg, loss_cfg, train_cfg, aug_cfg, state_dict, batch, mesh, seed, n=2):
    """``n`` train steps from ``state_dict`` on ``mesh``'s rows of the host
    ``batch``, on its device, the draws from a generator seeded ``seed``.
    Returns per step the metrics, the gradient the optimizer applied and
    the launches (K1, K1 saving, K2); and the state."""
    model = build_model(ModelConfig(**model_cfg), device="cpu")
    model.load_state_dict(state_dict)
    state = create_train_state(model.cfg, TrainConfig(**train_cfg), model=model.to(mesh.device))
    out = {"metrics": [], "applied": [], "launches": []}
    apply = state.apply_gradients

    def recording(grads, bn_before):
        out["applied"].append([torch.zeros_like(p) if g is None else g.clone()
                               for p, g in zip(state.params(), grads)])
        return apply(grads, bn_before)

    state.apply_gradients = recording
    step = make_train_step(model.cfg, LossConfig(**loss_cfg), AugmentConfig(**aug_cfg))
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    counts = (cnb.convnext_block, cnb.convnext_block_saving, k2.convnext_block_bwd)
    for _ in range(n):
        before = [c.launches for c in counts]
        state, m, _ = step(state, shard_batch(batch, mesh), gen)
        out["launches"].append(tuple(c.launches - b for c, b in zip(counts, before)))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    state.apply_gradients = apply
    out["state"] = state
    return out


def run(spec_path: str) -> None:
    spec = json.loads(Path(spec_path).read_text())
    r, out = dist.rank(), {}
    dev = dist.local_device(spec.get("device", "cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False  # as the cuda tests' fixture sets
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(device=dev)
    if spec.get("fail_rank") is not None:
        if r == spec["fail_rank"]:
            raise RuntimeError(f"rank {r} fails on purpose")
        dist.sum_(torch.ones(1))
    if spec.get("collectives"):
        out["collectives"] = {
            "device": str(dev),
            "sum": dist.sum_(torch.full((3,), r + 1.0, device=dev)).cpu(),
            "rows": dist.gather_rows(torch.full((2, 2), r, device=dev)).cpu(),
            "flags": dist.gather_rows(torch.tensor([r % 2 == 0], device=dev)).cpu(),
            "object": dist.broadcast_object({"from": r})}
    if "conv_bn" in spec:
        saved = torch.load(spec["conv_bn"])
        mod = ConvBN(saved["x"].shape[1], saved["features"], 3)
        mod.load_state_dict(saved["state"])
        x = saved["x"][mesh.data_index * 4:(mesh.data_index + 1) * 4]
        out["conv_bn"] = {"y": mod(x, train=True).detach(),
                          "mean": mod.BatchNorm_0.running_mean.clone(),
                          "var": mod.BatchNorm_0.running_var.clone()}
    if "steps" in spec:
        s = spec["steps"]
        saved = torch.load(s["inputs"])
        got = train_steps(s["model"], s["loss"], s["train"], s["augment"], saved["state_dict"],
                          {k: v.numpy() for k, v in saved["batch"].items()}, mesh, s["seed"],
                          s.get("n", 2))
        state = got.pop("state")
        out["steps"] = {**got, "applied": [[g.cpu() for g in st] for st in got["applied"]],
                        "state_dict": {k: v.cpu() for k, v in state.model.state_dict().items()},
                        "mu": state.mu.cpu(), "nu": state.nu.cpu()}
    if "evaluate" in spec:
        out["evaluate"] = cli_evaluate.main(spec["evaluate"])
    torch.save(out, Path(spec["out"]) / f"rank{r}.pt")


def spread(lr: float) -> dict:
    """One rank's own spread: :func:`train_steps` (augmentation off) on the
    step batch against the same with its halves swapped, as relative norms
    (the gradients over the tensors whose gradient is not rounding noise,
    above 1e-5 of the largest element)."""
    batch, sd = step_batch(), perturbed_oracle_state()
    mesh = create_mesh(device="cpu", world_size=1, rank=0)
    swap = np.r_[4:8, 0:4]
    runs = [train_steps(ORACLE, STEP_LOSS, dict(STEP_TRAIN, lr=lr), {}, sd, b, mesh, 0)
            for b in (batch, {k: v[swap] for k, v in batch.items()})]

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm())

    out = {}
    for i, (g1, g0) in enumerate(zip(runs[1]["applied"], runs[0]["applied"])):
        top = max(float(g.abs().max()) for g in g0)
        held = [j for j, g in enumerate(g0) if float(g.abs().max()) > 1e-5 * top]
        out[f"gradient, step {i + 1}"] = rel(torch.cat([g1[j].reshape(-1) for j in held]),
                                             torch.cat([g0[j].reshape(-1) for j in held]))
    for k in ("mu", "nu"):
        out[f"{k}, after both"] = rel(getattr(runs[1]["state"], k), getattr(runs[0]["state"], k))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank's own spread under the step test")
    ap.add_argument("--lr", type=float, default=STEP_TRAIN["lr"])
    torch.set_num_threads(1)
    for name, value in spread(ap.parse_args().lr).items():
        print(f"{name}: {value:.3e}")
