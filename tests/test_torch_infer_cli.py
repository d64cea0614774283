"""The port's inference CLI on the CPU: the bridge's inverse walk
(``torch_to_flax``), ``cli.infer.main`` on PNG files against ``infer_batch``,
its overlay images on JPEG files against the JAX ``RunLogger``'s, and the
block dispatch of ``models/backbone.py::use_kernel``."""

import json
import types

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch, save_npz, torch_to_flax
from multitask_bonetumor_yolo_tpu_torch.cli import infer
from multitask_bonetumor_yolo_tpu.utils.logging import RunLogger as JaxRunLogger
from multitask_bonetumor_yolo_tpu_torch.data.imageio import read_png, write_png
from multitask_bonetumor_yolo_tpu_torch.data.jpeg import write_jpeg
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.models.backbone import bwd_for_dim, use_kernel
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SIZE = 64


@torch.no_grad()
def random_model(seed=0):
    model = build_model(ModelConfig(img_size=SIZE, dtype="float32"), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for t in list(model.parameters()) + [b for n, b in model.named_buffers()
                                         if n.endswith("running_mean")]:
        t.add_(0.05 * torch.randn(t.shape, generator=gen))
    return model


@pytest.fixture(scope="module")
def served():
    """The v1 model with perturbed weights, shared by the two tests below
    (neither changes it; a full-width build takes ~1 s)."""
    return random_model(1).eval()


def test_torch_to_flax_inverts_flax_to_torch(served):
    """``flax_to_torch(*torch_to_flax(sd))`` equals the v1 model's
    ``state_dict`` key for key and bit for bit, and the trees hold no
    torch-only leaf name."""
    sd = served.state_dict()
    params, stats = torch_to_flax(sd)
    back = flax_to_torch(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.to(back[k].dtype)), k
    assert "stage0_block0" in params["backbone"]["trunk"]
    assert "running_mean" not in repr(stats) and "num_batches_tracked" not in repr(stats)


def test_main_on_png_matches_infer_batch(served, tmp_path, capsys):
    """``main`` with ``--device cpu`` on two PNGs (one not square), with a
    checkpoint written by ``save_npz`` from ``torch_to_flax``: each record's
    boxes, scores, labels and class probabilities equal those of
    ``infer_batch`` on the same letterboxed canvas."""
    model = served
    ckpt = tmp_path / "w.npz"
    save_npz(str(ckpt), *torch_to_flax(model.state_dict()))
    rng = np.random.RandomState(5)
    paths = []
    for name, (h, w) in (("a.png", (48, 64)), ("b.png", (50, 50))):
        write_png(tmp_path / name, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        paths.append(str(tmp_path / name))
    out = tmp_path / "out"
    infer.main(["--checkpoint-path", str(ckpt), "--images", *paths, "--out-dir", str(out),
                "--img-size", str(SIZE), "--dtype", "float32", "--conf-thresh", "0.05",
                "--device", "cpu"])
    capsys.readouterr()
    records = json.loads((out / "predictions.json").read_text())
    assert [r["image"] for r in records] == paths
    # the checkpoint holds these weights bit for bit (the inverse test above)
    for rec, path in zip(records, paths):
        res = infer.infer_batch(model, infer.load_and_letterbox(path, SIZE)[None],
                                conf_thresh=0.05)
        n = int(res.detections.valid[0].sum())
        assert n > 0 and rec["num_detections"] == n
        assert rec["boxes_xyxy"] == res.detections.boxes[0, :n].tolist()
        assert rec["scores"] == res.detections.scores[0, :n].tolist()
        assert rec["labels"] == res.detections.labels[0, :n].tolist()
        assert rec["img_cls_probs"] == res.outputs["cls_probs"][0].float().tolist()


def test_main_overlays_match_jax_run_logger(served, tmp_path, capsys):
    """``main`` on two JPEGs (written by the port's writer, read on the CPU)
    writes, per image, the detection and segmentation overlays that the JAX
    CLI writes: the PNGs under ``media/`` equal what the JAX ``RunLogger``'s
    ``log_det_examples`` / ``log_seg_examples`` write when handed the port's
    own NMS output and seg probabilities for the same canvas."""
    model = served
    ckpt = tmp_path / "w.npz"
    save_npz(str(ckpt), *torch_to_flax(model.state_dict()))
    rng = np.random.RandomState(6)
    paths = []
    for name, (h, w) in (("a.jpeg", (48, 64)), ("b.jpeg", (70, 50))):
        write_jpeg(tmp_path / name, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        paths.append(str(tmp_path / name))
    out, ref = tmp_path / "out", tmp_path / "ref"
    conf = 0.05
    infer.main(["--checkpoint-path", str(ckpt), "--images", *paths, "--out-dir", str(out),
                "--img-size", str(SIZE), "--dtype", "float32", "--conf-thresh", str(conf),
                "--device", "cpu"])
    capsys.readouterr()
    jax_logger = JaxRunLogger(str(ref))
    for path in paths:
        canvas = infer.load_and_letterbox(path, SIZE, "cpu")
        res = infer.infer_batch(model, canvas[None], conf_thresh=conf)
        det = res.detections
        assert int(det.valid.sum()) > 0
        imgs = canvas[None].astype(np.float32) / 255.0
        stem = path.rsplit("/", 1)[1].split(".")[0]
        jax_logger.log_det_examples(imgs, det.boxes.numpy(), det.scores.numpy(),
                                    det.labels.numpy(), det.valid.numpy(), None, None,
                                    stage=stem, step=0, conf_th=conf)
        jax_logger.log_seg_examples(imgs, res.outputs["seg_prob"].float().numpy(), None,
                                    stage=stem, step=0)
    jax_logger.close()
    names = sorted(p.name for p in (ref / "media").glob("*.png"))
    assert names == ["det_a_0_0.png", "det_b_0_0.png", "seg_a_0_0.png", "seg_b_0_0.png"]
    assert sorted(p.name for p in (out / "media").glob("*.png")) == names
    for name in names:
        got, want = read_png(out / "media" / name), read_png(ref / "media" / name)
        assert np.array_equal(got, want), name


def fake(device, dim):
    """Stands in for an NHWC block input of width ``dim`` on ``device``
    (use_kernel reads only its device type and width; the CPU tests have
    no card)."""
    return types.SimpleNamespace(device=torch.device(device), shape=(1, 8, 8, dim))


@pytest.mark.parametrize("pallas", ["auto", "on", "off"])
def test_use_kernel_stage_policy(pallas):
    """Under "auto" the inference forward runs K1 for C <= 512 (every stage
    of ConvNeXt-Tiny and -Base but the last) and the eager block at C = 768
    and 1024 on the card, and training keeps the kernel at every width
    (``bwd_for_dim`` decides there); the CPU runs eager. "on" runs the
    kernel everywhere, "off" nowhere."""
    for dim in (96, 128, 192, 256, 384, 512, 768, 1024):
        for train in (False, True):
            for dev in ("cuda", "cpu"):
                want = {"on": True, "off": False,
                        "auto": dev == "cuda" and (train or dim <= 512)}[pallas]
                assert use_kernel(pallas, fake(dev, dim), train) is want, (dim, train, dev)
    with pytest.raises(ValueError):
        use_kernel("sometimes", fake("cuda", 96))


@pytest.mark.parametrize("dim,want", [(96, "fused"), (128, "fused"), (192, "fused"),
                                      (256, "fused"), (384, "fused"), (512, "fused"),
                                      (768, "ref"), (1024, "ref")])
def test_bwd_for_dim_stage_policy(dim, want):
    """Under "auto" a stage trains on K1's saving form and K2 up to C = 512
    (Tiny's stages 0-2, Base's 0-2) and as eager blocks under autograd at
    768 and 1024; "fused" and "ref" hold at every width."""
    assert bwd_for_dim(dim) == want
    assert bwd_for_dim(dim, "fused") == "fused" and bwd_for_dim(dim, "ref") == "ref"
    with pytest.raises(ValueError):
        bwd_for_dim(dim, "sometimes")
