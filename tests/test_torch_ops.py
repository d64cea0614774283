"""The port's tensor ops against the JAX package, on the CPU: anchors, box
decode, DFL, resize, the Proto phase composition, NMS, mask composition;
and a check that importing the port never imports JAX.

Inputs are made with numpy from a seed and handed to both packages.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from multitask_bonetumor_yolo_tpu.core import anchors as j_anchors
from multitask_bonetumor_yolo_tpu.core import boxes as j_boxes
from multitask_bonetumor_yolo_tpu.core import dfl as j_dfl
from multitask_bonetumor_yolo_tpu.ops import fused_upsample as j_fu
from multitask_bonetumor_yolo_tpu.ops import masks as j_masks
from multitask_bonetumor_yolo_tpu.ops import nms as j_nms
from multitask_bonetumor_yolo_tpu.ops import resize as j_resize

from multitask_bonetumor_yolo_tpu_torch.bridge import flax_to_torch
from multitask_bonetumor_yolo_tpu_torch.core import anchors, boxes, dfl
from multitask_bonetumor_yolo_tpu_torch.ops import fused_upsample, masks, nms, resize
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_make_anchors_matches_jax():
    pts, strd = anchors.make_anchors(320)
    jp, js = j_anchors.make_anchors(320)
    close(pts, jp, 0, 0)
    close(strd, js, 0, 0)
    assert anchors.num_anchors(320) == pts.shape[0]


def test_dist2bbox_and_dfl_decode_match_jax():
    rs = np.random.RandomState(0)
    d = rs.rand(3, 50, 4).astype(np.float32) * 10
    p = rs.rand(50, 2).astype(np.float32) * 40
    for fmt in ("xyxy", "xywh"):
        close(boxes.dist2bbox(T(d), T(p)[None], fmt),
              j_boxes.dist2bbox(jnp.asarray(d), jnp.asarray(p)[None], fmt))
    logits = rs.randn(2, 30, 4, 16).astype(np.float32) * 3
    close(dfl.dfl_decode(T(logits)), j_dfl.dfl_decode(jnp.asarray(logits)))


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_resize_bilinear_matches_jax(scale):
    x = np.random.RandomState(1).randn(2, 12, 10, 5).astype(np.float32)
    oh, ow = int(12 * scale), int(10 * scale)
    close(resize.resize_bilinear(T(x), oh, ow),
          j_resize.resize_bilinear(jnp.asarray(x), oh, ow))


@pytest.mark.parametrize("h,w,c,m,o", [(8, 8, 5, 6, 7), (5, 9, 3, 4, 2)])
def test_fused_upsample_matches_jax_and_unfused_torch(h, w, c, m, o):
    rs = np.random.RandomState(2)
    x = rs.randn(2, h, w, c).astype(np.float32)
    kt = rs.randn(2, 2, c, m).astype(np.float32) * 0.3  # Flax ConvTranspose
    bt = rs.randn(m).astype(np.float32) * 0.3
    k3 = rs.randn(3, 3, m, o).astype(np.float32) * 0.3  # Flax Conv HWIO
    with jax.default_matmul_precision("highest"):
        want = j_fu.fused_upsample_conv3x3(*map(jnp.asarray, (x, kt, bt, k3)))
    sd = flax_to_torch({"upsample": {"kernel": kt, "bias": bt}, "cv2": {"kernel": k3}}, {})
    args = (sd["upsample.weight"], sd["upsample.bias"], sd["cv2.weight"])
    got = fused_upsample.fused_upsample_conv3x3(T(x), *args)
    close(got, want)
    # the literal pair it replaces, with the bridged weights
    z = F.conv_transpose2d(T(x).permute(0, 3, 1, 2), args[0], args[1], stride=2)
    pair = F.conv2d(z, args[2], padding=1).permute(0, 2, 3, 1)
    close(got, pair)


def random_boxes(rng, n, size=640):
    cx, cy = rng.rand(n) * size, rng.rand(n) * size
    w, h = rng.rand(n) * 100 + 5, rng.rand(n) * 100 + 5
    b = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return np.clip(b, 0, size).astype(np.float32)


def assert_same_nms(got, want):
    for name in ("valid", "indices", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    close(got.boxes, want.boxes, 1e-5, 0)
    close(got.scores, want.scores, 1e-6, 0)


@pytest.mark.parametrize("a,top_k,ranges", [
    (300, 50, [(0.0, 1.0)] * 2),
    (3000, 100, [(0.1, 1.0)] * 2),  # all above conf: tests/test_nms.py's >1024 regime
    (700, 100, [(0.0, 0.05), (0.0, 0.055), (0.0, 1.0)]),  # ragged: none, few, most
])
def test_batched_nms_matches_jax(a, top_k, ranges):
    """Random boxes, image i's scores uniform in ``ranges[i]``, conf 0.05."""
    rs = np.random.RandomState(3)
    bx = np.stack([random_boxes(rs, a) for _ in ranges])
    sc = np.stack([rs.rand(a) * (hi - lo) + lo for lo, hi in ranges]).astype(np.float32)
    lb = rs.randint(0, 2, (len(ranges), a)).astype(np.int32)
    want = j_nms.batched_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(lb),
                             iou_thresh=0.6, conf_thresh=0.05, top_k=top_k)
    assert_same_nms(nms.batched_nms(T(bx), T(sc), T(lb), 0.6, 0.05, top_k), want)


def test_nms_ties_and_chain_match_jax():
    """Equal scores go to the lower index; a suppression chain that crosses
    a block boundary keeps every other box."""
    n = 200
    bx = np.zeros((1, n, 4), np.float32)
    for i in range(n):
        bx[0, i] = [i * 20.0, 0.0, i * 20.0 + 40.0, 40.0]
    sc = np.repeat(np.linspace(0.9, 0.5, n // 2, dtype=np.float32), 2)[None]
    lb = np.zeros((1, n), np.int32)
    want = j_nms.batched_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(lb),
                             iou_thresh=0.25, conf_thresh=0.05, top_k=n)
    got = nms.batched_nms(T(bx), T(sc), T(lb), 0.25, 0.05, n)
    assert_same_nms(got, want)
    identical = np.tile(np.array([[10.0, 10.0, 50.0, 50.0]], np.float32), (6, 1))[None]
    flat = np.full((1, 6), 0.7, np.float32)
    got = nms.batched_nms(T(identical), T(flat), T(np.zeros((1, 6), np.int32)), 0.6, 0.05, 6)
    assert got.indices[0].tolist() == [0, -1, -1, -1, -1, -1]


def test_postprocess_detections_matches_jax():
    rs = np.random.RandomState(4)
    b, a, nc = 2, 1200, 2
    preds = np.zeros((b, a, 4 + nc), np.float32)
    preds[..., :2] = rs.rand(b, a, 2) * 640
    preds[..., 2:4] = rs.rand(b, a, 2) * 120 + 4
    preds[..., 4:] = rs.rand(b, a, nc)
    preds[0, 7, 4:] = preds[0, 3, 4:]  # an exact score tie across anchors
    want = j_nms.postprocess_detections(jnp.asarray(preds), 640)
    assert_same_nms(nms.postprocess_detections(T(preds), 640), want)


@pytest.mark.parametrize("crop,img_size", [(False, None), (True, 64)])
def test_compose_masks_matches_jax(crop, img_size):
    rs = np.random.RandomState(5)
    b, a, nm, hp, k = 2, 50, 8, 16, 5
    coeffs = rs.randn(b, a, nm).astype(np.float32)
    protos = rs.randn(b, hp, hp, nm).astype(np.float32)
    idx = np.stack([rs.choice(a, k, replace=False) for _ in range(b)]).astype(np.int32)
    valid = rs.rand(b, k) < 0.7
    idx[~valid] = -1
    bx = np.zeros((b, k, 4), np.float32)
    bx[..., :2] = rs.rand(b, k, 2) * 30
    bx[..., 2:] = bx[..., :2] + rs.rand(b, k, 2) * 30 + 2
    sc = rs.rand(b, k).astype(np.float32)
    lb = np.zeros((b, k), np.int32)
    jr = j_nms.NMSResult(*map(jnp.asarray, (bx, sc, lb, valid, idx)))
    tr = nms.NMSResult(*map(T, (bx, sc, lb, valid, idx)))
    want = j_masks.compose_masks(jnp.asarray(coeffs), jnp.asarray(protos), jr,
                                 crop=crop, img_size=img_size)
    got = masks.compose_masks(T(coeffs), T(protos), tr, crop=crop, img_size=img_size)
    close(got, want)


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, cv2 and PIL out of
    sys.modules (a subprocess: this test process has jax loaded by
    conftest). The walk must reach the evaluation, training, raw-BTXRD and
    data-parallel paths' modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import multitask_bonetumor_yolo_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                            "cv2", "PIL")
                     or m.startswith("multitask_bonetumor_yolo_tpu."))
        eval_path = ("metrics", "metrics.classification", "metrics.segmentation",
                     "metrics.detection", "data.dataset", "data.synthetic",
                     "train.checkpoint", "train.loop", "train.steps", "utils.logging",
                     "cli.evaluate", "cli.train", "data.preprocess", "ops.resize",
                     "utils.profiling", "utils.import_torch_weights", "data.jpeg",
                     "ops.kernels.jpeg", "data.convert", "utils.xlsx", "cli.prepare_data",
                     "cli.wrangle", "cli.show_sample", "cli.infer", "parallel", "parallel.mesh",
                     "parallel.dist", "parallel.pack")
        missing = sorted(m for m in eval_path if f"{pkg.__name__}.{m}" not in names)
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 30 else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_infer_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """``cli.infer.main`` runs on the card by default: without one it raises
    before loading anything, instead of falling back to the CPU."""
    from multitask_bonetumor_yolo_tpu_torch.cli import infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["--checkpoint-path", str(tmp_path / "missing.npz"),
                    "--images", "x.jpeg", "--out-dir", str(tmp_path)])
