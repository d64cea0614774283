"""The port's pretrained warm start (``utils/import_torch_weights.py``)
against the JAX package's, on the CPU: numpy and torch, no JAX model.

State dicts are built in the test as tests/test_weight_import.py builds
them (``make_timm_sd``, ``make_yolo_detect_sd``, ``_ultra_conv_sd``: timm
and ultralytics names, torch layouts). The heads' destination trees are the
port model's own Flax trees (``bridge.torch_to_flax``), handed to both
packages' functions as separate copies; every tree must come out equal, leaf
for leaf, bit for bit.
"""

import copy
import json

import numpy as np
import pytest
import torch

from multitask_bonetumor_yolo_tpu.utils import import_torch_weights as jw
from multitask_bonetumor_yolo_tpu_torch.bridge import torch_to_flax
from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig, build_model
from multitask_bonetumor_yolo_tpu_torch.utils import import_torch_weights as tw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from test_weight_import import _ultra_conv_sd, make_timm_sd, make_yolo_detect_sd

DEPTHS, DIMS = (1, 2, 1, 1), (8, 16, 32, 64)


def assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


def segment_sd(rs):
    sd = make_yolo_detect_sd(rs)
    for i in range(3):
        sd.update(_ultra_conv_sd(rs, f"cv4.{i}.0", 256, 64, 3))
        sd.update(_ultra_conv_sd(rs, f"cv4.{i}.1", 64, 64, 3))
        sd[f"cv4.{i}.2.weight"] = rs.randn(32, 64, 1, 1).astype(np.float32)
        sd[f"cv4.{i}.2.bias"] = rs.randn(32).astype(np.float32)
    sd.update(_ultra_conv_sd(rs, "proto.cv1", 256, 256, 3))
    sd["proto.upsample.weight"] = rs.randn(256, 256, 2, 2).astype(np.float32)
    sd["proto.upsample.bias"] = rs.randn(256).astype(np.float32)
    sd.update(_ultra_conv_sd(rs, "proto.cv2", 256, 256, 3))
    sd.update(_ultra_conv_sd(rs, "proto.cv3", 256, 32, 1))
    return sd


@pytest.fixture(scope="module")
def port_model():
    """The v1 model (BiFPN 256: the YOLO heads' width) on a small trunk;
    tests that change it take a copy."""
    cfg = ModelConfig(img_size=64, backbone_depths=DEPTHS, backbone_dims=DIMS)
    return build_model(cfg, seed=1, device="cpu")


def test_convert_convnext_tiny_matches_jax():
    """timm keys, with timm's classifier keys beside them and with the
    features_only ``body.`` prefix, depths given and read off the keys:
    the same tree as JAX's, every leaf equal."""
    sd = make_timm_sd(np.random.RandomState(0), DEPTHS, DIMS)
    sd["head.fc.weight"] = np.ones((10, DIMS[-1]), np.float32)
    for variant, depths in ((sd, DEPTHS), ({f"body.{k}": v for k, v in sd.items()}, None)):
        assert_trees_equal(tw.convert_convnext_tiny(variant, depths),
                           jw.convert_convnext_tiny(variant, depths))


def test_import_yolo_head_tensors_matches_jax(port_model):
    """Detect (plain and with ultralytics' ``model.22.`` prefix) and Segment
    state dicts copied into the v1 model's head trees: the same (copied,
    attempted) counts as JAX's, every tensor placed (72 for Detect, 72 + 36
    + 15 + 2 for Segment), and the same trees."""
    params, stats = copy.deepcopy(torch_to_flax(port_model.state_dict()))
    rs = np.random.RandomState(1)
    det = make_yolo_detect_sd(rs)
    cases = [("detect", det, "", 72),
             ("detect", {f"model.22.{k}": v for k, v in det.items()}, "model.22.", 72),
             ("segment", segment_sd(rs), "", 72 + 3 * 12 + 3 * 5 + 2)]
    for kind, sd, prefix, n in cases:
        ours = copy.deepcopy((params[kind], stats[kind]))
        theirs = copy.deepcopy((params[kind], stats[kind]))
        got = tw.import_yolo_head_tensors(sd, *ours, kind, src_prefix=prefix)
        want = jw.import_yolo_head_tensors(sd, *theirs, kind, src_prefix=prefix)
        assert got == want == (n, n), (kind, prefix)
        assert_trees_equal(ours[0], theirs[0])
        assert_trees_equal(ours[1], theirs[1])


def test_load_pretrained_matches_jax(port_model, tmp_path):
    """``load_pretrained`` from ``torch.save`` files (timm trunk, YOLO
    Detect, YOLO Segment) writes the port model so that its
    ``torch_to_flax`` equals JAX's ``load_pretrained`` over the model's
    trees before the import; the file reader agrees with JAX's ``.pt``
    reader."""
    rs = np.random.RandomState(2)
    files = {}
    for name, sd in (("convnext", make_timm_sd(rs, DEPTHS, DIMS)),
                     ("detect", make_yolo_detect_sd(rs)), ("segment", segment_sd(rs))):
        files[name] = tmp_path / f"{name}.pt"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, files[name])
        got, want = tw.load_torch_state_dict(str(files[name])), jw.load_torch_state_dict(
            str(files[name]))
        assert_trees_equal(got, want)
    model = copy.deepcopy(port_model)
    before = copy.deepcopy(torch_to_flax(model.state_dict()))  # on the CPU it shares memory
    want = jw.load_pretrained(*copy.deepcopy(before), convnext_path=str(files["convnext"]),
                              detect_sd_path=str(files["detect"]),
                              segment_sd_path=str(files["segment"]))
    tw.load_pretrained(model, convnext_path=str(files["convnext"]),
                       detect_sd_path=str(files["detect"]), segment_sd_path=str(files["segment"]))
    got = torch_to_flax(model.state_dict())
    assert_trees_equal(got[0], want[0])
    assert_trees_equal(got[1], want[1])
    assert not np.array_equal(got[0]["backbone"]["trunk"]["stem_conv"]["bias"],
                              before[0]["backbone"]["trunk"]["stem_conv"]["bias"])


def test_safetensors_with_bf16_matches_jax(tmp_path):
    """A ``.safetensors`` file written byte by byte (a bf16, an fp32, an
    int64 and an empty tensor, metadata): the port decodes bf16 through
    torch (fp32 out, the same values), the rest as they are; JAX's reader
    (``ml_dtypes``) agrees."""
    tensors = {"w_bf16": torch.randn(3, 5, generator=torch.Generator().manual_seed(3)).bfloat16(),
               "b_f32": torch.arange(4, dtype=torch.float32) / 3,
               "n_i64": torch.tensor([1, -2, 3], dtype=torch.int64),
               "empty": torch.zeros(0, 2)}
    names = {torch.bfloat16: "BF16", torch.float32: "F32", torch.int64: "I64"}
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for k, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    path = tmp_path / "w.safetensors"
    path.write_bytes(np.uint64(len(head)).tobytes() + head + b"".join(blobs))
    got = tw.load_torch_state_dict(str(path))
    want = jw.load_torch_state_dict(str(path))
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].shape == tuple(t.shape)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]).astype(got[k].dtype))
        np.testing.assert_array_equal(got[k], t.float().numpy() if t.is_floating_point()
                                      else t.numpy())
    assert got["w_bf16"].dtype == np.float32
