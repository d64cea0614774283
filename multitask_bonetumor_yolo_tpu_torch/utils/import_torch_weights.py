"""Pretrained warm start from torch state dicts (counterpart of the JAX
``utils/import_torch_weights.py``).

The reference builds its trunk from timm's ``convnext_tiny`` and copies a
YOLOv8 checkpoint's last Detect / Segment tensors into its heads
(``load_pretrained_heads``). Here the user supplies the files (nothing is
downloaded): ``.pt`` / ``.pth`` through ``torch.load(weights_only=True)``,
``.safetensors`` through a header parse (bf16 decoded by torch).

The mapping is the JAX module's, copied: timm and ultralytics names and
torch layouts to the Flax trees of the JAX model. :func:`load_pretrained`
writes them into a port model through the bridge: the live model's
``torch_to_flax`` trees, the imported leaves merged in, then ``flax_to_torch``
and ``load_state_dict``.

Layout transforms (torch -> Flax):
  conv      [O, I, kh, kw]  -> HWIO [kh, kw, I, O]
  depthwise [C, 1, kh, kw]  -> [kh, kw, 1, C]
  deconv    [I, O, kh, kw]  -> ConvTranspose [kh, kw, I, O], both tap axes flipped
  linear    [O, I]          -> [I, O]
  batchnorm weight / bias / running_mean / running_var -> scale / bias / mean / var
"""

from __future__ import annotations

import json
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..bridge import flax_to_torch, torch_to_flax

Array = np.ndarray
StateDict = Mapping[str, Array]


def _conv(w: Array) -> Array:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _dwconv(w: Array) -> Array:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _deconv(w: Array) -> Array:
    # Flax places tap [a, b] at output offset [k-1-a, k-1-b], torch at [a, b]
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1])


def _linear(w: Array) -> Array:
    return np.transpose(np.asarray(w), (1, 0))


def _numpy(t: torch.Tensor) -> Array:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_torch_state_dict(path: str) -> Dict[str, Array]:
    """A ``.pt`` / ``.pth`` / ``.safetensors`` state dict as numpy arrays
    (bf16 tensors as fp32). A ``.pt`` holding its tensors under
    ``"state_dict"``, ``"model"`` or ``"ema"`` is unwrapped, as the JAX
    reader does (a pickled module is refused: ``weights_only``)."""
    if str(path).endswith(".safetensors"):
        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "ema"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {k: _numpy(v) for k, v in obj.items() if isinstance(v, torch.Tensor)}


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, Array]:
    """A ``.safetensors`` file (u64-LE header length, JSON header {name:
    {dtype, shape, data_offsets}}, raw buffer) as numpy arrays; bf16 is
    decoded by torch and returned as fp32."""
    with open(path, "rb") as f:
        (hlen,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(hlen)))
        buf = bytearray(f.read())
    out: Dict[str, Array] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        lo, hi = spec["data_offsets"]
        t = torch.frombuffer(buf, dtype=_SAFETENSORS_DTYPES[spec["dtype"]],
                             count=(hi - lo) // _SAFETENSORS_DTYPES[spec["dtype"]].itemsize,
                             offset=lo) if hi > lo else torch.empty(0)
        out[name] = _numpy(t.reshape(spec["shape"]).clone())
    return out


# ---------------------------------------------------------------- ConvNeXt
def convert_convnext_tiny(sd: StateDict, depths=None) -> Dict[str, dict]:
    """timm convnext_tiny state dict -> the Flax params of the JAX
    ``ConvNeXtFeatures`` (the port's ``backbone.trunk``). Takes timm's
    classifier keys (``stem.0.weight``, ``stages.0.blocks.0.conv_dw.weight``)
    and features_only prefixes (a leading ``body.`` or ``model.`` is
    stripped); ``depths`` is read off the keys when not given."""
    sd = {k.removeprefix("body.").removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    if depths is None:
        counts: Dict[int, int] = {}
        for k in sd:
            m = re.match(r"stages\.(\d+)\.blocks\.(\d+)\.", k)
            if m:
                s, b = int(m.group(1)), int(m.group(2))
                counts[s] = max(counts.get(s, -1), b)
        depths = tuple(counts[i] + 1 for i in sorted(counts))

    def ln(prefix: str) -> dict:
        return {"LayerNorm_0": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}

    params: Dict[str, dict] = {
        "stem_conv": {"kernel": _conv(sd["stem.0.weight"]), "bias": sd["stem.0.bias"]},
        "stem_norm": ln("stem.1"),
    }
    for i, depth in enumerate(depths):
        if i > 0:
            params[f"downsample_norm{i}"] = ln(f"stages.{i}.downsample.0")
            params[f"downsample_conv{i}"] = {
                "kernel": _conv(sd[f"stages.{i}.downsample.1.weight"]),
                "bias": sd[f"stages.{i}.downsample.1.bias"],
            }
        for j in range(depth):
            p = f"stages.{i}.blocks.{j}"
            params[f"stage{i}_block{j}"] = {
                "dw_kernel": _dwconv(sd[f"{p}.conv_dw.weight"]),
                "dw_bias": sd[f"{p}.conv_dw.bias"],
                "ln_scale": sd[f"{p}.norm.weight"],
                "ln_bias": sd[f"{p}.norm.bias"],
                "w1": _linear(sd[f"{p}.mlp.fc1.weight"]),
                "b1": sd[f"{p}.mlp.fc1.bias"],
                "w2": _linear(sd[f"{p}.mlp.fc2.weight"]),
                "b2": sd[f"{p}.mlp.fc2.bias"],
                "gamma": sd[f"{p}.gamma"],
            }
    return params


# ---------------------------------------------------------------- YOLO heads
def _convbn_params(sd: StateDict, src: str) -> Tuple[dict, dict]:
    """ultralytics Conv (conv + bn) -> (params, batch_stats) of a ConvBN."""
    params = {
        "Conv_0": {"kernel": _conv(sd[f"{src}.conv.weight"])},
        "BatchNorm_0": {"scale": sd[f"{src}.bn.weight"], "bias": sd[f"{src}.bn.bias"]},
    }
    stats = {"BatchNorm_0": {"mean": sd[f"{src}.bn.running_mean"],
                             "var": sd[f"{src}.bn.running_var"]}}
    return params, stats


def _final_conv_params(sd: StateDict, src: str) -> dict:
    return {"kernel": _conv(sd[f"{src}.weight"]), "bias": sd[f"{src}.bias"]}


def import_yolo_head_tensors(sd: StateDict, head_params: dict, head_stats: dict,
                             kind: str = "detect", src_prefix: str = "",
                             strict_shapes: bool = True) -> Tuple[int, int]:
    """Copy shape-matching tensors of a YOLO Detect / Segment state dict into
    ``head_params`` / ``head_stats`` (numpy trees) in place. ``sd`` keys are
    relative to the head module (``cv2.0.0.conv.weight``; strip e.g.
    ``model.22.`` or pass it as ``src_prefix``). Returns the (copied,
    attempted) tensor counts, as the reference's transfer report."""
    copied = attempted = 0

    def put(dst_tree: dict, dst_path: Tuple[str, ...], value: Array):
        nonlocal copied, attempted
        attempted += 1
        node = dst_tree
        for k in dst_path[:-1]:
            if k not in node:
                return
            node = node[k]
        leaf = dst_path[-1]
        if leaf not in node:
            return
        if strict_shapes and tuple(node[leaf].shape) != tuple(value.shape):
            print(f"    shape mismatch at {'/'.join(dst_path)}: "
                  f"dst {node[leaf].shape} src {value.shape}")
            return
        node[leaf] = np.asarray(value, dtype=np.asarray(node[leaf]).dtype)
        copied += 1

    def put_convbn(params: dict, stats: dict, path: Tuple[str, ...], src: str):
        p, st = _convbn_params(sd, src)
        put(params, path + ("ConvBN_0", "Conv_0", "kernel"), p["Conv_0"]["kernel"])
        put(params, path + ("ConvBN_0", "BatchNorm_0", "scale"), p["BatchNorm_0"]["scale"])
        put(params, path + ("ConvBN_0", "BatchNorm_0", "bias"), p["BatchNorm_0"]["bias"])
        put(stats, path + ("ConvBN_0", "BatchNorm_0", "mean"), st["BatchNorm_0"]["mean"])
        put(stats, path + ("ConvBN_0", "BatchNorm_0", "var"), st["BatchNorm_0"]["var"])

    sd = {k.removeprefix(src_prefix): np.asarray(v) for k, v in sd.items()}
    towers = head_params.get("towers", head_params)
    towers_stats = head_stats.get("towers", head_stats)
    branches = [(towers, towers_stats, b) for b in ("cv2", "cv3")]
    if kind == "segment":
        branches.append((head_params, head_stats, "cv4"))
    for params, stats, branch in branches:
        for i in range(3):
            for j in range(2):
                src = f"{branch}.{i}.{j}"
                if f"{src}.conv.weight" in sd:
                    put_convbn(params, stats, (f"{branch}_{i}_{j}",), src)
            src = f"{branch}.{i}.2"
            if f"{src}.weight" in sd:
                fc = _final_conv_params(sd, src)
                put(params, (f"{branch}_{i}_2", "kernel"), fc["kernel"])
                put(params, (f"{branch}_{i}_2", "bias"), fc["bias"])
    if kind == "segment":
        # Proto: cv1 / upsample (deconv with bias) / cv2 / cv3, under proto.*
        for cv in ("cv1", "cv2", "cv3"):
            src = f"proto.{cv}"
            if f"{src}.conv.weight" in sd:
                put_convbn(head_params, head_stats, ("proto", cv), src)
        if "proto.upsample.weight" in sd:
            put(head_params, ("proto", "upsample", "kernel"), _deconv(sd["proto.upsample.weight"]))
            put(head_params, ("proto", "upsample", "bias"), sd["proto.upsample.bias"])
    return copied, attempted


@torch.no_grad()
def load_pretrained(model: torch.nn.Module, convnext_path: Optional[str] = None,
                    detect_sd_path: Optional[str] = None,
                    segment_sd_path: Optional[str] = None) -> torch.nn.Module:
    """Warm-start ``model`` (a ``MultitaskModel``, on any device) in place,
    as the JAX ``load_pretrained`` does to its Flax trees: the trunk replaced
    by the converted timm tree, the heads' tensors copied, a transfer report
    printed per head. The trees are the model's own (``torch_to_flax``),
    written back through the bridge; every key must land
    (``load_state_dict(strict=True)``)."""
    params, batch_stats = torch_to_flax(model.state_dict())
    if convnext_path:
        params["backbone"]["trunk"] = convert_convnext_tiny(load_torch_state_dict(convnext_path))
        print(f"ConvNeXt backbone      : imported from {convnext_path}")
    if detect_sd_path and "detect" in params:
        c, t = import_yolo_head_tensors(load_torch_state_dict(detect_sd_path), params["detect"],
                                        batch_stats.get("detect", {}), "detect")
        print(f"Detect head          : {c}/{t} tensors copied from {detect_sd_path}")
    if segment_sd_path:
        c, t = import_yolo_head_tensors(load_torch_state_dict(segment_sd_path), params["segment"],
                                        batch_stats.get("segment", {}), "segment")
        print(f"Segment head         : {c}/{t} tensors copied from {segment_sd_path}")
    model.load_state_dict(flax_to_torch(params, batch_stats), strict=True)
    return model
