"""Full multitask model: ConvNeXt-Tiny + BiFPN -> Detect / Segment / image-cls
(counterpart of the JAX ``models/model.py``).

Forward contract (public layout NHWC, the JAX model's keys):
    det_feats   list of 3 raw maps [B, H, W, 4*reg_max + nc_det]
    seg_coeffs  [B, A, nm]
    protos      [B, Hp, Wp, nm]
    seg_logits  [B, S, S, 1]   fp32 1x1 projection of protos, resized to S=img
    cls_logits  [B, nc_img]    fp32 head on pooled P5
and with ``mode="infer"`` also
    det_preds   [B, A, 4+nc]   decoded xywh-abs boxes + sigmoid scores
    seg_preds   [B, A, 4+nc+nm]
    cls_probs   [B, nc_img]
    seg_prob    [B, S, S, 1]
Body BN follows ``train``, head BN follows ``mode == "train"`` (the
reference's quirk, kept by the JAX model): ``train=True, mode="train"`` is the
training forward, ``train=False, mode="train"`` the reference's validation
forward (body BN on running statistics, heads on batch statistics),
``train=False, mode="infer"`` inference, and ``train=True, mode="infer"``
body BN on batch statistics (running statistics moved), heads on running
statistics, then the decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn as nn

from .backbone import ConvNeXtBlock, ConvNeXtTiny, PatchifyConv
from .bifpn import BiFPN, BiFPNUnit
from .common import BN_MOMENTUM_BODY, BN_MOMENTUM_FROZEN
from .heads import DetectHead, DetectTowers, SegmentHead, decode_detections
from ..ops.resize import resize_bilinear_nchw
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX ``ModelConfig``'s fields and defaults, so ``config.json``
    sidecars are shared. What the port does with the TPU-specific fields:

    * ``pallas``: "on" -> the hand-written CUDA ConvNeXt-block kernel (its
      plain twin on a CPU tensor); "auto" -> the kernel on a CUDA tensor
      (in the inference forward only for C <= 384: at C = 768 the eager
      block is faster, ``backbone.use_kernel``), the eager erf reference on
      a CPU tensor; "off" -> the eager reference.
    * ``ln_zfree``: read and ignored. The CUDA kernel always normalises in
      shared memory before fc1 (no extra device-memory pass to save there).
    * ``fuse_towers``: read and ignored. The heads always run the towers'
      first 3x3 convs as one conv (exact; the JAX default).
    * ``block_bwd``: the ConvNeXt block backward per stage width, as JAX's
      ``_bwd_for_dim``: "auto" -> K1's residual-saving form + K2 for
      C <= 384 and eager blocks under autograd at C = 768; "fused" -> the
      kernels on every stage; "ref" -> eager blocks everywhere in training.
    * ``eval_bn``: the body BN momentum in training ("reference": Flax 3e-4,
      "frozen": 0.9); the heads keep theirs.
    """

    nc_det: int = 2
    nc_img: int = 2
    proto_ch: int = 32
    bifpn_feature_size: int = 256
    bifpn_num_layers: int = 2
    img_size: int = 640
    reg_max: int = 16
    single_head: bool = False
    dtype: str = "float32"
    pallas: str = "auto"
    backbone_depths: tuple = (3, 3, 9, 3)
    backbone_dims: tuple = (96, 192, 384, 768)
    eval_bn: str = "reference"
    fuse_towers: bool = True
    ln_zfree: bool = True
    block_bwd: str = "auto"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class MultitaskModel(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        if cfg.eval_bn not in ("reference", "frozen"):
            raise ValueError(f"unknown eval_bn {cfg.eval_bn!r}")
        self.cfg = cfg
        fs = cfg.bifpn_feature_size
        bm = BN_MOMENTUM_FROZEN if cfg.eval_bn == "frozen" else BN_MOMENTUM_BODY
        self.backbone = ConvNeXtTiny(cfg.pallas, cfg.backbone_depths, cfg.backbone_dims,
                                     bm, cfg.block_bwd)
        self.neck = BiFPN((256, 384, 512), fs, cfg.bifpn_num_layers, bn_momentum=bm)
        self.segment = SegmentHead(cfg.nc_det, cfg.proto_ch, fs, fs, (fs,) * 3,
                                   reg_max=cfg.reg_max)
        if not cfg.single_head:
            self.detect = DetectHead(cfg.nc_det, fs, (fs,) * 3, reg_max=cfg.reg_max)
        self.cls_fc = nn.Linear(fs, cfg.nc_img)
        self.seg_proto_projector = nn.Conv2d(cfg.proto_ch, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False, mode: str = "infer") -> Dict[str, Any]:
        """``x``: NHWC [B, S, S, 3] float images in [0, 1]."""
        if mode not in ("train", "infer"):
            raise ValueError(f"Unknown mode {mode!r}. Expected 'train' or 'infer'.")
        cfg = self.cfg
        with span("model.forward"):
            x = x.to(cfg.compute_dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            with span("model.backbone"):
                feats = list(self.backbone(x, train))
            with span("model.neck"):
                feats = self.neck(feats, train)
            with span("model.heads"):
                head_train = mode == "train"
                nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731  channels_last view
                seg_det_raw, seg_coeffs, protos = self.segment(feats, head_train)
                det_raw = seg_det_raw if cfg.single_head else self.detect(feats, head_train)

                pooled = feats[2].float().mean(dim=(2, 3))
                cls_logits = self.cls_fc(pooled)
                seg_logits = resize_bilinear_nchw(
                    self.seg_proto_projector(protos.float()), cfg.img_size, cfg.img_size
                )

                det_feats = [nhwc(t) for t in det_raw]
                out = {
                    "det_feats": det_feats,
                    "seg_coeffs": seg_coeffs,
                    "protos": nhwc(protos),
                    "seg_logits": nhwc(seg_logits),
                    "cls_logits": cls_logits,
                }
                if mode == "train":
                    return out
                seg_preds_det = decode_detections(
                    [nhwc(t) for t in seg_det_raw], cfg.nc_det, cfg.img_size, cfg.reg_max
                )
                seg_preds = torch.cat([seg_preds_det, seg_coeffs.float()], dim=-1)
                if cfg.single_head:
                    det_preds = seg_preds[..., : 4 + cfg.nc_det]
                else:
                    det_preds = decode_detections(det_feats, cfg.nc_det, cfg.img_size, cfg.reg_max)
                out.update(
                    det_preds=det_preds,
                    seg_preds=seg_preds,
                    cls_probs=torch.softmax(cls_logits, dim=-1),
                    seg_prob=nhwc(torch.sigmoid(seg_logits)),
                )
                return out


# The standard deviation of a standard normal cut to [-2, 2]: Flax's
# ``variance_scaling(..., "truncated_normal")`` divides by it so that the cut
# draw keeps the variance ``scale / fan_in``.
TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation from the Flax initialisers the JAX model names:
    ``lecun_normal`` for every conv, linear, transposed-conv and patchify
    kernel, ``variance_scaling(2.0, "fan_in", "truncated_normal")`` for the
    ConvNeXt blocks' ``dw_kernel``, ``w1`` and ``w2``. Both draw a standard
    normal truncated to [-2, 2] times ``sqrt(scale / fan_in) /
    TRUNCATED_NORMAL_STD``, with fan-in taken as Flax takes it on the JAX
    kernel's shape (k*k*in/groups for a conv, 4*in for the 2x2 transposed
    conv, 49 for ``dw_kernel``). The constants are the JAX model's: zero
    biases, unit norms, layer-scale gamma 1e-6, BiFPN fusion weights 1, the
    ultralytics detect-bias priors. Draws on ``generator``'s device."""

    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))

    def truncated_(t, scale, fan_in):
        # jax.random.truncated_normal: the inverse CDF of a uniform between
        # the bounds' CDF values, clamped to the bounds
        u = torch.rand(t.shape, generator=generator, device=generator.device,
                       dtype=torch.float64) * (hi - lo) + lo
        z = (math.sqrt(2.0) * torch.erfinv(u)).float().clamp_(-2.0, 2.0)
        t.copy_(z * (math.sqrt(scale / fan_in) / TRUNCATED_NORMAL_STD))

    for mod in model.modules():
        if isinstance(mod, ConvNeXtBlock):
            c = mod.dw_kernel.shape[0]
            truncated_(mod.dw_kernel, 2.0, 49)
            truncated_(mod.w1, 2.0, c)
            truncated_(mod.w2, 2.0, 4 * c)
            for p in (mod.dw_bias, mod.ln_bias, mod.b1, mod.b2):
                p.zero_()
            mod.ln_scale.fill_(1.0)
            mod.gamma.fill_(1e-6)
        elif isinstance(mod, (nn.Conv2d, nn.Linear, PatchifyConv)):
            truncated_(mod.weight, 1.0, mod.weight[0].numel())  # [out, in/groups, ...]
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.ConvTranspose2d):
            truncated_(mod.weight, 1.0, mod.weight[:, 0].numel())  # [in, out, k, k]
            mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, BiFPNUnit):
            mod.w1.fill_(1.0)
            mod.w2.fill_(1.0)
    for mod in model.modules():  # after the generic pass over its convs
        if isinstance(mod, DetectTowers):
            for i in range(len(mod.strides)):
                box_b, cls_b = mod.bias_init_values(i)
                getattr(mod, f"cv2_{i}_2").bias.fill_(box_b)
                getattr(mod, f"cv3_{i}_2").bias.fill_(cls_b)
    return model


def build_model(cfg: ModelConfig, seed: int = 0, device: torch.device | str = "cuda") -> MultitaskModel:
    """A seeded model on ``device`` (default the first card; without one it
    raises unless the caller asks for ``"cpu"``) in ``channels_last`` memory,
    in eval mode."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to build on the CPU")
    model = MultitaskModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()
