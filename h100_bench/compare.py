"""The numbers that decide ``correct``, each held against its limit
(``limits/<cell>.json``).

Serving, over the requests sampled from the seed, against the fp32
reference with the same weights, stage by stage, each continuous output as
the norm of its difference over the reference's norm:

* ``neck_gap``: the neck's three maps (trunk, K1, C2f, BiFPN) against the
  reference's on the same images;
* ``head_gap``: the worst of the heads' outputs against the reference's
  heads on the served neck maps (their own stage): the box and class logits
  of the head whose boxes NMS takes (``det_feats``), the mask coefficients,
  the prototypes. The detection logits alone do not separate from the
  lower-precision control by enough to hold a limit of their own: the
  program's distance there is a steady floor set by storing the head's
  activations and outputs in bf16 (PERF.md);
* ``cls_gap``: the image-class logits against the reference's pooling and
  linear layer on the served neck maps;
* ``seg_gap``: the semantic-mask logits against the reference's projection
  and upsampling of the served prototypes.

The stages after the model, on the served model's own outputs (NMS is
discontinuous in its inputs, so it is judged on the inputs it was given,
and the model before it on its own):

* ``decode_gap``: the largest gap of the served decoded boxes (in units of
  the image side) and scores, image-class and mask probabilities against
  the reference's decode, softmax and sigmoid of the served logits;
* ``nms_mismatch``: the NMS slots (index, box, score or class) that differ
  from the reference's greedy NMS over the served predictions; exact;
* ``mask_gap``: the largest gap of an instance mask's mean, or of its value
  at pixels drawn from the seed, against the reference's masks composed
  from the served coefficients, prototypes and detections.

Training, over the first steps (``checked_steps``), against the fp32
reference's steps from the same weights on the same batches:

* ``fwd_gap``: the first step's mask probabilities (the step's ``seg_prob``
  output), the norm of the difference over the reference's norm;
* ``gnorm_gap``: the largest relative gap of the global gradient norm
  before clipping, over the steps;
* ``grad_gap``: the median leaf's gap between the norms of the first
  step's clipped gradient (the program's worked out from its first Adam
  moment after one step), over the larger of the reference's norm of that
  leaf and the median leaf's;
* ``update_gap``: the worst leaf's such gap for the parameters' change over
  the steps;
* ``bn_gap``: the worst BN running statistic's such gap for its change.

The leaves whose first reference gradient is under a thousandth of the
median leaf's are left out of ``grad_gap`` and ``update_gap``: a bias
before a train-mode BatchNorm has a gradient of zero up to round-off, and
Adam moves it by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from .reference import post
from .reference.model import decode

SERVE_OUTPUTS = ("det_feats", "det_preds", "seg_coeffs", "protos", "cls_logits", "cls_probs",
                 "seg_logits", "seg_prob")


class Served(NamedTuple):
    """What one request answered: the model's outputs (``SERVE_OUTPUTS``),
    the NMS slots and the instance masks' digest; and the neck's maps on the
    way."""

    outputs: Dict
    detections: post.Detections
    digest: torch.Tensor
    neck: List[torch.Tensor]


def mask_digest(m: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """[B, K, S, S] masks -> [B, K, 1 + P]: each mask's mean and its values
    at ``pixels`` (flat indices)."""
    flat = m.reshape(m.shape[0], m.shape[1], -1)
    return torch.cat([flat.float().mean(-1, keepdim=True), flat[..., pixels].float()], -1)


def _gap(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rms(a, b) -> float:
    """:func:`rms_gap` of a tensor or of a list of them taken together."""
    if isinstance(b, (list, tuple)):
        a, b = torch.cat([t.reshape(-1) for t in a]), torch.cat([t.reshape(-1) for t in b])
    return rms_gap(a, b)


def rms_gap(a, b) -> float:
    """The norm of the difference over the reference's norm; rows of ``b``
    that ``a`` lacks count as zeros."""
    a = a.float()
    if a.shape[0] < b.shape[0]:
        a = torch.cat([a, a.new_zeros((b.shape[0] - a.shape[0], *a.shape[1:]))])
    return ((a - b.float()).norm() / b.float().norm()).item()


def serve_numbers(answer: Served, ref_neck: List[torch.Tensor], ref: Dict,
                  ref_seg: torch.Tensor, cfg: Dict, tr: Dict,
                  pixels: torch.Tensor) -> Dict[str, float]:
    """The serving numbers of one request. ``ref_neck``: the fp32
    reference's neck maps of its images; ``ref``: the fp32 reference's heads
    on the served neck maps; ``ref_seg``: its projection of the served
    prototypes."""
    s, nc = cfg["img_size"], cfg["nc_det"]
    o = answer.outputs
    unit = torch.tensor([s] * 4 + [1] * nc, dtype=torch.float32, device=o["det_preds"].device)
    redo = decode([t.float() for t in o["det_feats"]], nc, s, cfg["reg_max"])
    again = post.nms(o["det_preds"], s, tr["conf_thresh"], tr["nms_iou"], tr["top_k"])
    d = answer.detections
    differs = (d.indices.long() != again.indices.long()) | (d.valid != again.valid)
    differs |= d.valid & ((d.boxes.float() != again.boxes).any(-1)
                          | (d.scores.float() != again.scores)
                          | (d.labels.long() != again.labels.long()))
    masks = post.masks(o["seg_coeffs"], o["protos"], d, s)
    return {
        "neck_gap": _rms(answer.neck, ref_neck),
        "head_gap": max(_rms(o[k], ref[k]) for k in ("det_feats", "seg_coeffs", "protos")),
        "cls_gap": _rms(o["cls_logits"], ref["cls_logits"]),
        "seg_gap": _rms(o["seg_logits"], ref_seg),
        "decode_gap": max(_gap(o["det_preds"].float() / unit, redo / unit),
                          _gap(o["cls_probs"], torch.softmax(o["cls_logits"].float(), -1)),
                          _gap(o["seg_prob"], torch.sigmoid(o["seg_logits"].float()))),
        "nms_mismatch": float(differs.sum().item()),
        "mask_gap": _gap(answer.digest, mask_digest(masks, pixels)),
    }


def _leaf_gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor], names: List[str]):
    """Per leaf the gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and the median leaf's; and both norms."""
    pn = torch.stack([p[n].double().norm() for n in names])
    rn = torch.stack([r[n].double().norm() for n in names])
    return (pn - rn).abs() / torch.maximum(rn, rn.median()), pn, rn


def worst_leaves(p, r, names: List[str], k: int = 4) -> List:
    """The ``k`` worst leaves: [name, gap, program's norm, reference's]."""
    gap, pn, rn = _leaf_gaps(p, r, names)
    return [[names[i], gap[i].item(), pn[i].item(), rn[i].item()]
            for i in gap.argsort(descending=True)[:k].tolist()]


def _moved(ref: Dict) -> List[str]:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    names = list(ref["grad1"])
    g = torch.stack([ref["grad1"][n].double().norm() for n in names])
    return [n for n, v in zip(names, g) if v >= 1e-3 * g.median()]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each: ``gnorms`` (per step), ``fwd1`` (the first
    step's ``seg_prob``), ``grad1`` / ``delta`` / ``bn_delta`` (tensors by
    name)."""
    steps = range(min(len(prog["gnorms"]), len(ref["gnorms"])))
    moved = _moved(ref)
    return {
        "fwd_gap": rms_gap(prog["fwd1"]["seg_prob"], ref["fwd1"]["seg_prob"]),
        "gnorm_gap": max(abs(prog["gnorms"][i] - ref["gnorms"][i]) / ref["gnorms"][i]
                         for i in steps),
        "grad_gap": _leaf_gaps(prog["grad1"], ref["grad1"], moved)[0].median().item(),
        "update_gap": _leaf_gaps(prog["delta"], ref["delta"], moved)[0].max().item(),
        "bn_gap": _leaf_gaps(prog["bn_delta"], ref["bn_delta"], list(ref["bn_delta"]))[0]
        .max().item(),
    }


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """What lies under the training numbers, for the calibration: each
    step's largest loss-term gap over its total loss, the worst leaves of
    the gradient and of the change."""
    moved = _moved(ref)
    steps = range(min(len(prog["losses"]), len(ref["losses"])))
    return {
        "loss_by_step": [max(abs(prog["losses"][i][k] - ref["losses"][i][k])
                             for k in ref["losses"][i]) / abs(ref["losses"][i]["total"])
                         for i in steps],
        "grad_worst": worst_leaves(prog["grad1"], ref["grad1"], moved),
        "update_worst": worst_leaves(prog["delta"], ref["delta"], moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number passes when it is finite and
    not above the limit."""
    out = {}
    for k, v in numbers.items():
        lim = limits[k]
        out[k] = {"value": v, "limit": lim, "ok": v == v and v <= lim}
    return out


def worst(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Per number the larger reading (NaN stays)."""
    return {k: b[k] if (b[k] != b[k] or b[k] > a[k]) else a[k] for k in a}
