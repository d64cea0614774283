"""On-device preprocessing and augmentation (counterpart of the JAX
``data/preprocess.py``).

The host ships uint8 letterboxed canvases; the train step normalises them on
the device and, where ``AugmentConfig`` enables them, augments the batch
there, all static-shape tensor ops on the batch's device:

  * ``normalize``      uint8 -> float [0, 1];
  * ``hsv_augment``    per-image random hue shift and saturation / value gain;
  * ``random_hflip``   per-image horizontal flip of image, mask and boxes;
  * ``mosaic4``        groups of 4 composed into 2x2 quadrant mosaics.

Augmentations default off, for parity with the reference.

Each random function draws from an explicit ``torch.Generator`` (on the
batch's device), then hands the draws to a plain function that applies them
(``hsv_apply``, ``hflip_apply``, :func:`augment_apply`), so that the same
draws give the same batch on any device. The draws of :func:`augment_batch`
are the JAX function's, in its order, from its four keys: the HSV gains
U(-1, 1) per image after the mosaic, the flips Bernoulli(``hflip_prob``) per
image after the mosaic, the mosaic gate Bernoulli(``mosaic_prob``) per group
of 4.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.resize import resize_bilinear, resize_nearest
from ..parallel import dist


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX ``AugmentConfig``'s fields and defaults (all off; YOLO's
    values when enabled: hsv 0.015 / 0.7 / 0.4, hflip 0.5, mosaic 1.0)."""

    hsv_h: float = 0.0
    hsv_s: float = 0.0
    hsv_v: float = 0.0
    hflip_prob: float = 0.0
    mosaic_prob: float = 0.0

    @property
    def enabled(self) -> bool:
        return (self.hsv_h > 0 or self.hsv_s > 0 or self.hsv_v > 0
                or self.hflip_prob > 0 or self.mosaic_prob > 0)

    @property
    def hsv(self) -> bool:
        return self.hsv_h > 0 or self.hsv_s > 0 or self.hsv_v > 0


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 in [0, 1]."""
    return images_u8.to(torch.float32) / 255.0


# ---------------------------------------------------------------- HSV jitter
def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe_d = torch.where(d == 0, 1.0, d)
    # ``%`` on tensors is floor-mod (torch.remainder), as jnp's
    h = torch.where(mx == r, ((g - b) / safe_d) % 6.0,
                    torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0)) / 6.0
    h = torch.where(d == 0, 0.0, h)
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def _select(i: torch.Tensor, values) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 5], values)``: the first true case,
    0 where none is."""
    out = torch.zeros_like(values[0])
    for k in reversed(range(len(values))):
        out = torch.where(i == k, values[k], out)
    return out


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h6 = (h % 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=-1)


def hsv_apply(images: torch.Tensor, r: torch.Tensor,
              gains: Tuple[float, float, float]) -> torch.Tensor:
    """The HSV jitter for draws ``r`` [B, 3] in [-1, 1]: hue + r0 * gains[0]
    (mod 1), saturation and value x (1 + r * gain), clipped to [0, 1].
    images: f32 [B, H, W, 3] in [0, 1]."""
    gh = r[:, 0] * gains[0]
    gs = r[:, 1] * gains[1] + 1.0
    gv = r[:, 2] * gains[2] + 1.0
    hsv = _rgb_to_hsv(images)
    h = (hsv[..., 0] + gh[:, None, None]) % 1.0
    s = torch.clamp(hsv[..., 1] * gs[:, None, None], 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * gv[:, None, None], 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0


def _bernoulli(gen: torch.Generator, p: float, n: int) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < p


def hsv_augment(images: torch.Tensor, gen: torch.Generator,
                gains: Tuple[float, float, float]) -> torch.Tensor:
    """Per-image random hue shift and sat/val scaling. images: f32 [B, H, W, 3]."""
    return hsv_apply(images, _uniform(gen, (images.shape[0], 3)), gains)


# ---------------------------------------------------------------- flips
def hflip_apply(images: torch.Tensor, boxes: torch.Tensor, masks: torch.Tensor,
                flip: torch.Tensor):
    """Flip the images and masks [B, H, W, C] whose ``flip`` [B] is set, and
    their boxes' x centres (boxes [B, M, 5]: cls, xc, yc, w, h normalised)."""
    imgs_f = torch.where(flip[:, None, None, None], torch.flip(images, dims=(2,)), images)
    masks_f = torch.where(flip[:, None, None, None], torch.flip(masks, dims=(2,)), masks)
    boxes_f = boxes.clone()
    boxes_f[..., 1] = torch.where(flip[:, None], 1.0 - boxes[..., 1], boxes[..., 1])
    return imgs_f, boxes_f, masks_f


def random_hflip(images: torch.Tensor, boxes: torch.Tensor, masks: torch.Tensor,
                 gen: torch.Generator, prob: float):
    """Per-image horizontal flip with probability ``prob``."""
    return hflip_apply(images, boxes, masks, _bernoulli(gen, prob, images.shape[0]))


# ---------------------------------------------------------------- mosaic
def mosaic4(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
            masks: torch.Tensor):
    """Compose groups of 4 into quadrant mosaics; the output batch is B // 4.

    images [B, S, S, 3] f32 (B % 4 == 0), boxes [B, M, 5], valid [B, M],
    masks [B, S, S, 1]. Each source is downscaled 2x (bilinear; nearest for
    the mask) into its quadrant (0 top-left, 1 top-right, 2 bottom-left, 3
    bottom-right); normalised box coordinates map as (x, y) -> ((x + ox) / 2,
    (y + oy) / 2). The output keeps M box slots: the valid boxes of the 4
    sources packed to the front, in order, the rest zero."""
    b, s = images.shape[0], images.shape[1]
    if b % 4:
        raise ValueError(f"mosaic4 needs a multiple-of-4 batch, got {b}")
    g, m, half = b // 4, boxes.shape[1], s // 2

    small = resize_bilinear(images, half, half).reshape(g, 4, half, half, 3)
    small_m = resize_nearest(masks, half, half).reshape(g, 4, half, half, 1)
    out_img = torch.cat([torch.cat([small[:, 0], small[:, 1]], dim=2),
                         torch.cat([small[:, 2], small[:, 3]], dim=2)], dim=1)
    quads = torch.cat([torch.cat([small_m[:, 0], small_m[:, 1]], dim=2),
                       torch.cat([small_m[:, 2], small_m[:, 3]], dim=2)], dim=1)
    out_mask = (quads > 0.5).to(masks.dtype)

    bx = boxes.reshape(g, 4, m, 5)
    ox = torch.tensor([0.0, 1.0, 0.0, 1.0], device=boxes.device)[None, :, None]
    oy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=boxes.device)[None, :, None]
    new = torch.stack([bx[..., 0], (bx[..., 1] + ox) * 0.5, (bx[..., 2] + oy) * 0.5,
                       bx[..., 3] * 0.5, bx[..., 4] * 0.5], dim=-1).reshape(g, 4 * m, 5)
    vflat = valid.reshape(g, 4 * m).bool()
    # the valid boxes first, in order: a stable sort of an integer copy
    order = torch.argsort((~vflat).to(torch.int32), dim=1, stable=True)[:, :m]
    packed = torch.gather(new, 1, order[..., None].expand(-1, -1, 5))
    packed_valid = torch.gather(vflat, 1, order)
    packed = torch.where(packed_valid[..., None], packed, 0.0)
    return out_img, packed, packed_valid.to(valid.dtype), out_mask


# ---------------------------------------------------------------- the stage
def augment_draws(gen: torch.Generator, cfg: AugmentConfig, b: int) -> Dict[str, torch.Tensor]:
    """The random draws :func:`augment_apply` takes for a batch of ``b``:
    ``gate`` [b // 4] (with mosaic), ``hsv`` [b', 3] and ``flip`` [b'], b'
    the batch after the mosaic (b // 4 with it)."""
    draws = {}
    if cfg.mosaic_prob > 0:
        draws["gate"] = _bernoulli(gen, cfg.mosaic_prob, b // 4)
    out_b = b // 4 if cfg.mosaic_prob > 0 else b
    if cfg.hsv:
        draws["hsv"] = _uniform(gen, (out_b, 3))
    if cfg.hflip_prob > 0:
        draws["flip"] = _bernoulli(gen, cfg.hflip_prob, out_b)
    return draws


def augment_apply(batch: Dict[str, torch.Tensor], cfg: AugmentConfig,
                  draws: Dict[str, torch.Tensor],
                  head: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The augmentation stage for the given draws (:func:`augment_draws`'
    keys): normalise, then the mosaic, HSV and flip that ``cfg`` enables.

    With mosaic enabled the output batch is B // 4 for the whole step. Group
    j keeps ``img_cls[j]``, ``id[j]`` and ``sample_valid[j]``, and where its
    gate is off image j itself (the first B // 4 of the batch, as the JAX
    function's code does: image j's label, where its docstring says the
    group's first source, image 4j). ``head``: those B // 4 rows when they
    are not the first of ``batch`` (a rank's share of a global batch,
    :func:`augment_batch`)."""
    images = normalize(batch["image"])
    if not cfg.enabled:
        return {**batch, "image": images}
    boxes, valid, masks = batch["boxes"], batch["box_valid"], batch["mask"]
    img_cls = batch["img_cls"]
    if cfg.mosaic_prob > 0:
        m_img, m_boxes, m_valid, m_mask = mosaic4(images, boxes, valid, masks)
        use, g = draws["gate"], m_img.shape[0]
        if head is None:
            head = {k: v[:g] for k, v in batch.items()}
        images = torch.where(use[:, None, None, None], m_img, normalize(head["image"]))
        boxes = torch.where(use[:, None, None], m_boxes, head["boxes"])
        valid = torch.where(use[:, None], m_valid, head["box_valid"])
        masks = torch.where(use[:, None, None, None], m_mask, head["mask"])
        img_cls = head["img_cls"]
        batch = head
    if cfg.hsv:
        images = hsv_apply(images, draws["hsv"], (cfg.hsv_h, cfg.hsv_s, cfg.hsv_v))
    if cfg.hflip_prob > 0:
        images, boxes, masks = hflip_apply(images, boxes, masks, draws["flip"])
    n = images.shape[0]
    out = dict(image=images, boxes=boxes, box_valid=valid, mask=masks, img_cls=img_cls)
    for key in ("id", "sample_valid"):
        if key in batch:
            out[key] = batch[key][:n]
    return out


def augment_batch(batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator],
                  cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """The on-device stage: normalise, plus the augmentations ``cfg``
    enables, their draws taken from ``gen`` (a generator on the batch's
    device; unused when nothing is enabled).

    On N ranks (``parallel/dist.py``) ``batch`` is this rank's block of b
    rows of the global batch, and ``gen`` is seeded alike on every rank:
    each rank draws for the global batch and applies its own block of the
    draws. A mosaic group (4 consecutive images) then stays inside one rank,
    which needs b % 4 == 0. The global batch's first B // 4 rows, which the
    mosaic keeps beside its groups, are gathered from the ranks that hold
    them."""
    if not cfg.enabled:
        return augment_apply(batch, cfg, {})
    n, b = dist.world_size(), batch["image"].shape[0]
    draws = augment_draws(gen, cfg, b * n)
    if n == 1:
        return augment_apply(batch, cfg, draws)
    if cfg.mosaic_prob > 0 and b % 4:
        raise ValueError(f"mosaic on {n} ranks needs a per-rank batch that is a multiple of 4 "
                         f"(its groups of 4 must not straddle ranks), got {b}")
    r, out_b = dist.rank(), (b // 4 if cfg.mosaic_prob > 0 else b)
    draws = {k: v[r * len(v) // n:(r + 1) * len(v) // n] for k, v in draws.items()}
    head = None
    if cfg.mosaic_prob > 0:
        g = b * n // 4  # the global head; ranks past min(b, g) rows hold none of it
        head = {k: dist.gather_rows(v[:min(b, g)])[:g][r * out_b:(r + 1) * out_b]
                for k, v in batch.items()}
    return augment_apply(batch, cfg, draws, head)
