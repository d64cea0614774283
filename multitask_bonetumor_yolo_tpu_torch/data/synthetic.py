"""Synthetic data: a seeded train batch made on the device, and a BTXRD-layout
dataset on disk (counterpart of the JAX ``data/synthetic.py``).

``make_synthetic_btxrd`` draws the JAX function's arrays from the same
``RandomState`` and writes the images as PNG by default (``<stem>.png``,
named so in ``img_cls.csv``), or, with ``image_format="jpeg"``, as the JAX
function does: ``<stem>.jpeg`` through ``data/jpeg.py::write_jpeg``, the
same bytes as the ``cv2.imwrite`` that the JAX function calls.
``make_synthetic_raw`` emits the converter's input (labelme
``Annotations/*.json``, JPEG ``images/``, ``dataset.csv``) with the JAX
function's draws, JSON and bytes.
"""

from __future__ import annotations

from pathlib import Path
import json
from typing import Dict

import numpy as np
import torch

from .imageio import write_png
from .jpeg import write_jpeg


def synthetic_batch(b: int, img: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """``b`` uint8 images ``[b, img, img, 3]`` with 3 random boxes each
    (normalised (cls, xc, yc, w, h) in 8 padded slots, sides 0.1-0.4, centres
    0.25-0.75), their union as a box-shaped mask, and random image classes:
    the keys ``make_train_step`` and ``multitask_loss`` read."""
    dev, n, slots = gen.device, 3, 8
    boxes = torch.zeros(b, slots, 5, device=dev)
    boxes[:, :n, 0] = torch.randint(0, 2, (b, n), generator=gen, device=dev).float()
    boxes[:, :n, 1:3] = torch.rand(b, n, 2, generator=gen, device=dev) * 0.5 + 0.25
    boxes[:, :n, 3:5] = torch.rand(b, n, 2, generator=gen, device=dev) * 0.3 + 0.1
    valid = torch.zeros(b, slots, dtype=torch.bool, device=dev)
    valid[:, :n] = True
    pix = (torch.arange(img, device=dev).float() + 0.5) / img
    lo = boxes[:, :n, 1:3] - boxes[:, :n, 3:5] / 2
    hi = boxes[:, :n, 1:3] + boxes[:, :n, 3:5] / 2
    in_x = (pix > lo[..., 0:1]) & (pix < hi[..., 0:1])
    in_y = (pix > lo[..., 1:2]) & (pix < hi[..., 1:2])
    mask = (in_y[..., :, None] & in_x[..., None, :]).any(1).float()[..., None]
    return {
        "image": torch.randint(0, 256, (b, img, img, 3), generator=gen, device=dev,
                               dtype=torch.uint8),
        "boxes": boxes, "box_valid": valid, "mask": mask,
        "img_cls": torch.randint(0, 2, (b,), generator=gen, device=dev),
    }


def _lesion(rng, h, w, cls_id):
    """One synthetic lesion: class 0 = smooth bright ellipse ('benign'),
    class 1 = irregular star polygon with mottled texture ('malignant').
    Returns (mask[h,w] bool, intensity[h,w] float in [0,1] inside mask,
    bbox xyxy)."""
    bw = int(rng.randint(max(12, w // 12), max(16, w // 3)))
    bh = int(rng.randint(max(12, h // 12), max(16, h // 3)))
    x1 = int(rng.randint(0, max(1, w - bw)))
    y1 = int(rng.randint(0, max(1, h - bh)))
    cy, cx = y1 + bh / 2, x1 + bw / 2
    yy, xx = np.mgrid[0:h, 0:w]
    if cls_id == 0:
        # smooth ellipse
        m = ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2 <= 1.0
        tex = np.full((h, w), 0.85) - 0.25 * (
            ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2
        ).clip(0, 1)
    else:
        # star-shaped boundary: radius modulated by a random harmonic
        theta = np.arctan2(yy - cy, xx - cx)
        k = int(rng.randint(4, 8))
        phase = rng.rand() * 2 * np.pi
        wob = 1.0 + 0.35 * np.sin(k * theta + phase)
        r = np.sqrt(((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2)
        m = r <= wob.clip(0.4, 1.0)
        tex = 0.55 + 0.35 * rng.rand(h, w)  # mottled
    ys, xs = np.where(m)
    if len(ys) == 0:
        return None
    bbox = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return m, tex, bbox


def make_synthetic_btxrd(
    dst: str,
    n: int = 16,
    seed: int = 0,
    nc: int = 2,
    min_size: int = 320,
    max_size: int = 960,
    rich: bool = False,
    image_format: str = "png",
) -> Path:
    """A training-ready synthetic dataset under ``dst``: ``images/*.png``
    (``*.jpeg`` with ``image_format="jpeg"``), ``labels_det/*.txt``,
    ``masks/*.png`` and ``img_cls.csv``.

    ``rich=False``: 1-3 bright GT-aligned rectangles per image (cheap, for
    smoke tests). ``rich=True``: class-discriminative lesion shapes —
    smooth ellipses (class 0) vs irregular textured stars (class 1) over a
    vignetted noisy 'radiograph' background."""
    if image_format not in ("png", "jpeg"):
        raise ValueError(f"image_format must be 'png' or 'jpeg', got {image_format!r}")
    rng = np.random.RandomState(seed)
    root = Path(dst)
    for d in ("images", "labels_det", "masks"):
        (root / d).mkdir(parents=True, exist_ok=True)

    rows = []
    for i in range(n):
        h = int(rng.randint(min_size, max_size + 1))
        w = int(rng.randint(min_size, max_size + 1))
        cls_id = int(i % nc)
        mask = np.zeros((h, w), np.uint8)
        lines = []

        if rich:
            # vignetted, noisy background resembling a radiograph
            yy, xx = np.mgrid[0:h, 0:w]
            vig = 1.0 - 0.6 * (
                ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
            ).clip(0, 1)
            base = 40 + 60 * vig + rng.randn(h, w) * 8
            # a bright 'bone shaft' band at random angle
            ang = rng.rand() * np.pi
            d_axis = (xx - w / 2) * np.sin(ang) - (yy - h / 2) * np.cos(ang)
            base += 70 * np.exp(-(d_axis / (0.12 * min(h, w))) ** 2)
            img = base.clip(0, 255)
            for _ in range(int(rng.randint(1, 5))):
                les = _lesion(rng, h, w, cls_id)
                if les is None:
                    continue
                m, tex, (x1, y1, x2, y2) = les
                img = np.where(m, 120 + 120 * tex, img)
                mask[m] = 255
                xc, yc = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
                lines.append(
                    f"{cls_id} {xc:.6f} {yc:.6f} "
                    f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}"
                )
            img = np.repeat(img.clip(0, 255)[..., None], 3, -1).astype(np.uint8)
        else:
            img = (rng.rand(h, w, 3) * 40 + 30).astype(np.uint8)
            for _ in range(int(rng.randint(1, 4))):
                bw = int(rng.randint(w // 8, w // 3))
                bh = int(rng.randint(h // 8, h // 3))
                x1 = int(rng.randint(0, w - bw))
                y1 = int(rng.randint(0, h - bh))
                img[y1 : y1 + bh, x1 : x1 + bw] = rng.randint(170, 255)
                mask[y1 : y1 + bh, x1 : x1 + bw] = 255
                xc, yc = (x1 + bw / 2) / w, (y1 + bh / 2) / h
                lines.append(
                    f"{cls_id} {xc:.6f} {yc:.6f} {bw / w:.6f} {bh / h:.6f}"
                )

        stem = f"synth_{i:04d}"
        if image_format == "jpeg":
            write_jpeg(root / "images" / f"{stem}.jpeg", img)
        else:
            write_png(root / "images" / f"{stem}.png", img, level=1)
        (root / "labels_det" / f"{stem}.txt").write_text("\n".join(lines))
        write_png(root / "masks" / f"{stem}.png", mask, level=1)
        rows.append(f"{stem}.{image_format},{cls_id}")

    (root / "img_cls.csv").write_text("\n".join(rows) + "\n")
    return root


def make_synthetic_raw(dst: str, n: int = 8, seed: int = 0) -> Path:
    """Converter-input synthetic dataset: labelme JSONs + JPEG images + meta
    csv (the JAX function's draws, files and bytes)."""
    rng = np.random.RandomState(seed)
    root = Path(dst)
    (root / "Annotations").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(parents=True, exist_ok=True)

    meta_lines = ["image_id,tumor,benign"]
    for i in range(n):
        h, w = int(rng.randint(300, 600)), int(rng.randint(300, 600))
        stem = f"raw_{i:04d}"
        img = (rng.rand(h, w, 3) * 60 + 20).astype(np.uint8)
        write_jpeg(root / "images" / f"{stem}.jpeg", img)

        x1, y1 = int(rng.randint(0, w // 2)), int(rng.randint(0, h // 2))
        x2, y2 = x1 + int(rng.randint(30, w // 2)), y1 + int(rng.randint(30, h // 2))
        shapes = [
            {
                "label": "tumor",
                "shape_type": "rectangle",
                "points": [[x1, y1], [x2, y2]],
            },
            {
                "label": "tumor",
                "shape_type": "polygon",
                "points": [[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
            },
        ]
        ann = {"imageHeight": h, "imageWidth": w, "shapes": shapes}
        (root / "Annotations" / f"{stem}.json").write_text(json.dumps(ann))
        benign = int(i % 2 == 0)
        # every synthetic image is a tumor image; alternate benign/malignant
        meta_lines.append(f"{stem}.jpeg,1,{benign}")

    (root / "dataset.csv").write_text("\n".join(meta_lines) + "\n")
    return root
