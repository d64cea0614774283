"""Letterbox geometry (top-left aligned, as the reference dataset does).

A copy of ``multitask_bonetumor_yolo_tpu/core/letterbox.py`` (numpy only):
importing it from the JAX package would import jax through its
``core/__init__.py``.

Reference: dataset_btxrdv2.py:109-134 — scale = S / max(H0, W0), resize to
(new_h, new_w) with at-least-1-px floors, pad bottom/right with gray 114
(mask padded with 0), no top/left padding.
Box handling: dataset_btxrdv2.py:168-248 — scale the original-pixel xyxy box,
drop boxes under 1 px in the scaled space, normalise by img_size, clip to
[0, 1], and drop boxes whose clipped w/h fall below 1/img_size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_VALUE = 114  # gray padding for images; masks pad with 0


def letterbox_geometry(h0: int, w0: int, img_size: int) -> Tuple[float, int, int]:
    """Returns (scale, new_h, new_w) for a top-left letterbox into img_size²."""
    scale = img_size / max(h0, w0)
    new_w = max(1, int(w0 * scale))
    new_h = max(1, int(h0 * scale))
    return scale, new_h, new_w


def scale_boxes_to_letterbox(
    boxes_yolo: np.ndarray, h0: int, w0: int, img_size: int
) -> np.ndarray:
    """YOLO-normalised (cls, xc, yc, w, h) rows on the ORIGINAL image ->
    (cls, xc, yc, w, h) rows normalised to the LETTERBOXED img_size² canvas,
    with the reference's sub-pixel drops and clipping.

    boxes_yolo: (N, 5) float array. Returns (M, 5) with M <= N.
    """
    if boxes_yolo.size == 0:
        return np.zeros((0, 5), dtype=np.float32)
    scale, _, _ = letterbox_geometry(h0, w0, img_size)
    out = []
    min_norm = 1.0 / img_size
    for row in boxes_yolo:
        cls, xc, yc, w, h = (float(v) for v in row[:5])
        if w <= 0 or h <= 0:
            continue
        # original-pixel xyxy
        x1 = (xc - w / 2) * w0 * scale
        y1 = (yc - h / 2) * h0 * scale
        x2 = (xc + w / 2) * w0 * scale
        y2 = (yc + h / 2) * h0 * scale
        if (x2 - x1) < 1.0 or (y2 - y1) < 1.0:
            continue
        # normalise to canvas and clip (top-left pad => no offset to add)
        x1n = np.clip(x1 / img_size, 0.0, 1.0)
        y1n = np.clip(y1 / img_size, 0.0, 1.0)
        x2n = np.clip(x2 / img_size, 0.0, 1.0)
        y2n = np.clip(y2 / img_size, 0.0, 1.0)
        wn, hn = x2n - x1n, y2n - y1n
        if wn < min_norm or hn < min_norm:
            continue
        out.append([cls, (x1n + x2n) / 2, (y1n + y2n) / 2, wn, hn])
    if not out:
        return np.zeros((0, 5), dtype=np.float32)
    return np.asarray(out, dtype=np.float32)
