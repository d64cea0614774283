"""Offline converter: labelme annotations + metadata -> training-ready dir
(counterpart of the JAX ``data/convert.py``, whose messages, files and rules
it keeps).

  input   SRC/Annotations/*.json (labelme), SRC/images/*.jpeg, metadata table
          with columns (image_id, tumor, benign)
  output  DST/images/*.jpeg (hardlinks), DST/labels_det/*.txt (YOLO rows),
          DST/masks/*.png, DST/img_cls.csv (filename,class_id)
          (+ DST/labels_seg/*.txt YOLO-seg polygon rows with
          ``--emit-seg-polygons``)

Class taxonomy: benign -> "B-tumor" (0), tumor-not-benign -> "M-tumor" (1),
else "normal", which is skipped with a message. Masks are written with value
255 by the port's PNG codec. Metadata: .xlsx through the port's stdlib reader
(``utils/xlsx.py``), or a .csv/.tsv with the same columns.

The JAX converter rasterises polygons with ``cv2.fillPoly``; the card's
machine has no cv2, so :func:`polygon_to_mask` computes what ``cv2.fillPoly``
computes (OpenCV's ``CollectPolyEdges`` with its 8-connected outline, then
``FillEdgeCollection``), not what the JAX package's numpy fallback computes.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..utils.xlsx import read_xlsx_dicts
from .imageio import write_png

CLS2ID = {"B-tumor": 0, "M-tumor": 1}
BOX2ID = {"B-tumor": 0, "M-tumor": 1}
MASK_FOREGROUND = 255
XY_SHIFT = 16  # OpenCV drawing's fixed point
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` (Cohen-Sutherland, each end moved in double and
    truncated): (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y, full=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if full else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's ``Line`` at ``LINE_8``: the 8-connected Bresenham line of
    ``LineIterator`` (clipped to the image, drawn left to right)."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


def fill_poly(mask: np.ndarray, pts: np.ndarray) -> None:
    """``cv2.fillPoly(mask, [pts], 1)`` for one int32 polygon ``pts [n, 2]``
    (shift 0, ``LINE_8``): OpenCV's ``CollectPolyEdges`` draws each edge's
    8-connected line and keeps its 16.16 fixed-point edge (the x of the
    clipped line where an end lies outside the image), then
    ``FillEdgeCollection`` fills, on each row, from the first to the second
    active edge, the third to the fourth, ... (x >> 16, both ends)."""
    h, w = mask.shape
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    edges = []
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        p0x, p1x = int(x0) << XY_SHIFT, int(x1) << XY_SHIFT
        p0y, p1y = int(y0), int(y1)
        t0x, t1x = (p0x + XY_ONE // 2) >> XY_SHIFT, (p1x + XY_ONE // 2) >> XY_SHIFT
        _line8(mask, t0x, p0y, t1x, p1y)
        c0x, c0y, c1x, c1y = p0x, p0y, p1x, p1y
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= p0y < h and 0 <= p1y < h):
            _, a0x, a0y, a1x, a1y = _clip_line(w, h, t0x, p0y, t1x, p1y)
            c0x, c1x = a0x << XY_SHIFT, a1x << XY_SHIFT
            if a0y != a1y:
                c0y, c1y = a0y, a1y
        if p0y == p1y:
            continue
        num, den = c1x - c0x, c1y - c0y
        dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)  # C division
        if p0y < p1y:
            edges.append((p0y, p1y, c0x + (p0y - c0y) * dx, dx))
        else:
            edges.append((p1y, p0y, c1x + (p1y - c1y) * dx, dx))
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    for y in range(max(int(ey0.min()), 0), min(int(ey1.max()), h)):
        act = (ey0 <= y) & (y < ey1)
        xs = np.sort(ex[act] + (y - ey0[act]) * edx[act])
        for a, b in zip((xs[0::2] + XY_ONE - 1) >> XY_SHIFT, xs[1::2] >> XY_SHIFT):
            if a < w and b >= 0:
                mask[y, max(int(a), 0):min(int(b), w - 1) + 1] = 1


def polygon_to_mask(points, h: int, w: int) -> np.ndarray:
    """One polygon as a binary uint8 mask, as the JAX converter's
    ``cv2.fillPoly(mask, [np.asarray(points, np.int32)], 1)`` makes it (the
    points truncated to int32 the same way)."""
    mask = np.zeros((h, w), np.uint8)
    fill_poly(mask, np.asarray(points, np.int32))
    return mask


def build_type_map(meta_path: str) -> Dict[str, str]:
    """(image_id, tumor, benign) table -> {stem: B-tumor|M-tumor|normal}
    (reference label_parsing.py:77-83)."""
    p = Path(meta_path)
    if p.suffix.lower() in (".csv", ".tsv"):
        mapping = {}
        with open(p, newline="") as f:
            reader = csv.DictReader(f, delimiter="\t" if p.suffix == ".tsv" else ",")
            for row in reader:
                stem = Path(str(row["image_id"])).stem
                tumor = str(row["tumor"]).strip() in ("1", "True", "true")
                benign = str(row["benign"]).strip() in ("1", "True", "true")
                mapping[stem] = "B-tumor" if benign else ("M-tumor" if tumor else "normal")
        return mapping

    def truthy(v) -> bool:
        if isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes")
        return bool(v)

    return {
        Path(str(row["image_id"])).stem: (
            "B-tumor" if truthy(row["benign"])
            else ("M-tumor" if truthy(row["tumor"]) else "normal")
        )
        for row in read_xlsx_dicts(p)
    }


def process_one(json_path: Path, out_det: Path, out_mask: Path, global_cls: str,
                out_seg: Path | None = None) -> int:
    """One labelme file -> det txt + mask png (+ optional YOLO-seg polygon
    txt). Returns the image class id. Every shape takes the image-level
    class; polygons rasterise into one union mask, rectangles become YOLO
    rows (reference label_parsing.py:39-66, the -v1 variant's seg rows)."""
    js = json.loads(json_path.read_text())
    h, w = js["imageHeight"], js["imageWidth"]
    full_mask = np.zeros((h, w), np.uint8)
    det_lines: List[str] = []
    seg_lines: List[str] = []

    for sh in js.get("shapes", []):
        lbl = global_cls
        if sh["shape_type"] == "polygon" and lbl in CLS2ID:
            full_mask = np.maximum(full_mask, polygon_to_mask(sh["points"], h, w))
            if out_seg is not None:
                coords = " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in sh["points"])
                seg_lines.append(f"{CLS2ID[lbl]} {coords}")
        elif sh["shape_type"] == "rectangle" and lbl in BOX2ID:
            (x1, y1), (x2, y2) = sh["points"]
            xc, yc = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = abs(x2 - x1) / w, abs(y2 - y1) / h
            det_lines.append(f"{BOX2ID[lbl]} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f}")

    (out_det / f"{json_path.stem}.txt").write_text("\n".join(det_lines))
    if out_seg is not None:
        (out_seg / f"{json_path.stem}.txt").write_text("\n".join(seg_lines))
    write_png(out_mask / f"{json_path.stem}.png", full_mask * MASK_FOREGROUND)
    return CLS2ID[global_cls]


def convert(src: str, meta: str, dst: str, img_ext: str = ".jpeg",
            emit_seg_polygons: bool = False) -> int:
    """Returns the number of converted annotations."""
    src_p, dst_p = Path(src), Path(dst)
    dirs = ["labels_det", "masks", "images"]
    if emit_seg_polygons:
        dirs.append("labels_seg")
    for d in dirs:
        (dst_p / d).mkdir(parents=True, exist_ok=True)

    type_map = build_type_map(meta)
    rows: List[List] = []
    json_files = sorted((src_p / "Annotations").glob("*.json"))
    skipped = 0
    for js in json_files:
        cls_name = type_map.get(js.stem, "normal")
        if cls_name not in CLS2ID:
            skipped += 1
            continue
        class_id = process_one(
            js, dst_p / "labels_det", dst_p / "masks", cls_name,
            out_seg=(dst_p / "labels_seg") if emit_seg_polygons else None,
        )
        img_src = src_p / "images" / f"{js.stem}{img_ext}"
        img_dst = dst_p / "images" / img_src.name
        if img_src.exists() and not img_dst.exists():
            try:
                os.link(img_src, img_dst)
            except OSError:
                shutil.copy2(img_src, img_dst)
        rows.append([img_dst.name, class_id])

    with open(dst_p / "img_cls.csv", "w", newline="") as f:
        for r in rows:
            f.write(f"{r[0]},{r[1]}\n")
    if skipped:
        print(f"[convert] Skipped {skipped} 'normal' (tumor-free) annotations.")
    print(f"[convert] Converted {len(rows)}/{len(json_files)} annotations -> {dst}")
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="BTXRD folder (with Annotations/, images/)")
    ap.add_argument("--meta", required=True, help="dataset metadata (.csv or .xlsx)")
    ap.add_argument("--dst", default="btxrd_ready", help="output dir")
    ap.add_argument("--img-ext", default=".jpeg", help="image extension")
    ap.add_argument(
        "--emit-seg-polygons", action="store_true",
        help="also write YOLO-seg polygon txt rows (label_parsing-v1 variant)",
    )
    args = ap.parse_args(argv)
    convert(args.src, args.meta, args.dst, args.img_ext, args.emit_seg_polygons)


if __name__ == "__main__":
    main()
