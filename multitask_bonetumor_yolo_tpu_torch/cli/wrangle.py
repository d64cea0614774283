"""CLI: merge labelme annotations + metadata into one analysis table
(counterpart of the JAX ``cli/wrangle.py``, after the reference's
data-wrangling notebook): every labelme JSON's shapes with the metadata
sheet into ``merged_annotations.csv`` (one row per shape: image id, size,
class, shape_type, bbox / polygon geometry), and summary counts printed.

    python -m multitask_bonetumor_yolo_tpu_torch.cli.wrangle \
        --src BTXRD --meta dataset.csv --out merged_annotations.csv
"""

from __future__ import annotations

import argparse
import csv
import json
from collections import Counter
from pathlib import Path

from ..data.convert import build_type_map


def wrangle(src: str, meta: str, out: str) -> int:
    type_map = build_type_map(meta)
    rows = []
    for js_path in sorted((Path(src) / "Annotations").glob("*.json")):
        js = json.loads(js_path.read_text())
        h, w = js["imageHeight"], js["imageWidth"]
        cls_name = type_map.get(js_path.stem, "normal")
        for k, sh in enumerate(js.get("shapes", [])):
            pts = sh["points"]
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            rows.append(dict(
                image_id=js_path.stem, width=w, height=h, global_class=cls_name,
                shape_index=k, shape_type=sh["shape_type"], label=sh.get("label", ""),
                n_points=len(pts), x_min=min(xs), y_min=min(ys), x_max=max(xs), y_max=max(ys),
                points=json.dumps(pts) if sh["shape_type"] == "polygon" else "",
            ))
    if rows:
        with open(out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    by_type = Counter(r["shape_type"] for r in rows)
    by_cls = Counter(r["global_class"] for r in rows)
    print(f"[wrangle] {len(rows)} shapes -> {out}")
    print(f"[wrangle] shape types: {dict(by_type)}")
    print(f"[wrangle] classes: {dict(by_cls)}")
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="BTXRD folder with Annotations/")
    ap.add_argument("--meta", required=True, help="metadata (.csv or .xlsx)")
    ap.add_argument("--out", default="merged_annotations.csv")
    args = ap.parse_args(argv)
    return wrangle(args.src, args.meta, args.out)


if __name__ == "__main__":
    main()
