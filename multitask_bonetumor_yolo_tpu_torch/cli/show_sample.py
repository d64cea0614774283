"""CLI: render one dataset sample's GT boxes + mask to a PNG (counterpart of
the JAX ``cli/show_sample.py``, after the reference's visual inspection
script): any split / index, the mask blended green, the boxes white.

    python -m multitask_bonetumor_yolo_tpu_torch.cli.show_sample \
        --root btxrd_ready --split val --index 0 --out sample.png

``--device`` (default ``cuda``) decodes a JPEG sample on the card; without
one it raises unless given ``cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import BTXRD, DataConfig
from ..data.imageio import write_png
from ..utils.logging import _draw_rect


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="btxrd_ready")
    ap.add_argument("--split", default="val")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--out", default="sample.png")
    ap.add_argument("--device", default="cuda",
                    help="where a JPEG is decoded (default cuda; 'cpu' to run without a card)")
    args = ap.parse_args(argv)

    ds = BTXRD(DataConfig(root=args.root, img_size=args.img_size), args.split,
               device=args.device)
    if args.index >= len(ds):
        raise SystemExit(
            f"index {args.index} out of bounds for split '{args.split}' "
            f"({len(ds)} items)"
        )
    it = ds[args.index]
    img = it["image"].copy()
    S = img.shape[0]
    gt = it["mask"][..., 0] > 0.5
    img = img.astype(np.float32)
    img[gt] = img[gt] * 0.6 + np.asarray([0, 255, 0]) * 0.4
    img = img.astype(np.uint8)
    n = 0
    for row, ok in zip(it["boxes"], it["box_valid"]):
        if not ok:
            continue
        c, xc, yc, w, h = row
        _draw_rect(
            img,
            [(xc - w / 2) * S, (yc - h / 2) * S, (xc + w / 2) * S, (yc + h / 2) * S],
            (255, 255, 255),
        )
        n += 1
    write_png(args.out, img)
    print(
        f"[show_sample] id={int(it['id'])} class={int(it['img_cls'])} "
        f"{n} box(es), mask_frac={float(gt.mean()):.4f} -> {args.out}"
    )


if __name__ == "__main__":
    main()
