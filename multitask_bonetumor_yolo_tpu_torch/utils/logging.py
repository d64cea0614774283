"""Run logging and image overlays (counterpart of the JAX
``utils/logging.py``).

Parity target: the W&B logging surface of the reference —
``multitask_logging.py`` (seg/det example overlays, cls metrics) and the
``train_step/ train_epoch/ val_epoch/`` scalar namespaces of
running_main_v3.py:409-427. The backend is console + JSONL
(``metrics.jsonl``) + PNG overlays under the run dir, written by the port's
own codec (``data/imageio.py::write_png``); if wandb is importable and a
project is given, scalars mirror to it with the same keys. The confusion
matrix heatmap needs matplotlib and is skipped without it.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..data.imageio import write_png


def _try_wandb(project: Optional[str]):
    if not project:
        return None
    try:  # pragma: no cover - wandb is not installed where the tests run
        import wandb

        return wandb.init(project=project)
    except Exception:
        return None


class RunLogger:
    """The run's scalars and overlays. ``enabled=False`` (the ranks other
    than 0 of a data-parallel run, which rank 0 speaks for) writes, prints
    and opens nothing."""

    def __init__(
        self,
        run_dir: str,
        wandb_project: Optional[str] = None,
        print_every: int = 10,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.dir = Path(run_dir)
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "media").mkdir(exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self._wandb = _try_wandb(wandb_project)
        self.print_every = print_every
        self._t0 = time.time()

    def log(self, metrics: Mapping[str, float], step: int, prefix: str = "",
            to_console: bool = False) -> None:
        if not self.enabled:
            return
        payload = {
            (f"{prefix}/{k}" if prefix else k): _to_float(v)
            for k, v in metrics.items()
        }
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **payload}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(payload, step=step)
        if to_console:
            brief = " ".join(
                f"{k.split('/')[-1]}={v:.4g}"
                for k, v in payload.items()
                if isinstance(v, float)
            )
            print(f"[step {step}] {brief}", flush=True)

    # ---------------------------------------------------------- overlays
    def log_seg_examples(
        self,
        images: np.ndarray,  # [B,H,W,3] float 0..1 or uint8
        seg_prob: np.ndarray,  # [B,H,W,1]
        masks_gt: Optional[np.ndarray],
        stage: str,
        step: int,
        max_samples: int = 4,
        threshold: float = 0.5,
    ) -> Sequence[Path]:
        """Red = prediction, green = GT (mirrors multitask_logging.py:80-132)."""
        paths = []
        if not self.enabled:
            return paths
        n = min(len(images), max_samples)
        for i in range(n):
            img = _to_uint8(images[i]).astype(np.float32)
            pred = np.asarray(seg_prob[i, ..., 0]) > threshold
            img[pred] = img[pred] * 0.5 + np.asarray([255, 0, 0]) * 0.5
            if masks_gt is not None:
                gt = np.asarray(masks_gt[i, ..., 0]) > 0.5
                img[gt] = img[gt] * 0.5 + np.asarray([0, 255, 0]) * 0.5
            p = self.dir / "media" / f"seg_{stage}_{step}_{i}.png"
            write_png(p, img.astype(np.uint8))
            paths.append(p)
        return paths

    def log_det_examples(
        self,
        images: np.ndarray,
        boxes: np.ndarray,  # [B,K,4] xyxy abs
        scores: np.ndarray,  # [B,K]
        labels: np.ndarray,  # [B,K]
        valid: np.ndarray,  # [B,K]
        gt_boxes: Optional[np.ndarray],  # [B,M,5] (cls,cx,cy,w,h) norm
        gt_valid: Optional[np.ndarray],
        stage: str,
        step: int,
        conf_th: float = 0.25,
        max_samples: int = 4,
    ) -> Sequence[Path]:
        """White = prediction (above conf_th), green = GT
        (mirrors multitask_logging.py:173-256)."""
        paths = []
        if not self.enabled:
            return paths
        n = min(len(images), max_samples)
        for i in range(n):
            img = _to_uint8(images[i]).copy()
            S = img.shape[0]
            for k in range(boxes.shape[1]):
                if not valid[i, k] or scores[i, k] <= conf_th:
                    continue
                _draw_rect(img, boxes[i, k], (255, 255, 255))
            if gt_boxes is not None and gt_valid is not None:
                for m in range(gt_boxes.shape[1]):
                    if not gt_valid[i, m]:
                        continue
                    c, xc, yc, w, h = gt_boxes[i, m]
                    xy = np.asarray(
                        [(xc - w / 2) * S, (yc - h / 2) * S,
                         (xc + w / 2) * S, (yc + h / 2) * S]
                    )
                    _draw_rect(img, xy, (0, 255, 0))
            p = self.dir / "media" / f"det_{stage}_{step}_{i}.png"
            write_png(p, img)
            paths.append(p)
        return paths

    def log_confusion_matrix(
        self, cm: np.ndarray, class_names: Dict[int, str], name: str, step: int
    ) -> Optional[Path]:
        """Heatmap PNG via matplotlib (mirrors
        plot_confusion_matrix_to_wandb, running_main_v3.py:113-144)."""
        if not self.enabled:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return None
        labels = [class_names.get(i, str(i)) for i in range(cm.shape[0])]
        fig, ax = plt.subplots(figsize=(max(4, len(labels)), max(3, len(labels) * 0.8)))
        im = ax.imshow(cm, cmap="Blues", vmin=0)
        for (r, c), v in np.ndenumerate(cm):
            ax.text(c, r, f"{v:.2f}", ha="center", va="center", fontsize=8)
        ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
        ax.set_yticks(range(len(labels)), labels)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        fig.colorbar(im)
        fig.tight_layout()
        p = self.dir / "media" / f"{name}_{step}.png"
        fig.savefig(p)
        plt.close(fig)
        return p

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if img.min() < -1e-5:  # [-1, 1] convention
        img = (img + 1) / 2
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _draw_rect(img: np.ndarray, xyxy, color, thickness: int = 2) -> None:
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(np.clip(v, 0, lim - 1)) for v, lim in
                      zip(xyxy, (w, h, w, h)))
    t = thickness
    img[y1 : y1 + t, x1 : x2 + 1] = color
    img[max(y2 - t + 1, 0) : y2 + 1, x1 : x2 + 1] = color
    img[y1 : y2 + 1, x1 : x1 + t] = color
    img[y1 : y2 + 1, max(x2 - t + 1, 0) : x2 + 1] = color
