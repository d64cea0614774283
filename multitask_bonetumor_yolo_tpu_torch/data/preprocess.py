"""On-device preprocessing (counterpart of the JAX ``data/preprocess.py``).

The host ships uint8 letterboxed canvases; the train step normalises them on
the device. Augmentation (HSV jitter, flips, mosaic) defaults off, for parity
with the reference, and is not ported yet: an enabled ``AugmentConfig``
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX ``AugmentConfig``'s fields and defaults (all off)."""

    hsv_h: float = 0.0
    hsv_s: float = 0.0
    hsv_v: float = 0.0
    hflip_prob: float = 0.0
    mosaic_prob: float = 0.0

    @property
    def enabled(self) -> bool:
        return (self.hsv_h > 0 or self.hsv_s > 0 or self.hsv_v > 0
                or self.hflip_prob > 0 or self.mosaic_prob > 0)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 in [0, 1]."""
    return images_u8.to(torch.float32) / 255.0


def augment_batch(batch: Dict[str, torch.Tensor], generator: torch.Generator,
                  cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """The batch with its images normalised. ``generator`` will drive the
    augmentations; with ``cfg.enabled`` this raises until they are ported."""
    if cfg.enabled:
        raise NotImplementedError("HSV, flip and mosaic augmentation are not ported yet")
    return {**batch, "image": normalize(batch["image"])}
