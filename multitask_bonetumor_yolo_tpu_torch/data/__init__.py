"""Input preprocessing on the device."""

from .preprocess import AugmentConfig, augment_batch, normalize

__all__ = ["AugmentConfig", "augment_batch", "normalize"]
