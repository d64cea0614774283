"""Data: the BTXRD dataset and loader, synthetic data, on-device preprocessing."""

from .dataset import BTXRD, BTXRDLoader, DataConfig, DeviceEvalCache, Prefetcher, to_device
from .preprocess import AugmentConfig, augment_batch, normalize
from .synthetic import make_synthetic_btxrd, synthetic_batch

__all__ = [
    "AugmentConfig", "BTXRD", "BTXRDLoader", "DataConfig", "DeviceEvalCache", "Prefetcher",
    "augment_batch", "make_synthetic_btxrd", "normalize", "synthetic_batch", "to_device",
]
