"""Tensor ops: resize, NMS, mask composition, the Proto phase composition,
and (under ``kernels/``) the hand-written CUDA kernels with their plain
PyTorch versions."""

from .resize import resize_bilinear, resize_nearest
from .nms import NMSResult, batched_nms, postprocess_detections
from .masks import compose_masks
from .fused_upsample import fused_upsample_conv3x3

__all__ = [
    "resize_bilinear",
    "resize_nearest",
    "NMSResult",
    "batched_nms",
    "postprocess_detections",
    "compose_masks",
    "fused_upsample_conv3x3",
]
