"""Pure tensor math: boxes, anchors, DFL decode, letterbox geometry."""

from .anchors import make_anchors, level_shapes, num_anchors
from .boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    box_iou_matrix,
    box_iou_pairwise,
    dist2bbox,
    bbox2dist,
)
from .dfl import dfl_decode, dfl_targets
from .letterbox import letterbox_geometry, scale_boxes_to_letterbox, PAD_VALUE

__all__ = [
    "make_anchors",
    "level_shapes",
    "num_anchors",
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_iou_matrix",
    "box_iou_pairwise",
    "dist2bbox",
    "bbox2dist",
    "dfl_decode",
    "dfl_targets",
    "letterbox_geometry",
    "scale_boxes_to_letterbox",
    "PAD_VALUE",
]
