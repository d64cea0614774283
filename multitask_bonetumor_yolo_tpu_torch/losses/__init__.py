"""The multitask loss."""

from .multitask import LossConfig, LossOutput, flatten_det_levels, multitask_loss

__all__ = ["LossConfig", "LossOutput", "flatten_det_levels", "multitask_loss"]
