"""Model modules: ConvNeXt-Tiny + BiFPN trunk and the multitask heads."""

from .model import ModelConfig, MultitaskModel, build_model, init_parameters

__all__ = ["ModelConfig", "MultitaskModel", "build_model", "init_parameters"]
