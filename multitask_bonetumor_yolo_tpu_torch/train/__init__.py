"""Training: state, optimizer and the train step."""

from .state import TrainConfig, TrainState, create_train_state, lr_at
from .steps import make_train_step

__all__ = ["TrainConfig", "TrainState", "create_train_state", "lr_at", "make_train_step"]
