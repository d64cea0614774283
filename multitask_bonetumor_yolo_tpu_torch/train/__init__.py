"""Training and evaluation: state, optimizer, the train and eval steps,
checkpoints."""

from .checkpoint import CheckpointManager
from .state import TrainConfig, TrainState, create_train_state, lr_at
from .steps import make_eval_step, make_train_step

__all__ = ["CheckpointManager", "TrainConfig", "TrainState", "create_train_state", "lr_at",
           "make_eval_step", "make_train_step"]
