"""Loss, train and validation steps, train state and optimizer."""

from posetpu_torch.train.state import (
    OptaxRMSprop,
    TrainState,
    lr_schedule,
    make_optimizer,
)
from posetpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    per_sample_stacked_mse,
    stacked_mse,
)

__all__ = [
    "OptaxRMSprop",
    "TrainState",
    "lr_schedule",
    "make_optimizer",
    "make_eval_step",
    "make_train_step",
    "per_sample_stacked_mse",
    "stacked_mse",
]
