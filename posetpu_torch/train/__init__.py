"""Loss, train, validation and joint adversarial steps, K train steps per
dispatch (a CUDA graph on the card), train state and optimizer."""

from posetpu_torch.train.adversarial import (
    JointState,
    agent_from_config,
    apply_occlusion,
    make_joint_step,
)

from posetpu_torch.train.state import (
    OptaxRMSprop,
    TrainState,
    lr_schedule,
    make_optimizer,
)
from posetpu_torch.train.step import (
    make_dispatch_step,
    make_eval_step,
    make_train_body,
    make_train_step,
    per_sample_stacked_mse,
    stacked_mse,
)

__all__ = [
    "JointState",
    "agent_from_config",
    "apply_occlusion",
    "make_joint_step",
    "OptaxRMSprop",
    "TrainState",
    "lr_schedule",
    "make_optimizer",
    "make_dispatch_step",
    "make_eval_step",
    "make_train_body",
    "make_train_step",
    "per_sample_stacked_mse",
    "stacked_mse",
]
