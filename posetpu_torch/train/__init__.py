"""Loss, train, validation and joint adversarial steps, K train or joint
steps per dispatch (a CUDA graph on the card), train state and optimizer."""

from posetpu_torch.train.adversarial import (
    JointCounters,
    JointState,
    agent_from_config,
    apply_occlusion,
    make_joint_body,
    make_joint_dispatch_step,
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
    "JointCounters",
    "JointState",
    "agent_from_config",
    "apply_occlusion",
    "make_joint_body",
    "make_joint_dispatch_step",
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
