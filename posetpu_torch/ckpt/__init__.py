"""Checkpoints of a run, and the weight carry from the JAX package."""

from posetpu_torch.ckpt.manager import CheckpointManager
from posetpu_torch.ckpt.transplant import (
    from_flax_agent_variables,
    from_flax_variables,
    from_optax_agent_state,
    from_optax_state,
    to_flax_variables,
)

__all__ = [
    "CheckpointManager",
    "from_flax_agent_variables",
    "from_flax_variables",
    "from_optax_agent_state",
    "from_optax_state",
    "to_flax_variables",
]
