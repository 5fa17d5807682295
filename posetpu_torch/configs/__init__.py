"""Configuration dataclasses and named configs."""

from posetpu_torch.configs.config import (
    NAMED_CONFIGS,
    AgentConfig,
    AugConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    add_overrides,
    apply_overrides,
    named_config,
)

__all__ = [
    "NAMED_CONFIGS",
    "AgentConfig",
    "AugConfig",
    "ExperimentConfig",
    "ModelConfig",
    "OptimConfig",
    "add_overrides",
    "apply_overrides",
    "named_config",
]
