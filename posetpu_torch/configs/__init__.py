"""Configuration dataclasses and named configs."""

from posetpu_torch.configs.config import (
    NAMED_CONFIGS,
    AugConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    named_config,
)

__all__ = [
    "NAMED_CONFIGS",
    "AugConfig",
    "ExperimentConfig",
    "ModelConfig",
    "OptimConfig",
    "named_config",
]
