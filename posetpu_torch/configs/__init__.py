"""Configuration dataclasses and named configs."""

from posetpu_torch.configs.config import (
    NAMED_CONFIGS,
    AdamWConfig,
    AgentConfig,
    AugConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ViTConfig,
    add_overrides,
    apply_overrides,
    named_config,
)

__all__ = [
    "NAMED_CONFIGS",
    "AdamWConfig",
    "AgentConfig",
    "AugConfig",
    "ExperimentConfig",
    "ModelConfig",
    "OptimConfig",
    "ViTConfig",
    "add_overrides",
    "apply_overrides",
    "named_config",
]
