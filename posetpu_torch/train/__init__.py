"""Loss and validation step."""

from posetpu_torch.train.step import (
    make_eval_step,
    per_sample_stacked_mse,
    stacked_mse,
)

__all__ = ["make_eval_step", "per_sample_stacked_mse", "stacked_mse"]
