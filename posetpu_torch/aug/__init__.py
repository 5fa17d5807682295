"""Augmentation ops: geometry, warp, color, targets, the keyed samplers and
the batch pipeline."""

from posetpu_torch.aug.affine import (
    compose_affine,
    invert_affine,
    make_transform,
    transform_points,
    transform_points_int_float,
)
from posetpu_torch.aug.color import (
    color_jitter,
    color_normalize,
    sample_jitter_scales,
)
from posetpu_torch.aug.heatmap import (
    rasterize_gaussians,
    rasterize_gaussians_plain,
    window_inside,
)
from posetpu_torch.aug.pipeline import (
    FLIP_PAIRS,
    AugParams,
    augment_batch,
    flip_permutation,
    neutral_params,
    sample_aug_params_ps,
)
from posetpu_torch.aug.warp import affine_warp

__all__ = [
    "compose_affine",
    "invert_affine",
    "make_transform",
    "transform_points",
    "transform_points_int_float",
    "color_jitter",
    "color_normalize",
    "sample_jitter_scales",
    "rasterize_gaussians",
    "rasterize_gaussians_plain",
    "window_inside",
    "FLIP_PAIRS",
    "AugParams",
    "augment_batch",
    "flip_permutation",
    "neutral_params",
    "sample_aug_params_ps",
    "affine_warp",
]
