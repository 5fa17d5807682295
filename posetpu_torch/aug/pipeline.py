"""Batch augmentation — counterpart of ``posetpu/aug/pipeline.py``:
(flip, scale, rot) affine -> bilinear warp -> color jitter/normalize ->
keypoint transform -> Gaussian targets.

The flip is a coordinate mirror composed into the affine (no array
reversal): flipping a padded image and cropping it equals cropping the
original through the mirrored affine.  :func:`sample_aug_params_ps` draws
the training parameters from keys of (seed, step, global sample index)
(:mod:`posetpu_torch.aug.keyed`); tests may pass in the reference's draws
instead.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from posetpu_torch.aug.affine import (
    compose_affine,
    make_transform,
    transform_points_int_float,
)
from posetpu_torch.aug.color import color_jitter, color_normalize
from posetpu_torch.aug.heatmap import rasterize_gaussians
from posetpu_torch.aug.keyed import (
    STREAM_AUG,
    bits_to_normal64,
    bits_to_uniform,
    keyed_bits,
)
from posetpu_torch.aug.warp import affine_warp
from posetpu_torch.utils.device import resolve_device

_F32 = torch.float32

# Left/right joint index swaps per dataset (reference ``shufflelr``
# matchedParts); the port's copy of posetpu.oracles.transforms.FLIP_PAIRS.
FLIP_PAIRS = {
    "mpii": ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)),
    "lsp": ((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9)),
}


class AugParams(NamedTuple):
    """Per-sample augmentation parameters, all (B,) tensors."""

    scale_factor: torch.Tensor  # multiplicative on person scale
    rot: torch.Tensor  # degrees
    flip: torch.Tensor  # bool


@functools.lru_cache(maxsize=None)
def flip_permutation(num_joints, dataset="mpii", device="cuda"):
    """Joint index permutation for a horizontal flip, on ``device``.
    Cached per device (callers only read it): its host-to-device copy
    would otherwise sync the stream on every batch."""
    perm = list(range(num_joints))
    for a, b in FLIP_PAIRS[dataset]:
        perm[a], perm[b] = perm[b], perm[a]
    return torch.tensor(perm, dtype=torch.long, device=resolve_device(device))


def sample_aug_params_ps(
    seed,
    step,
    index,
    scale_factor=0.25,
    rot_factor=30.0,
    rot_prob=0.6,
    flip_prob=0.5,
    scale_mode="exp",
):
    """The reference's random augmentation distribution, one draw per
    global sample ``index`` (B,) at training ``step``, on ``index``'s
    device (counterpart of the JAX package's ``sample_aug_params_ps``).

    scale_mode "exp": s *= 2^clip(N(0,1)*sf, -2sf, 2sf)  (hourglass lineage)
    scale_mode "linear": s *= clip(N(0,1)*sf + 1, 1-sf, 1+sf)
    rot: clip(N(0,1)*rf, -2rf, 2rf), zeroed with prob (1 - rot_prob).
    flip with prob flip_prob.
    """
    if scale_mode not in ("exp", "linear"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    bits = keyed_bits(seed, step, index, STREAM_AUG, 6)
    ns = bits_to_normal64(bits[:, 0], bits[:, 1])
    nr = bits_to_normal64(bits[:, 2], bits[:, 3])
    sf, rf = float(scale_factor), float(rot_factor)
    if scale_mode == "exp":
        scale = torch.exp2(torch.clamp(ns * sf, -2 * sf, 2 * sf))
    else:
        scale = torch.clamp(ns * sf + 1.0, 1.0 - sf, 1.0 + sf)
    rot = torch.clamp(nr * rf, -2 * rf, 2 * rf)
    rot = torch.where(bits_to_uniform(bits[:, 4]) <= rot_prob, rot, 0.0)
    return AugParams(
        scale_factor=scale.to(_F32),
        rot=rot.to(_F32),
        flip=bits_to_uniform(bits[:, 5]) < flip_prob,
    )


def neutral_params(batch, device="cuda"):
    """Identity augmentation (validation, and the neutral crop)."""
    device = resolve_device(device)
    return AugParams(
        scale_factor=torch.ones((batch,), dtype=_F32, device=device),
        rot=torch.zeros((batch,), dtype=_F32, device=device),
        flip=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _mirror_matrix(width):
    """(B, 3, 3) source-coordinate mirror x -> (w-1) - x for (B,) widths
    (0-indexed; identical to an array fliplr of the valid region)."""
    zeros = torch.zeros_like(width)
    ones = torch.ones_like(width)
    return torch.stack(
        [
            torch.stack([-ones, zeros, width - 1.0], dim=-1),
            torch.stack([zeros, ones, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=1,
    )


def augment_batch(
    images,
    valid_wh,
    center,
    scale,
    pts,
    vis,
    params: AugParams,
    *,
    inp_res=(256, 256),
    out_res=(64, 64),
    sigma=1.0,
    mean=(0.0, 0.0, 0.0),
    std=None,
    dataset="mpii",
    jitter_scales=None,
    src_index=None,
    device="cuda",
):
    """Augment one batch on ``device`` (default CUDA; raises without it
    unless ``device="cpu"``).  Inputs may be numpy or tensors on any
    device; they move there.

    images (B, Hp, Wp, 3) uint8 or float in [0, 1], zero-padded; valid_wh
    (B, 2) true (w, h); center (B, 2); scale (B,); pts (B, K, 2) 1-indexed
    source keypoints; vis (B, K); params per-sample AugParams;
    jitter_scales (B, 3) or None for no jitter; src_index (N,) maps each
    output crop to a source image (metadata is then length N).

    Returns a dict: input (B, *inp_res, 3) normalized; target (B, K,
    *out_res); target_weight (B, K); tpts (B, K, 2) 1-indexed truncated
    heatmap coords; tpts_float (B, K, 2) the same untruncated; center;
    scale.
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)

    def f32(x):
        return torch.as_tensor(x, dtype=_F32, device=dev)

    valid_wh = torch.as_tensor(valid_wh, device=dev)
    center, scale, pts, vis = f32(center), f32(scale), f32(pts), f32(vis)
    B, K = pts.shape[:2]
    w = valid_wh[:, 0].to(_F32)

    # flip: mirror center/pts + joint swap (reference fliplr/shufflelr)
    flip = torch.as_tensor(params.flip, dtype=torch.bool, device=dev)
    perm = flip_permutation(K, dataset, dev)
    c_x = torch.where(flip, w - center[:, 0], center[:, 0])
    center_f = torch.stack([c_x, center[:, 1]], dim=-1)
    pts_sw = pts[:, perm, :]
    vis_sw = vis[:, perm]
    pts_mx = torch.stack([w[:, None] - pts_sw[..., 0], pts_sw[..., 1]], dim=-1)
    pts_f = torch.where(flip[:, None, None], pts_mx, pts)
    vis_f = torch.where(flip[:, None], vis_sw, vis)

    s_aug = scale * f32(params.scale_factor)
    rot = f32(params.rot)

    # image warp, mirror composed into the affine
    t_img = make_transform(center_f, s_aug, inp_res, rot)
    t_eff = torch.where(
        flip[:, None, None], compose_affine(t_img, _mirror_matrix(w)), t_img
    )
    if src_index is not None:
        src_index = torch.as_tensor(src_index, device=dev)
    inp = affine_warp(
        images, t_eff, inp_res, valid_wh=valid_wh, src_index=src_index
    )
    # jitter runs on the warped crop, as in the reference package
    if jitter_scales is not None:
        inp = color_jitter(inp, torch.as_tensor(jitter_scales, device=dev))
    inp = color_normalize(inp, mean, std)

    # targets: the ints come from the raw 0-indexed map (see
    # transform_points_int_float)
    t_out = make_transform(center_f, s_aug, out_res, rot)
    tpts, tpts_float = transform_points_int_float(pts_f, t_out)
    target, target_weight = rasterize_gaussians(
        tpts - 1.0, vis_f, out_res, sigma=sigma
    )
    return {
        "input": inp,
        "target": target,
        "target_weight": target_weight,
        "tpts": tpts,
        "tpts_float": tpts_float,
        "center": center_f,
        "scale": s_aug,
    }
