"""Batched inverse-affine bilinear warp — counterpart of
``posetpu/aug/warp.py:affine_warp``.

Plain PyTorch: index arithmetic and one gather per bilinear corner.  The
reference's ``u8``/``packed32`` patch tables were layouts for the TPU's
per-row gather cost and give the same results as this form: each corner is
masked by its own coordinate against the sample's ``valid_wh``, and the
base index is clamped to [-1, H-1] x [-1, W-1] so a valid corner always
reads its exact pixel while an invalid one reads padding or a neighbour
and is zeroed by its mask.
"""

from __future__ import annotations

import torch

from posetpu_torch.aug.affine import invert_affine

_F32 = torch.float32


def affine_warp(images, t, out_res, valid_wh=None, src_index=None):
    """Warp ``images`` (B, H, W, C) by per-sample affines ``t`` (N, 3, 3)
    mapping source -> output; sampling goes through the inverse.

    valid_wh: optional (N, 2) ints (w, h), the un-padded region of each
      output's source image; samples outside it read as zero.
    src_index: optional (N,) ints, the source image of each output (N may
      exceed B).
    uint8 sources are scaled by 1/255 per corner, before the weighted sum.

    Returns (N, H_out, W_out, C) float32 with a zero border.
    """
    images = torch.as_tensor(images)
    dev = images.device
    B, H, W, C = images.shape
    Ho, Wo = out_res
    tinv = invert_affine(torch.as_tensor(t, dtype=_F32, device=dev))
    N = tinv.shape[0]

    xs = torch.arange(Wo, dtype=_F32, device=dev)[None, None, :]
    ys = torch.arange(Ho, dtype=_F32, device=dev)[None, :, None]
    sx = (
        tinv[:, 0, 0, None, None] * xs
        + tinv[:, 0, 1, None, None] * ys
        + tinv[:, 0, 2, None, None]
    )  # (N, Ho, Wo)
    sy = (
        tinv[:, 1, 0, None, None] * xs
        + tinv[:, 1, 1, None, None] * ys
        + tinv[:, 1, 2, None, None]
    )
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    fx = sx - x0f
    fy = sy - y0f
    x0 = x0f.long()
    y0 = y0f.long()

    if valid_wh is not None:
        valid_wh = torch.as_tensor(valid_wh, device=dev)
        vw = valid_wh[:, 0][:, None, None]
        vh = valid_wh[:, 1][:, None, None]
    else:
        vw, vh = W, H
    if src_index is None:
        src = torch.arange(N, device=dev)
    else:
        src = torch.as_tensor(src_index, device=dev).long()

    # one pixel of zero padding on every side: the clamped base (y0c, x0c)
    # and its three neighbours always index inside the padded image
    padded = torch.nn.functional.pad(images, (0, 0, 1, 1, 1, 1))
    Hp, Wp = H + 2, W + 2
    flat = padded.reshape(B * Hp * Wp, C)
    y0c = torch.clamp(y0, -1, H - 1) + 1
    x0c = torch.clamp(x0, -1, W - 1) + 1
    base = src[:, None, None] * (Hp * Wp) + y0c * Wp + x0c  # (N, Ho, Wo)

    def corner(offset):
        p = flat[(base + offset).reshape(-1)].reshape(N, Ho, Wo, C).to(_F32)
        if images.dtype == torch.uint8:
            p = p * (1.0 / 255.0)
        return p

    def m(yy, xx):
        return ((yy >= 0) & (yy < vh) & (xx >= 0) & (xx < vw)).to(_F32)

    wx0, wx1 = 1 - fx, fx
    wy0, wy1 = 1 - fy, fy
    w00 = m(y0, x0) * wx0 * wy0
    w01 = m(y0, x0 + 1) * wx1 * wy0
    w10 = m(y0 + 1, x0) * wx0 * wy1
    w11 = m(y0 + 1, x0 + 1) * wx1 * wy1
    return (
        w00[..., None] * corner(0)
        + w01[..., None] * corner(1)
        + w10[..., None] * corner(Wp)
        + w11[..., None] * corner(Wp + 1)
    )
