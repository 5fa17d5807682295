"""Batched affine construction — counterpart of ``posetpu/aug/affine.py``.

Every product is written out in closed form in float32, with no matmul:
the geometry has to match the reference to the last ulp, and a 3x3 matmul
may run at reduced precision on an accelerator (TF32 on Hopper, bf16 on a
TPU) or sum in another order.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _stack33(r0, r1):
    """(B,) entries of the first two rows -> (B, 3, 3) with last row 0 0 1."""
    zeros = torch.zeros_like(r0[0])
    ones = torch.ones_like(r0[0])
    return torch.stack(
        [
            torch.stack(r0, dim=-1),
            torch.stack(r1, dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=1,
    )


def make_transform(center, scale, res, rot_deg):
    """Batched 3x3 affine: source coords -> output-crop coords.

    center (B, 2) person centers (x, y); scale (B,) with box side
    ``200*scale`` source pixels; res static (H, W); rot_deg (B,) degrees.
    Returns (B, 3, 3) float32 on the device of ``center``.
    """
    center = torch.as_tensor(center, dtype=_F32)
    scale = torch.as_tensor(scale, dtype=_F32, device=center.device)
    rot_deg = torch.as_tensor(rot_deg, dtype=_F32, device=center.device)
    h = 200.0 * scale

    # ``int / tensor`` would be reciprocal-then-multiply (two roundings);
    # the reference divides once
    sx = torch.full_like(h, res[1]) / h
    sy = torch.full_like(h, res[0]) / h
    tx = res[1] * (-center[:, 0] / h + 0.5)
    ty = res[0] * (-center[:, 1] / h + 0.5)

    # T(+half) @ R @ T(-half) @ S expanded in closed form; at rot == 0 the
    # rotation is the identity, so it is always applied
    rot_rad = -rot_deg * (math.pi / 180.0)
    # sin/cos of the f32 angle in float64, rounded once: the f32 libraries
    # of the CPU and the GPU (and XLA's) each miss the correctly rounded
    # value by an ulp on a few percent of angles, and one ulp of cos moves a
    # sampling coordinate near 100 px by 1e-5 px
    rot64 = rot_rad.double()
    sn, cs = torch.sin(rot64).float(), torch.cos(rot64).float()
    hw = res[1] / 2.0
    hh = res[0] / 2.0

    a00 = cs * sx
    a01 = -sn * sy
    a02 = cs * (tx - hw) - sn * (ty - hh) + hw
    a10 = sn * sx
    a11 = cs * sy
    a12 = sn * (tx - hw) + cs * (ty - hh) + hh
    return _stack33([a00, a01, a02], [a10, a11, a12])


def compose_affine(a, b):
    """Closed-form product ``a @ b`` of batched (B, 3, 3) affines."""
    r00 = a[:, 0, 0] * b[:, 0, 0] + a[:, 0, 1] * b[:, 1, 0]
    r01 = a[:, 0, 0] * b[:, 0, 1] + a[:, 0, 1] * b[:, 1, 1]
    r02 = a[:, 0, 0] * b[:, 0, 2] + a[:, 0, 1] * b[:, 1, 2] + a[:, 0, 2]
    r10 = a[:, 1, 0] * b[:, 0, 0] + a[:, 1, 1] * b[:, 1, 0]
    r11 = a[:, 1, 0] * b[:, 0, 1] + a[:, 1, 1] * b[:, 1, 1]
    r12 = a[:, 1, 0] * b[:, 0, 2] + a[:, 1, 1] * b[:, 1, 2] + a[:, 1, 2]
    return _stack33([r00, r01, r02], [r10, r11, r12])


def invert_affine(t):
    """Closed-form inverse of batched (B, 3, 3) affines (last row 0 0 1)."""
    a, b, c = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    d, e, f = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    det = a * e - b * d
    ia = e / det
    ib = -b / det
    id_ = -d / det
    ie = a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return _stack33([ia, ib, ic], [id_, ie, if_])


def _apply_affine_0idx(pts, t):
    """Raw 0-indexed affine application: (B, K, 2) pts through (B, 3, 3)."""
    pts = torch.as_tensor(pts, dtype=_F32, device=t.device)
    x = pts[..., 0] - 1.0
    y = pts[..., 1] - 1.0
    ox = t[:, 0, 0, None] * x + t[:, 0, 1, None] * y + t[:, 0, 2, None]
    oy = t[:, 1, 0, None] * x + t[:, 1, 1, None] * y + t[:, 1, 2, None]
    return torch.stack([ox, oy], dim=-1)


def transform_points(pts, t, truncate=True):
    """Map 1-indexed points (B, K, 2) through per-sample affines (B, 3, 3).

    With ``truncate`` the reference's integer semantics hold
    (``new_pt.astype(int) + 1``, truncation toward zero).  float32 out.
    """
    out = _apply_affine_0idx(pts, t)
    if truncate:
        out = torch.trunc(out)
    return out + 1.0


def transform_points_int_float(pts, t):
    """One affine application, both views: ``(trunc(out)+1, out+1)``.

    The ints are truncated from the raw 0-indexed map ``out``: in float32
    ``trunc((out+1)-1) != trunc(out)`` for coordinates 1-2 ulp below an
    integer (out=0.99999994f: +1 rounds to 2.0), which would move a
    rasterized peak by one pixel.
    """
    out = _apply_affine_0idx(pts, t)
    return torch.trunc(out) + 1.0, out + 1.0
