"""The augmentation of the hourglass lineage (bearpaw's pytorch-pose:
``get_transform``, ``crop``, ``fliplr``/``shufflelr``, ``color_normalize``,
``draw_labelmap``) in plain float32 PyTorch, batched.

- The crop transform maps source pixels to the crop: scale ``res / (200
  s)``, the centre to the middle, then a rotation of ``-rot`` degrees about
  the crop's centre, written out in closed form in float32 (the targets
  truncate transformed points, so their arithmetic is kept to the last
  bit; the angle's sine and cosine are rounded once from float64).
- A flip mirrors the image and the centre about the valid width
  (x -> w - x for 1-indexed points, w - 1 - x for pixels) and swaps the
  left and right joints.
- The crop samples the source bilinearly through the transform's inverse
  (``grid_sample``, zero outside the canvas), the colour scales multiply
  and clip to [0, 1], the dataset mean is subtracted.
- A target is a Gaussian of ``sigma`` at the truncated transformed joint,
  cut to +-3 sigma, zero for a joint that is not visible or whose integer
  window lies wholly outside the map.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FLIP_PAIRS = {
    "mpii": ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)),
    "lsp": ((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9)),
}
_F32 = torch.float32


def transform(center, scale, res, rot_deg):
    """(B, 3, 3) float32: source pixel -> crop pixel."""
    h = 200.0 * scale
    sx = torch.full_like(h, res[1]) / h
    sy = torch.full_like(h, res[0]) / h
    tx = res[1] * (-center[:, 0] / h + 0.5)
    ty = res[0] * (-center[:, 1] / h + 0.5)
    rad = (-rot_deg * (math.pi / 180.0)).double()
    sn, cs = torch.sin(rad).float(), torch.cos(rad).float()
    hw, hh = res[1] / 2.0, res[0] / 2.0
    rows = [cs * sx, -sn * sy, cs * (tx - hw) - sn * (ty - hh) + hw,
            sn * sx, cs * sy, sn * (tx - hw) + cs * (ty - hh) + hh]
    zero, one = torch.zeros_like(h), torch.ones_like(h)
    return torch.stack(rows + [zero, zero, one], dim=-1).reshape(-1, 3, 3)


def map_points(pts, t):
    """1-indexed (B, K, 2) points through (B, 3, 3): the raw 0-indexed
    image of ``pts - 1``."""
    x, y = pts[..., 0] - 1.0, pts[..., 1] - 1.0
    ox = t[:, 0, 0, None] * x + t[:, 0, 1, None] * y + t[:, 0, 2, None]
    oy = t[:, 1, 0, None] * x + t[:, 1, 1, None] * y + t[:, 1, 2, None]
    return torch.stack([ox, oy], dim=-1)


def crop(images, t, res, flip=None, width=None):
    """(B, H, W, 3) uint8 canvases -> (B, *res, 3) float32 in [0, 1]: each
    crop pixel samples its source bilinearly through ``t``'s inverse; a
    flipped sample reads the mirror x -> width - 1 - x."""
    B, H, W, _ = images.shape
    inv = torch.linalg.inv(t.double())
    ys, xs = torch.meshgrid(torch.arange(res[0], dtype=torch.float64, device=t.device),
                            torch.arange(res[1], dtype=torch.float64, device=t.device),
                            indexing="ij")
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    if flip is not None:
        sx = torch.where(flip[:, None, None], width.double()[:, None, None] - 1.0 - sx, sx)
    grid = torch.stack([2.0 * sx / (W - 1) - 1.0, 2.0 * sy / (H - 1) - 1.0], dim=-1)
    src = images.permute(0, 3, 1, 2).to(_F32) / 255.0
    out = F.grid_sample(src, grid.to(_F32), mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def gaussians(pts, vis, res, sigma):
    """Targets (B, K, H, W) of 0-indexed integer-valued points."""
    H, W = res
    denom = torch.tensor(2.0 * sigma * sigma, dtype=_F32, device=pts.device)
    win = float(torch.tensor(3.0 * sigma, dtype=_F32))
    s3 = float(int(3 * sigma))
    px, py = pts[..., 0][..., None, None], pts[..., 1][..., None, None]
    dx = torch.arange(W, dtype=_F32, device=pts.device) - px
    dy = torch.arange(H, dtype=_F32, device=pts.device)[:, None] - py
    g = torch.exp(-(dx * dx + dy * dy) / denom) * (dx.abs() <= win) * (dy.abs() <= win)
    ix, iy = torch.trunc(pts[..., 0]), torch.trunc(pts[..., 1])
    inside = (ix - s3 < W) & (iy - s3 < H) & (ix + s3 + 1 >= 0) & (iy + s3 + 1 >= 0)
    keep = ((vis > 0) & inside).to(_F32)
    return g * keep[..., None, None]


def train_crops(b, scale_f, rot, flip, jitter, aug, mean):
    """One training batch ``b`` (canvases and labels) under the drawn
    scale factors, rotations, flips and colour scales: (input crops
    (B, H, W, 3) normalized, targets (B, K, h, w))."""
    w = b["valid_wh"][:, 0].to(_F32)
    center, pts, vis = b["center"], b["pts"], b["vis"]
    K = pts.shape[1]
    perm = list(range(K))
    for i, j in FLIP_PAIRS[aug["dataset"]]:
        perm[i], perm[j] = perm[j], perm[i]
    cx = torch.where(flip, w - center[:, 0], center[:, 0])
    center = torch.stack([cx, center[:, 1]], dim=-1)
    mirrored = torch.stack([w[:, None] - pts[:, perm, 0], pts[:, perm, 1]], dim=-1)
    pts = torch.where(flip[:, None, None], mirrored, pts)
    vis = torch.where(flip[:, None], vis[:, perm], vis)
    s = b["scale"] * scale_f
    inp_res, out_res = tuple(aug["inp_res"]), tuple(aug["out_res"])
    x = crop(b["image"], transform(center, s, inp_res, rot), inp_res, flip, w)
    if jitter is not None:
        x = torch.clamp(x * jitter[:, None, None, :], 0.0, 1.0)
    x = x - torch.as_tensor(mean, dtype=_F32, device=x.device)
    tp = torch.trunc(map_points(pts, transform(center, s, out_res, rot)))
    return x, gaussians(tp, vis, out_res, aug["sigma"])
