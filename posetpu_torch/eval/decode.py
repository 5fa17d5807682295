"""Heatmap decode and PCK — counterpart of ``posetpu/eval/decode.py``:
per-joint argmax with 1-indexed coords, a quarter-pixel offset toward the
larger neighbour, +0.5, the inverse affine back to source coords, and PCK
normalized by heatmap width / 10.
"""

from __future__ import annotations

import torch

from posetpu_torch.aug.affine import invert_affine, make_transform, transform_points


def get_preds(scores):
    """(B, K, H, W) heatmaps -> (B, K, 2) 1-indexed (x, y) argmax coords
    (the first maximum), zeroed where the max activation is <= 0."""
    B, K, H, W = scores.shape
    flat = scores.reshape(B, K, H * W)
    idx = torch.argmax(flat, dim=2)
    maxval = torch.amax(flat, dim=2)
    x = (idx % W + 1).to(torch.float32)
    y = (idx // W + 1).to(torch.float32)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxval > 0)[..., None]


def quarter_offset(coords, scores):
    """Shift each coord 0.25 px toward the larger of its two axis
    neighbours (sign(0) = 0: no shift on a tie); coords (B, K, 2)
    1-indexed integer-valued, scores (B, K, H, W)."""
    B, K, H, W = scores.shape
    px = coords[..., 0].long()
    py = coords[..., 1].long()
    inb = (px > 1) & (px < W) & (py > 1) & (py < H)
    pxc = torch.clamp(px, 2, W - 1)
    pyc = torch.clamp(py, 2, H - 1)
    flat = scores.reshape(B, K, H * W)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * W + xx)[..., None])[..., 0]

    # reference: diff_x = hm[py-1, px] - hm[py-1, px-2]  (0-indexed)
    dx = at(pyc - 1, pxc) - at(pyc - 1, pxc - 2)
    dy = at(pyc, pxc - 1) - at(pyc - 2, pxc - 1)
    off = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + off * inb[..., None]


def final_preds(scores, center, scale, res):
    """Full decode to source coords: argmax -> quarter offset -> +0.5 ->
    inverse affine (rot=0) with the reference's integer truncation."""
    coords = quarter_offset(get_preds(scores), scores) + 0.5
    scale = torch.as_tensor(scale, dtype=torch.float32, device=scores.device)
    t = make_transform(center, scale, res, torch.zeros_like(scale))
    return transform_points(coords, invert_affine(t), truncate=True)


def calc_dists(preds, target, normalize):
    """(K, B) normalized distances; -1 where the target is absent (coords
    <= 1)."""
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)
    diff = preds - target
    d = torch.sqrt((diff * diff).sum(dim=-1)) / normalize[:, None]
    return torch.where(valid, d, torch.full_like(d, -1.0)).T


def pck_counts(output, target, thr=0.5, sample_mask=None):
    """Per-joint PCK (hit, total) counts of (B, K, H, W) heatmaps against
    target heatmaps.  ``sample_mask`` (B,) zeroes padded samples out of both
    counts.  Sum counts across batches, then take the ratio once."""
    B, K, H, W = output.shape
    preds = get_preds(output)
    gts = get_preds(target)
    norm = torch.full((B,), W / 10.0, device=output.device)
    dists = calc_dists(preds, gts, norm)  # (K, B)
    valid = dists != -1.0
    if sample_mask is not None:
        valid = valid & (sample_mask[None, :] > 0)
    cnt = valid.sum(dim=1)
    hit = ((dists < thr) & valid).sum(dim=1)
    return hit, cnt


def pck_from_counts(hit, cnt):
    """(K,) hit/total counts -> (K+1,): [0] mean over joints with any valid
    target, [1:] per joint (-1 where a joint has none)."""
    per_joint = torch.where(
        cnt > 0,
        hit / torch.clamp(cnt, min=1),
        torch.full(cnt.shape, -1.0, device=cnt.device),
    )
    have = per_joint >= 0
    n = have.sum()
    avg = torch.where(
        n > 0,
        (per_joint * have).sum() / torch.clamp(n, min=1),
        torch.zeros((), device=cnt.device),
    )
    return torch.cat([avg[None], per_joint])
