"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference.  Each is a gap that reads 0 where the two
agree; a cell's limits file gives each its limit.

Training (:func:`train_numbers`), over the first dispatches of a fresh
run, from the same weights and rows:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: by the worst parameter tensor ("leaf"), the gap between
  the norms of the gradient as the optimizer took it in, read from its
  second moment after the first dispatch (one step: ``(1 - d) g^2``),
  against the larger of the reference's norm of that leaf and of the
  median leaf;
- ``change_gap``: the same of the norm of each leaf's change over all the
  steps followed;
- ``first_loss_gap``: the relative gap of the first step's loss, which
  follows from the weights and the rows alone;
- ``median_grad_gap``, ``median_change_gap``: the median leaf's relative
  gap of the same norms.

Leaves whose gradient in the reference is under a thousandth of the median
leaf's move by round-off alone (a conv's bias in front of a norm): both
gaps leave them out, by that rule on the reference's gradient.

Serving (:func:`serve_numbers`), on a sample of the window's batches, for
every image and joint:

- ``score_gap``: how far the reference's heatmap at the cell the program
  chose lies below the reference's best, over the map's range;
- ``conf_gap``: the gap between the program's confidence and the
  reference's heatmap at that cell, over the map's range;
- ``pred_px``: the gap in source pixels between the program's keypoint and
  the reference's decode of the program's heatmap coordinate (+0.5, the
  crop transform's inverse, truncated).
"""

from __future__ import annotations

import torch

from benchmark.reference.augment import map_points, transform

# leaves whose reference gradient is under this share of the median
# leaf's are left out of grad_gap and change_gap
TINY_GRAD = 1e-3
# a keypoint this close to a whole source pixel may truncate either way
ROUND_PX = 1e-3


def _worst(prog, ref, keep):
    """The largest |prog - ref| / max(ref, median ref) over ``keep``."""
    med = torch.tensor([ref[n] for n in keep]).median().item()
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def _median_gap(prog, ref, keep):
    """The median over ``keep`` of each leaf's |prog - ref| / ref."""
    return torch.tensor([abs(prog[n] - ref[n]) / ref[n] for n in keep]).median().item()


def train_numbers(prog, ref, start):
    """``prog`` and ``ref``: (losses, {leaf: parameter after}, {leaf:
    second moment after the first dispatch}); ``start``: {leaf: parameter
    before}.  Returns ({number: value}, details)."""
    lp, pp, nup = prog
    lr, pr, nur = ref
    loss_gap = float(((lp.double() - lr.double()).abs() / lr.double().abs()).max())
    leaves = list(pr)

    def norms(nu):
        return {n: float(nu[n].double().sum().sqrt()) for n in leaves}

    def change(p):
        return {n: float((p[n].double() - start[n].double()).norm()) for n in leaves}

    gr = norms(nur)
    med = torch.tensor(list(gr.values())).median().item()
    keep = [n for n in leaves if gr[n] >= TINY_GRAD * med]
    gp, cp, cr = norms(nup), change(pp), change(pr)
    grad_gap, grad_leaf = _worst(gp, gr, keep)
    change_gap, change_leaf = _worst(cp, cr, keep)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
               "first_loss_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])),
               "median_grad_gap": _median_gap(gp, gr, keep),
               "median_change_gap": _median_gap(cp, cr, keep)}
    med_g, med_c = (torch.tensor([d[n] for n in keep]).median().item() for d in (gr, cr))
    # the worst leaf's name, the program's and the reference's norms, and
    # the median leaf's: the look behind a worst-leaf number
    return numbers, {"grad_leaf": [grad_leaf, gp[grad_leaf], gr[grad_leaf], med_g],
                     "change_leaf": [change_leaf, cp[change_leaf], cr[change_leaf], med_c],
                     "leaves": len(leaves), "left_out": len(leaves) - len(keep)}


def serve_numbers(out, heat, center, scale, out_res):
    """``out``: the program's ``pred`` (B, K, 2), ``conf`` (B, K) and
    ``heatmap_coords`` (B, K, 2) of one batch; ``heat``: the reference's
    (B, K, H, W) heatmaps of it.  Returns {number: value}."""
    B, K, H, W = heat.shape
    flat = heat.reshape(B, K, H * W).double()
    best, low = flat.amax(-1), flat.amin(-1)
    span = (best - low).clamp(min=1e-30)
    hmc = out["heatmap_coords"].double()
    cell = torch.round(hmc) - 1.0  # the quarter offset rounds away
    x, y = cell[..., 0].long(), cell[..., 1].long()
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    at = flat.gather(-1, (y.clamp(0, H - 1) * W + x.clamp(0, W - 1))[..., None])[..., 0]
    # a joint the program left at 0 claims that no score is positive: its
    # confidence is its best score all the same
    score_gap = torch.where(inside, best - at, best.clamp(min=0.0)) / span
    conf_gap = (out["conf"].double() - torch.where(inside, at, best)).abs() / span
    # the reference's decode of the program's heatmap coordinate:
    # 1-indexed, + 0.5, through the inverse of the crop transform,
    # truncated; where the point lies within ROUND_PX of a whole pixel,
    # either side of the truncation is right
    t = transform(center, scale, out_res, torch.zeros_like(scale))
    v = map_points(hmc + 0.5, torch.linalg.inv(t.double()))
    lo, hi = torch.trunc(v - ROUND_PX) + 1.0, torch.trunc(v + ROUND_PX) + 1.0
    pred = out["pred"].double()
    pred_px = torch.maximum(lo - pred, pred - hi).clamp(min=0.0).max()
    return {"score_gap": float(score_gap.max()), "conf_gap": float(conf_gap.max()),
            "pred_px": float(pred_px)}
