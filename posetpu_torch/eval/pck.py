"""Offline evaluation protocols — the port's own copy of
``posetpu/eval/pck.py``: MPII PCKh@0.5 (head-size normalized; pelvis and
thorax left out of the mean) and LSP PCK@0.2 (torso-size normalized), in
numpy float64, once per validation pass on decoded predictions.
"""

from __future__ import annotations

import numpy as np

# MPII joint order (bearpaw convention)
MPII_JOINTS = [
    "rank", "rkne", "rhip", "lhip", "lkne", "lank",
    "pelv", "thor", "neck", "head",
    "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
]
# joints excluded from the headline PCKh mean in the official protocol
MPII_EXCLUDE = {"pelv", "thor"}


def pckh(preds, gts, headsizes, vis=None, thr=0.5):
    """MPII PCKh: fraction of visible joints within ``thr * headsize``.

    preds/gts: (N, K, 2) source-coords; headsizes: (N,) head box diagonal
    (official: 0.6 * diag of the annotated head rectangle).  Returns
    (mean_over_included_joints, per_joint array).
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    N, K, _ = preds.shape
    if vis is None:
        vis = np.ones((N, K))
    d = np.linalg.norm(preds - gts, axis=-1) / np.asarray(headsizes)[:, None]
    hit = (d <= thr) & (vis > 0)
    per_joint = np.where(
        (vis > 0).sum(0) > 0, hit.sum(0) / np.maximum((vis > 0).sum(0), 1), np.nan
    )
    if K == len(MPII_JOINTS):
        include = [i for i, n in enumerate(MPII_JOINTS) if n not in MPII_EXCLUDE]
    else:
        include = list(range(K))
    mean = float(np.nanmean(per_joint[include]) * 100.0)
    return mean, per_joint * 100.0


def pck_lsp(preds, gts, vis=None, thr=0.2):
    """LSP PCK@0.2: torso size = the lsho(9)..rhip(2) diagonal per the
    person-centric protocol's MATLAB lineage (1-indexed joints 10 and 3)
    — 14-joint LSP order: 2=rhip, 3=lhip, 8=rsho, 9=lsho, 12=neck,
    13=head."""
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    N, K, _ = preds.shape
    if vis is None:
        vis = np.ones((N, K))
    torso = np.linalg.norm(gts[:, 9] - gts[:, 2], axis=-1)  # lsho..rhip
    torso = np.maximum(torso, 1e-6)
    d = np.linalg.norm(preds - gts, axis=-1) / torso[:, None]
    hit = (d <= thr) & (vis > 0)
    per_joint = np.where(
        (vis > 0).sum(0) > 0, hit.sum(0) / np.maximum((vis > 0).sum(0), 1), np.nan
    )
    return float(np.nanmean(per_joint) * 100.0), per_joint * 100.0
