"""Prediction export — the port's own copy of ``posetpu/eval/export.py``:
validation predictions as ``preds.mat`` (scipy.io, key ``preds``) for the
official MPII/LSP eval scripts, or ``.npz`` at the exact path for any other
extension."""

from __future__ import annotations

import numpy as np


def save_preds(preds, path):
    """Save (N, K, 2) predictions. ``.mat`` uses key 'preds' like the
    reference; any other extension writes .npz AT ``path`` exactly
    (np.savez alone would append '.npz' to a bare name, breaking the
    save->load round-trip)."""
    preds = np.asarray(preds)
    if path.endswith(".mat"):
        from scipy.io import savemat

        savemat(path, {"preds": preds})
    else:
        with open(path, "wb") as f:
            np.savez(f, preds=preds)


def load_preds(path):
    if path.endswith(".mat"):
        from scipy.io import loadmat

        return np.asarray(loadmat(path)["preds"])
    return np.load(path)["preds"]
