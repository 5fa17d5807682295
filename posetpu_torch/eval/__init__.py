"""Heatmap decode, PCK counts, the offline PCKh/PCK protocols and the
prediction export."""

from posetpu_torch.eval.decode import (
    calc_dists,
    final_preds,
    get_preds,
    pck_counts,
    pck_from_counts,
    quarter_offset,
)
from posetpu_torch.eval.export import load_preds, save_preds
from posetpu_torch.eval.pck import pck_lsp, pckh

__all__ = [
    "calc_dists",
    "final_preds",
    "get_preds",
    "pck_counts",
    "pck_from_counts",
    "quarter_offset",
    "load_preds",
    "save_preds",
    "pck_lsp",
    "pckh",
]
