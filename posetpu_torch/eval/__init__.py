"""Heatmap decode and PCK."""

from posetpu_torch.eval.decode import (
    calc_dists,
    final_preds,
    get_preds,
    pck_counts,
    pck_from_counts,
    quarter_offset,
)

__all__ = [
    "calc_dists",
    "final_preds",
    "get_preds",
    "pck_counts",
    "pck_from_counts",
    "quarter_offset",
]
