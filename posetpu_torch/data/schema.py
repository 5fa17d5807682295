"""Annotation schema — the port's own copy of ``posetpu/data/schema.py``:
bearpaw-format JSON with ``img_paths``, ``joint_self`` Kx3, ``objpos``,
``scale_provided``, ``isValidation`` and optionally ``headboxes`` or
``head_rect``.  It reads and writes this exact schema, so users point it at
the same ``data/mpii/*.json`` files as the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class SampleMeta:
    """One annotated person sample (pre-augmentation)."""

    img_path: str
    center: np.ndarray  # (2,) person center (reference objpos convention)
    scale: float  # person scale; box = 200*scale px
    pts: np.ndarray  # (K, 2) 1-indexed joint coords
    vis: np.ndarray  # (K,) visibility (>0 labeled)
    is_validation: bool
    # Optional MPII head rectangle [x1, y1, x2, y2] (the official PCKh
    # protocol normalizes by 0.6 * its diagonal).  The bearpaw JSON lacks
    # it, so it is None for those files and the eval CLI falls back to
    # 1.2 * |head_top - upper_neck|; real MPII annotations converted
    # with the head box run the official protocol unmodified.
    head_rect: np.ndarray | None = None
    # Original `img_paths` value from the source JSON (may carry a
    # subdirectory, e.g. "images/037454012.jpg").  dump_annotations
    # writes it back verbatim so load->dump->load round-trips resolve to
    # the same files; falls back to basename(img_path) when absent
    # (samples constructed programmatically).
    img_rel: str | None = None

    @property
    def num_joints(self):
        return self.pts.shape[0]


def load_annotations(json_path, images_dir=""):
    """Parse a reference-schema annotation JSON into SampleMeta list.

    Tolerates both the raw schema (list of dicts) and a wrapped
    ``{"samples": [...]}`` layout.
    """
    with open(json_path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        raw = raw.get("samples", raw.get("annotations", []))
    out = []
    for a in raw:
        joints = np.asarray(a["joint_self"], np.float64)
        head = a.get("headboxes") or a.get("head_rect")
        out.append(
            SampleMeta(
                img_path=os.path.join(images_dir, a["img_paths"]),
                center=np.asarray(a["objpos"], np.float64),
                scale=float(a["scale_provided"]),
                pts=joints[:, :2],
                vis=joints[:, 2],
                is_validation=bool(float(a.get("isValidation", 0))),
                head_rect=(
                    np.asarray(head, np.float64) if head is not None else None
                ),
                img_rel=a["img_paths"],
            )
        )
    return out


def dump_annotations(samples, json_path):
    """Write SampleMeta list back to the reference schema."""
    raw = []
    for s in samples:
        raw.append(
            {
                "img_paths": s.img_rel or os.path.basename(s.img_path),
                "objpos": [float(x) for x in s.center],
                "scale_provided": float(s.scale),
                "joint_self": [
                    [float(x), float(y), float(v)]
                    for (x, y), v in zip(s.pts, s.vis)
                ],
                "isValidation": float(s.is_validation),
                **(
                    {"head_rect": [float(x) for x in s.head_rect]}
                    if s.head_rect is not None
                    else {}
                ),
            }
        )
    with open(json_path, "w") as f:
        json.dump(raw, f)
