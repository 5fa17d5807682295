"""The loader cell's JPEG frames, written from the seed.  Frozen copies of
``posetpu_torch/data/synthetic.py`` (``MPII_TEMPLATE``, ``MPII_BONES``,
``_joint_color``, ``render_person``, the person draws of
``make_synthetic_dataset``) and of ``posetpu_torch/data/schema.py``'s
``dump_annotations`` layout (the reference's annotation schema), so that
a later change to the program cannot move the yardstick.

:func:`persons` draws ``n`` such frames: a stick-figure person with
colour-coded joints over dark noise, its height 55-80% of the frame's, its
centre near the middle, all joints visible, with its annotation (centre,
scale with the box 200 scale, 1-indexed joints).  :func:`write_split`
writes them as JPEGs (Pillow, ``quality``, 4:2:0) with ``annotations.json``
beside them, every sample a training sample.
"""

from __future__ import annotations

import json
import os

import numpy as np

MPII_TEMPLATE = np.array([
    [0.35, 0.95], [0.37, 0.75], [0.42, 0.55], [0.58, 0.55], [0.63, 0.75], [0.65, 0.95],
    [0.50, 0.55], [0.50, 0.30], [0.50, 0.22], [0.50, 0.05], [0.25, 0.55], [0.28, 0.42],
    [0.38, 0.28], [0.62, 0.28], [0.72, 0.42], [0.75, 0.55],
])
MPII_BONES = [(0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9),
              (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15)]


def _joint_color(k, num_joints):
    hue = k / num_joints
    i = int(hue * 6) % 6
    f = hue * 6 - int(hue * 6)
    q, t = int(255 * (1 - f)), int(255 * f)
    return [(255, t, 0), (q, 255, 0), (0, 255, t), (0, q, 255), (t, 0, 255), (255, 0, q)][i]


def render_person(res, pts, rng):
    from PIL import Image, ImageDraw

    W, H = res
    img = Image.fromarray((rng.rand(H, W, 3) * 60 + 20).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for a, b in MPII_BONES:
        draw.line([tuple(pts[a] - 1), tuple(pts[b] - 1)], fill=(200, 200, 200), width=3)
    r = max(2, int(0.02 * max(W, H)))
    for k, (x, y) in enumerate(pts):
        x0, y0 = x - 1, y - 1
        draw.ellipse([x0 - r, y0 - r, x0 + r, y0 + r], fill=_joint_color(k, len(pts)))
    return img


def persons(n, res, seed):
    """``n`` (Pillow image, centre (2,), scale, 1-indexed joints (16, 2)) of
    frames of ``res`` (W, H), drawn from ``seed``."""
    rng = np.random.RandomState(seed % 2**32)
    W, H = res
    for _ in range(n):
        height = H * rng.uniform(0.55, 0.8)
        cx, cy = W * rng.uniform(0.35, 0.65), H * rng.uniform(0.4, 0.6)
        ang = rng.uniform(-0.25, 0.25)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        pts = (MPII_TEMPLATE - [0.5, 0.5]) @ rot.T * height + [cx, cy]
        pts += rng.randn(len(pts), 2) * height * 0.01
        pts = pts + 1.0  # annotations are 1-indexed
        yield render_person(res, pts, rng), np.array([cx, cy]), height / 200.0, pts


def write_split(root, n, res, seed, quality=92):
    """Write ``n`` frames of ``res`` (W, H) and their annotations under
    ``root``; returns the annotation file's path."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    raw = []
    for i, (img, (cx, cy), scale, pts) in enumerate(persons(n, res, seed)):
        name = f"frame_{i:05d}.jpg"
        img.save(os.path.join(root, "images", name), quality=quality)
        raw.append({"img_paths": name, "objpos": [float(cx), float(cy)],
                    "scale_provided": float(scale),
                    "joint_self": [[float(x), float(y), 1.0] for x, y in pts],
                    "isValidation": 0.0})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path
