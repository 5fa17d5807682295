"""Synthetic mini-split generator — the port's own copy of
``posetpu/data/synthetic.py``.  It renders stick-figure "persons" with
color-coded joints into JPEGs (Pillow, quality 92) and writes annotations in
the reference JSON schema, so tests and smoke runs train end to end without
the real MPII/LSP data.  For the same arguments it writes the same
annotations and the same JPEG bytes as the JAX package's generator.  Pillow
is imported by the functions that draw, not by the module.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
from posetpu_torch.data.schema import SampleMeta, dump_annotations, load_annotations

# canonical 16-joint MPII-order template in unit pose space (x, y)
MPII_TEMPLATE = np.array(
    [
        [0.35, 0.95],  # 0  r-ankle
        [0.37, 0.75],  # 1  r-knee
        [0.42, 0.55],  # 2  r-hip
        [0.58, 0.55],  # 3  l-hip
        [0.63, 0.75],  # 4  l-knee
        [0.65, 0.95],  # 5  l-ankle
        [0.50, 0.55],  # 6  pelvis
        [0.50, 0.30],  # 7  thorax
        [0.50, 0.22],  # 8  upper-neck
        [0.50, 0.05],  # 9  head-top
        [0.25, 0.55],  # 10 r-wrist
        [0.28, 0.42],  # 11 r-elbow
        [0.38, 0.28],  # 12 r-shoulder
        [0.62, 0.28],  # 13 l-shoulder
        [0.72, 0.42],  # 14 l-elbow
        [0.75, 0.55],  # 15 l-wrist
    ]
)

MPII_BONES = [
    (0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5),
    (6, 7), (7, 8), (8, 9),
    (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15),
]

# LSP order: r-ankle..head-top (14 joints) — indices into the MPII template
LSP_FROM_MPII = [0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 8, 9]


def _joint_color(k, num_joints):
    """Distinct, saturated color per joint index."""
    hue = k / num_joints
    i = int(hue * 6) % 6
    f = hue * 6 - int(hue * 6)
    q, t = int(255 * (1 - f)), int(255 * f)
    return [
        (255, t, 0), (q, 255, 0), (0, 255, t),
        (0, q, 255), (t, 0, 255), (255, 0, q),
    ][i]


def render_person(res, pts, rng):
    """Render one stick figure with color-coded joint discs."""
    from PIL import Image, ImageDraw

    W, H = res
    img = Image.fromarray(
        (rng.rand(H, W, 3) * 60 + 20).astype(np.uint8)  # dark noise bg
    )
    draw = ImageDraw.Draw(img)
    bones = MPII_BONES if len(pts) == 16 else None
    if bones:
        for a, b in bones:
            draw.line(
                [tuple(pts[a] - 1), tuple(pts[b] - 1)], fill=(200, 200, 200), width=3
            )
    r = max(2, int(0.02 * max(W, H)))
    for k, (x, y) in enumerate(pts):
        x0, y0 = x - 1, y - 1  # 1-indexed annotation -> pixel coords
        draw.ellipse(
            [x0 - r, y0 - r, x0 + r, y0 + r], fill=_joint_color(k, len(pts))
        )
    return img


def _add_occluders(img, pts, height, rng, n_range=(1, 3), frac=(0.15, 0.30)):
    """Paste random noise-filled rectangles over randomly chosen joints —
    the hard-validation perturbation the adversarial AHO recipe trains
    against (the estimator must infer the covered joint from skeleton
    context).  Annotations keep the true joint position."""
    from PIL import ImageDraw

    draw = ImageDraw.Draw(img)
    n = rng.randint(n_range[0], n_range[1] + 1)
    for _ in range(n):
        j = rng.randint(len(pts))
        side = height * rng.uniform(*frac)
        cx = pts[j, 0] - 1 + rng.randn() * side * 0.2
        cy = pts[j, 1] - 1 + rng.randn() * side * 0.2
        x0, y0 = cx - side / 2, cy - side / 2
        # noise fill matching the background statistics (dark)
        shade = tuple(int(v) for v in rng.rand(3) * 60 + 20)
        draw.rectangle([x0, y0, x0 + side, y0 + side], fill=shade)
    return img


def _add_distractor(img, res, template, rng):
    """Draw one bones-only partial figure in the background (no joint
    discs — shape confusion without duplicating the joint color code)."""
    from PIL import ImageDraw

    W, H = res
    draw = ImageDraw.Draw(img)
    height = H * rng.uniform(0.3, 0.5)
    cx = W * rng.uniform(0.1, 0.9)
    cy = H * rng.uniform(0.2, 0.8)
    ang = rng.uniform(-0.5, 0.5)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    pts = (template - [0.5, 0.5]) @ rot.T * height + [cx, cy]
    bones = MPII_BONES if len(template) == 16 else []
    for a, b in bones:
        draw.line([tuple(pts[a]), tuple(pts[b])], fill=(150, 150, 150), width=3)
    return img


def _head_rect_from_pts(pts_1idx):
    """Synthetic MPII head rectangle [x1, y1, x2, y2] from the upper-neck
    (8) -> head-top (9) segment: axis-aligned box centered on the segment
    midpoint, width = seg, height = 1.6*seg.  Its official normalizer
    0.6*diag ~= 1.13*seg sits close to (but measurably apart from) the
    keypoint fallback 1.2*seg, so a drill can PROVE which branch ran."""
    neck, top = pts_1idx[8], pts_1idx[9]
    seg = float(np.linalg.norm(top - neck))
    cx, cy = (neck + top) / 2.0
    return np.array(
        [cx - seg / 2, cy - 0.8 * seg, cx + seg / 2, cy + 0.8 * seg]
    )


def make_synthetic_dataset(
    out_dir,
    num_train=32,
    num_val=8,
    res=(320, 240),
    dataset="mpii",
    seed=0,
    hard_val=False,
    head_rects=False,
):
    """Create ``images/`` + ``annotations.json`` in the reference schema.

    Returns the annotation JSON path.  Person height ~55-80%% of image
    height; scale follows the reference convention box=200*scale.

    ``hard_val=True`` renders the VALIDATION samples as a robustness
    stress set (the reference's adversarial-gain demo):
    wider person-scale range (0.35-0.95 of image height), 1-3 random
    noise-filled occluder patches over joints, and one bones-only
    distractor figure in the background.  Train samples are unchanged, so
    any accuracy difference between training recipes on this val set
    comes from robustness, not from fitting the perturbations.

    ``head_rects=True`` (MPII only) additionally writes the official
    head-rectangle field to every annotation — the exact real-MPII schema
    with head boxes, so the official-protocol PCKh branch
    (``posetpu_torch.eval.cli.head_sizes``) can be drilled end-to-end before real
    annotations exist.
    """
    if head_rects and dataset != "mpii":
        raise ValueError("head_rects is an MPII-schema field")
    rng = np.random.RandomState(seed)
    W, H = res
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    template = (
        MPII_TEMPLATE if dataset == "mpii" else MPII_TEMPLATE[LSP_FROM_MPII]
    )
    K = len(template)
    samples = []
    for i in range(num_train + num_val):
        is_val = i >= num_train
        hard = hard_val and is_val
        height = H * (
            rng.uniform(0.35, 0.95) if hard else rng.uniform(0.55, 0.8)
        )
        cx = W * rng.uniform(0.35, 0.65)
        cy = H * rng.uniform(0.4, 0.6)
        pts = template - [0.5, 0.5]
        # small in-plane rotation + per-joint jitter
        ang = rng.uniform(-0.25, 0.25)
        rot = np.array(
            [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        )
        pts = pts @ rot.T
        pts = pts * height + [cx, cy]
        pts += rng.randn(K, 2) * height * 0.01
        pts_1idx = pts + 1.0  # annotations are 1-indexed
        img = render_person(res, pts_1idx, rng)
        if hard:
            img = _add_distractor(img, res, template, rng)
            img = _add_occluders(img, pts_1idx, height, rng)
        name = f"synth_{i:05d}.jpg"
        img.save(os.path.join(img_dir, name), quality=92)
        samples.append(
            SampleMeta(
                img_path=name,
                center=np.array([cx, cy]),
                scale=height / 200.0,
                pts=pts_1idx,
                vis=np.ones(K),
                is_validation=is_val,
                head_rect=_head_rect_from_pts(pts_1idx) if head_rects else None,
            )
        )
    json_path = os.path.join(out_dir, "annotations.json")
    dump_annotations(samples, json_path)
    return json_path


def whole_group_split(root, num_images, unit, res, num_val=8):
    """The annotation file of a synthetic train split under ``root`` of
    whole ``unit``-image groups, at least ``num_images`` images, made
    (again) when the one there is not such a split: a loader goes over the
    whole split, so a split of another size would yield a ragged group
    every epoch.  ``res`` is the frames' (W, H)."""
    json_path = os.path.join(root, "annotations.json")
    n_train = -(-num_images // unit) * unit
    if os.path.exists(json_path):
        n_have = sum(not s.is_validation for s in load_annotations(json_path))
        if n_have < n_train or n_have % unit:
            shutil.rmtree(root)
    if not os.path.exists(json_path):
        make_synthetic_dataset(root, num_train=n_train, num_val=num_val, res=res)
    return json_path
