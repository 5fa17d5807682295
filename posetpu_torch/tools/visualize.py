"""Prediction pictures — the counterpart of ``tools/visualize.py``: the
skeleton and joints a run's checkpoint predicts on validation images
(green), beside the annotation (blue), written as PNG files.

    python -m posetpu_torch.tools.visualize --config hg2_mpii_mini
        --checkpoint DIR [--best] [--n 4] [--out DIR] [--cpu]
        [the train command's overrides: --stacks, --features, --json, ...]

The run directory is ``<checkpoint>/<config name>``, as the train command
wrote it.  Runs on CUDA unless ``--cpu``.  Pillow is imported where the
pictures are drawn.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

MPII_BONES = [
    (0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5),
    (6, 7), (7, 8), (8, 9),
    (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15),
]
LSP_BONES = [
    (0, 1), (1, 2), (3, 4), (4, 5), (2, 3),
    (6, 7), (7, 8), (9, 10), (10, 11), (8, 12), (9, 12), (12, 13),
]


def draw_pose(img_u8, pts, bones, color=(0, 255, 80)):
    """A Pillow image of ``img_u8`` with the 1-indexed ``pts`` joined by
    ``bones`` in ``color`` and each joint ringed in red."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img_u8).convert("RGB")
    d = ImageDraw.Draw(im)
    for a, b in bones:
        d.line([tuple(pts[a] - 1), tuple(pts[b] - 1)], fill=color, width=2)
    for x, y in pts:
        d.ellipse([x - 3, y - 3, x + 1, y + 1], outline=(255, 60, 60), width=2)
    return im


def main(argv=None):
    """Returns the paths of the PNG files written."""
    from posetpu_torch.configs import add_overrides, apply_overrides, named_config

    ap = argparse.ArgumentParser(prog="python -m posetpu_torch.tools.visualize")
    ap.add_argument("--config", default="hg2_mpii_mini")
    ap.add_argument("--best", action="store_true")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="default: posetpu_torch_viz in the temp directory")
    ap.add_argument("--cpu", action="store_true")
    add_overrides(ap)
    args = ap.parse_args(argv)

    from PIL import Image

    from posetpu_torch.train.loop import Experiment

    cfg = apply_overrides(named_config(args.config), args)
    cfg.resume = ""
    cfg.num_devices = None  # one process draws
    exp = Experiment(cfg, eval_only=True, device="cpu" if args.cpu else "cuda")
    try:
        exp.state, epoch, _ = exp.ckpt.restore(
            exp.state, exp.ckpt.best_path if args.best else None
        )
        _, preds = exp.validate(epoch)
    finally:
        exp.close()
    out_dir = args.out or os.path.join(tempfile.gettempdir(), "posetpu_torch_viz")
    os.makedirs(out_dir, exist_ok=True)
    bones = LSP_BONES if cfg.aug.dataset == "lsp" else MPII_BONES
    written = []
    for i in range(min(args.n, len(preds))):
        img = np.asarray(Image.open(exp.val_ds.image_path(i)).convert("RGB"))
        gt = exp.val_ds.meta(i)[2]
        im = draw_pose(img, preds[i], bones, color=(0, 255, 80))
        im = draw_pose(np.asarray(im), gt, bones, color=(90, 120, 255))
        p = os.path.join(out_dir, f"val_{i:03d}.png")
        im.save(p)
        written.append(p)
        print(f"[viz] {p} (green=pred, blue=gt)")
    return written


if __name__ == "__main__":
    main()
