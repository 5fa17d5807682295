"""MPII and LSP datasets — the port's own copy of
``posetpu/data/datasets.py``.

A dataset holds metadata only (paths, centers, scales, joints).  Images are
decoded by the host loader (:mod:`posetpu_torch.data.loader`) and every
augmentation runs on the device (:mod:`posetpu_torch.aug.pipeline`).
Pillow is imported only by the methods that read images, so a machine
without it can still train through the native decode pool.
"""

from __future__ import annotations

import json
import os

import numpy as np

from posetpu_torch.data.schema import load_annotations

MPII_NUM_JOINTS = 16
LSP_NUM_JOINTS = 14
# center/scale adjustment applied per sample: center.y += 15*s, s *= 1.25
MPII_CENTER_Y_SHIFT = 15.0
MPII_SCALE_INFLATE = 1.25


def _write_json(path, obj):
    """Write ``obj`` to ``path`` through a file of this process's own, moved
    into place, so a concurrent reader never sees half a file.  A read-only
    data directory is not an error: the value is recomputed next time."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except OSError:
        pass


class PoseDataset:
    """Metadata-only dataset over the reference annotation schema."""

    name = "generic"
    num_joints = 16
    flip_pairs = "mpii"

    def __init__(self, json_path, images_dir, split="train", adjust=True):
        samples = load_annotations(json_path, images_dir)
        if split == "train":
            samples = [s for s in samples if not s.is_validation]
        elif split == "valid":
            samples = [s for s in samples if s.is_validation]
        elif split != "all":
            raise ValueError(f"unknown split {split!r}")
        self.samples = samples
        self.split = split
        self.adjust = adjust
        # the caches hold split-dependent values, so they are named per
        # split: a validation object never poisons the train split's numbers
        self._mean_cache = os.path.join(
            os.path.dirname(json_path), f"{self.name}_{split}_mean.json"
        )

    def __len__(self):
        return len(self.samples)

    def meta(self, i):
        """(center, scale, pts, vis) with the reference per-sample
        adjustment (center.y += 15*s, s *= 1.25) applied."""
        s = self.samples[i]
        c = s.center.copy()
        sc = s.scale
        # guarded on the -1 sentinel exactly (`c[0] != -1`), as the
        # reference is: a far-left center with x in [0, 1) is adjusted too
        if self.adjust and c[0] != -1:
            c[1] = c[1] + MPII_CENTER_Y_SHIFT * sc
            sc = sc * MPII_SCALE_INFLATE
        return c, sc, s.pts.copy(), s.vis.copy()

    def image_path(self, i):
        return self.samples[i].img_path

    def head_size(self, i):
        """Official MPII PCKh normalizer (0.6 * head-rectangle diagonal)
        when the annotation carries the head box; None otherwise (the eval
        CLI then falls back to the keypoint approximation)."""
        r = self.samples[i].head_rect
        if r is None:
            return None
        return 0.6 * float(np.hypot(r[2] - r[0], r[3] - r[1]))

    def max_image_hw(self):
        """(max_H, max_W) over the split's images, from image headers only
        (Pillow's lazy open reads no pixel data), cached next to the
        annotations.  Caps the auto-sized pre-pad window: the device warp
        reads zero beyond ``valid_wh``, so canvas beyond the largest real
        image buys nothing but copy bytes."""
        cache = os.path.join(
            os.path.dirname(self._mean_cache),
            f"{self.name}_{self.split}_maxhw.json",
        )
        if os.path.exists(cache):
            with open(cache) as f:
                d = json.load(f)
            return int(d["h"]), int(d["w"])
        from PIL import Image

        mh = mw = 0
        for i in range(len(self)):
            with Image.open(self.image_path(i)) as im:
                w, h = im.size
            mh, mw = max(mh, h), max(mw, w)
        _write_json(cache, {"h": mh, "w": mw})
        return mh, mw

    def mean_std(self, max_samples=512):
        """Dataset RGB mean/std in float64 over at most ``max_samples``
        images, cached next to the annotations (the reference caches
        ``mean.pth.tar`` computed over the train set)."""
        if os.path.exists(self._mean_cache):
            with open(self._mean_cache) as f:
                d = json.load(f)
            return np.asarray(d["mean"], np.float32), np.asarray(
                d["std"], np.float32
            )
        from PIL import Image

        acc = np.zeros(3, np.float64)
        acc2 = np.zeros(3, np.float64)
        n = 0
        for i in range(min(len(self), max_samples)):
            img = (
                np.asarray(Image.open(self.image_path(i)).convert("RGB"), np.float64)
                / 255.0
            )
            acc += img.mean(axis=(0, 1))
            acc2 += (img**2).mean(axis=(0, 1))
            n += 1
        mean = acc / max(n, 1)
        std = np.sqrt(np.maximum(acc2 / max(n, 1) - mean**2, 1e-8))
        _write_json(self._mean_cache, {"mean": mean.tolist(), "std": std.tolist()})
        return mean.astype(np.float32), std.astype(np.float32)


class MpiiDataset(PoseDataset):
    """MPII: 16 joints, Tompson validation split via the ``isValidation``
    flag in the annotation JSON."""

    name = "mpii"
    num_joints = MPII_NUM_JOINTS
    flip_pairs = "mpii"


class LspDataset(PoseDataset):
    """LSP + LSP-extended: 14 joints, person-centric; the fine-tune
    experiments (``hg8_lsp_aho``)."""

    name = "lsp"
    num_joints = LSP_NUM_JOINTS
    flip_pairs = "lsp"
