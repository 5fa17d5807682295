"""Color augmentation and normalization — counterpart of
``posetpu/aug/color.py``.

The per-sample jitter scales are an argument here: drawing them (the
sampler) belongs to the training slice, and tests inject the reference's
draws so both packages see the same numbers.
"""

from __future__ import annotations

import torch


def color_jitter(images, scales):
    """Per-sample per-channel multiplicative jitter clipped to [0, 1].
    images (B, H, W, C); scales (B, C), in the reference U(0.8, 1.2)."""
    scales = torch.as_tensor(scales, dtype=images.dtype, device=images.device)
    return torch.clamp(images * scales[:, None, None, :], 0.0, 1.0)


def color_normalize(images, mean, std=None):
    """Subtract the dataset per-channel mean (reference
    ``color_normalize``); optionally divide by std.  images (B, H, W, C)."""
    kw = dict(dtype=images.dtype, device=images.device)
    out = images - torch.as_tensor(mean, **kw)[None, None, None, :]
    if std is not None:
        out = out / torch.as_tensor(std, **kw)[None, None, None, :]
    return out
