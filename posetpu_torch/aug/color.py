"""Color augmentation and normalization — counterpart of
``posetpu/aug/color.py``.

The per-sample jitter scales are an argument of :func:`color_jitter`:
:func:`sample_jitter_scales` draws them (the counterpart of
``color_jitter_ps``'s per-sample uniforms), and tests inject the
reference's draws instead so both packages see the same numbers.
"""

from __future__ import annotations

import torch

from posetpu_torch.aug.keyed import STREAM_JITTER, bits_to_uniform, keyed_bits


def sample_jitter_scales(seed, step, index):
    """(B, 3) float32 scales from the reference's U(0.8, 1.2), one row per
    global sample ``index`` (B,), on the jitter stream of
    :func:`posetpu_torch.aug.keyed.keyed_bits`; on ``index``'s device."""
    u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_JITTER, 3))
    return (0.8 + 0.4 * u.to(torch.float64)).to(torch.float32)


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
