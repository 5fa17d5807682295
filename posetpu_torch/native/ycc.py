"""libjpeg's last steps of a decode, as plain torch functions on uint8
planes: what ``jpeg_read_scanlines`` does in the decode pool
(``native/decode_pool.cpp``) after the IDCT, and the pool's crop and pad.

- :func:`fancy_upsample`: libjpeg-turbo's triangle filter (``jdsample.c``,
  ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``, ``h2v2_fancy_upsample``):
  3:1 taps, rounding biases that alternate between output samples, an edge
  column that keeps its own sample, and the first and last rows taking the
  nearest real row as their context (``jdmainct.c``).  A component whose
  stored width is 2 or less is replicated instead (libjpeg-turbo picks
  ``h2v1_upsample``/``h2v2_upsample`` there); h1v2 is always fancy.
- :func:`ycc_to_rgb`: ``jdcolor.c``'s ``ycc_rgb_convert`` (16-bit fixed
  point, rounded, clamped to 0-255).
- :func:`planes_to_canvas`: both, then the pool's integer crop window
  (:func:`crop_window`) and zero padding; grayscale goes to three equal
  channels, as libjpeg's ``JCS_RGB`` output gives it.

These are the plain versions of the ``ycc_canvas`` kernel
(``native/kernels/ycc_canvas.cu``, wrapped in :mod:`posetpu_torch.native.jpeg_gpu`):
the CPU route and the tests use them, the card's route does not.  A
component's stored size is ``ceil(W * h / hmax) x ceil(H * v / vmax)``
(:func:`component_size`); ``sampling`` names each component's upsampling
factors ``(h, v)``, each 1 or 2, with the luma's (1, 1).
"""

from __future__ import annotations

import numpy as np
import torch

# jdcolor.c: FIX(x) = (INT32)(x * (1 << SCALEBITS) + 0.5), SCALEBITS = 16
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
FIX_1_40200 = 91881
FIX_1_77200 = 116130
FIX_0_71414 = 46802
FIX_0_34414 = 22554


def component_size(W, H, h, v):
    """(width, height) of a component upsampled by (h, v) to a W x H image."""
    return -(-W // h), -(-H // v)


def crop_window(W, H, center, pad_hw):
    """The pool's integer crop window of a W x H image in a ``pad_hw``
    canvas: (off_x, off_y, valid_w, valid_h).  An image larger than the
    canvas is cropped around the person's center, half-up rounded
    (``int(c + 0.5f)``); one that fits keeps offset 0."""
    ph, pw = (int(p) for p in pad_hw)
    off_x = off_y = 0
    if H > ph or W > pw:
        # in float32, as the pool adds 0.5f to its float32 centers
        cx, cy = (int(c + np.float32(0.5)) for c in np.asarray(center, np.float32))
        off_y = min(max(cy - ph // 2, 0), max(H - ph, 0))
        off_x = min(max(cx - pw // 2, 0), max(W - pw, 0))
    return off_x, off_y, min(W - off_x, pw), min(H - off_y, ph)


def _neighbours(n_out, n_in, device):
    """For output samples 0..n_out-1 of a doubled axis: the nearest input
    sample, the next nearest (clamped to the real samples) and whether the
    output sample is odd."""
    o = torch.arange(n_out, device=device)
    near = o >> 1
    odd = (o & 1).bool()
    far = torch.where(odd, (near + 1).clamp(max=n_in - 1), (near - 1).clamp(min=0))
    return near, far, odd


def fancy_upsample(plane, h, v, out_w, out_h):
    """``plane`` (rows, cols) uint8 upsampled by (h, v) in {1, 2}^2 and cut
    to (out_h, out_w), as libjpeg-turbo's decoder does it with its default
    ``do_fancy_upsampling``."""
    p = plane.to(torch.int32)
    rows, cols = p.shape
    dev = p.device
    if (h, v) == (1, 1):
        return plane[:out_h, :out_w].to(torch.uint8)
    if h == 2 and cols <= 2:
        # libjpeg-turbo's plain h2v1/h2v2 upsampling: each sample replicated
        ys = torch.arange(out_h, device=dev) // v
        xs = torch.arange(out_w, device=dev) // 2
        return p[ys][:, xs].to(torch.uint8)
    if v == 2:
        near, far, odd = _neighbours(out_h, rows, dev)
        # the column sums: 3 * nearer row + further row
        colsum = 3 * p[near] + p[far]
        if h == 1:
            bias = torch.where(odd, 2, 1)[:, None]
            return ((colsum[:, :out_w] + bias) >> 2).to(torch.uint8)
        near_x, far_x, odd_x = _neighbours(out_w, cols, dev)
        bias = torch.where(odd_x, 7, 8)[None, :]
        return ((3 * colsum[:, near_x] + colsum[:, far_x] + bias) >> 4).to(torch.uint8)
    # h2v1
    near_x, far_x, odd_x = _neighbours(out_w, cols, dev)
    bias = torch.where(odd_x, 2, 1)[None, :]
    p = p[:out_h]
    return ((3 * p[:, near_x] + p[:, far_x] + bias) >> 2).to(torch.uint8)


def ycc_to_rgb(y, cb, cr):
    """(H, W, 3) uint8 RGB from equal-sized uint8 Y, Cb and Cr planes, with
    ``jdcolor.c``'s integer arithmetic."""
    y = y.to(torch.int32)
    cb = cb.to(torch.int32) - 128
    cr = cr.to(torch.int32) - 128
    r = y + ((FIX_1_40200 * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-FIX_0_34414 * cb + ONE_HALF - FIX_0_71414 * cr) >> SCALEBITS)
    b = y + ((FIX_1_77200 * cb + ONE_HALF) >> SCALEBITS)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def planes_rgb(planes, sampling):
    """The (H, W, 3) uint8 image of one file's planes: the luma plane's
    size is the image's."""
    H, W = planes[0].shape
    if len(planes) == 1:
        return planes[0].to(torch.uint8)[..., None].expand(H, W, 3)
    y = planes[0]
    cb, cr = (fancy_upsample(p, *s, W, H) for p, s in zip(planes[1:], sampling[1:]))
    return ycc_to_rgb(y, cb, cr)


def window_canvas(planes, sampling, window, pad_hw):
    """(ph, pw, 3) uint8: the image's ``window`` (off_x, off_y, valid_w,
    valid_h) at the top left, zeros elsewhere; all zero for a (0, 0)
    window."""
    ph, pw = (int(p) for p in pad_hw)
    off_x, off_y, vw, vh = (int(w) for w in window)
    canvas = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=planes[0].device)
    if vw > 0 and vh > 0:
        rgb = planes_rgb(planes, sampling)
        canvas[:vh, :vw] = rgb[off_y:off_y + vh, off_x:off_x + vw]
    return canvas


def planes_to_canvas(planes, sampling, pad_hw, center):
    """One file's component planes (1 or 3 uint8 tensors at their stored
    sizes) into a ``pad_hw`` canvas around ``center`` (x, y), as the decode
    pool fills one slot: returns (canvas (ph, pw, 3) uint8, valid_wh (2,)
    int32, offset (2,) int32)."""
    H, W = planes[0].shape
    window = crop_window(W, H, center, pad_hw)
    canvas = window_canvas(planes, sampling, window, pad_hw)
    return (canvas, torch.tensor(window[2:], dtype=torch.int32),
            torch.tensor(window[:2], dtype=torch.int32))
