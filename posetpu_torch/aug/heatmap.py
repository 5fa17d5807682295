"""Gaussian target rasterizer — counterpart of ``posetpu/aug/heatmap.py``.

    g[b,k,y,x] = exp(-(dx^2+dy^2)/(2 sigma^2)) * [|dx|<=3s] * [|dy|<=3s]

with dx = x - px over the integer-valued transformed keypoint, zeroed for a
joint that is not visible or whose window lies wholly outside the map.

:func:`rasterize_gaussians` picks the implementation from the device of its
inputs: a CUDA tensor goes to the hand-written kernel
(``aug/kernels/rasterize.cu``), a CPU tensor to
:func:`rasterize_gaussians_plain`.  There is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.aug import cuda_kernels

_F32 = torch.float32


def raster_constants(sigma):
    """(2*sigma^2, 3*sigma, float(int(3*sigma))) rounded to float32, the
    way the reference's float64 Python scalars meet its float32 arrays.

    The window mask uses 3*sigma itself, the visibility rule the integer
    part of it; the two differ when 3*sigma is not an integer.
    """
    sigma = float(sigma)
    return tuple(
        float(np.float32(v))
        for v in (2.0 * sigma * sigma, 3.0 * sigma, float(int(3 * sigma)))
    )


def window_inside(ipx, ipy, res, sigma):
    """The reference's visibility rule on the integer window
    [pt-3s, pt+3s+1): invisible iff ul >= size or br < 0 on either axis.
    ``ipx``/``ipy`` are integer-valued float32 tensors."""
    H, W = res
    s3 = raster_constants(sigma)[2]
    return (
        (ipx - s3 < W)
        & (ipy - s3 < H)
        & (ipx + s3 + 1 >= 0)
        & (ipy + s3 + 1 >= 0)
    )


def rasterize_gaussians_plain(pts, visible, res, sigma=1.0):
    """Plain PyTorch rasterizer on any device (the kernel's reference).

    pts (B, K, 2) 0-indexed integer-valued heatmap coords; visible (B, K).
    Returns (target (B, K, H, W) float32, vis_out (B, K) float32).
    """
    H, W = res
    pts = torch.as_tensor(pts, dtype=_F32)
    dev = pts.device
    visible = torch.as_tensor(visible, device=dev)
    px = pts[..., 0][..., None, None]
    py = pts[..., 1][..., None, None]

    xs = torch.arange(W, dtype=_F32, device=dev)[None, None, None, :]
    ys = torch.arange(H, dtype=_F32, device=dev)[None, None, :, None]
    dx = xs - px
    dy = ys - py

    denom, win, _ = raster_constants(sigma)
    if dev.type == "cpu":
        # PyTorch's CPU exp can return elements off by ~1e-4 relative from
        # the first call in a process when that call runs on several threads
        # (a first-use race in its vectorized math dispatch; about one
        # process in six, torch 2.13 on AVX-512).  One single-threaded call
        # first avoids it.
        torch.exp(torch.zeros(1))
    # a tensor divisor: a true division, as the kernel and the reference do
    # (PyTorch multiplies by the reciprocal when dividing a CUDA tensor by a
    # Python scalar); made on the device, so no host copy syncs the stream
    g = torch.exp(-(dx * dx + dy * dy) / torch.full((), denom, device=dev))
    g = g * (dx.abs() <= win) * (dy.abs() <= win)

    inside = window_inside(
        torch.trunc(pts[..., 0]), torch.trunc(pts[..., 1]), res, sigma
    )
    vis_f = ((visible > 0) & inside).to(_F32)
    return g * vis_f[..., None, None], vis_f


def rasterize_gaussians(pts, visible, res, sigma=1.0):
    """Rasterize target heatmaps: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Arguments and returns as
    :func:`rasterize_gaussians_plain`."""
    pts = torch.as_tensor(pts, dtype=_F32)
    if pts.is_cuda:
        visible = torch.as_tensor(visible, dtype=_F32, device=pts.device)
        return cuda_kernels.rasterize_gaussians_cuda(
            pts, visible, res, *raster_constants(sigma)
        )
    if pts.device.type != "cpu":
        raise ValueError(f"no rasterizer for device {pts.device}")
    return rasterize_gaussians_plain(pts, visible, res, sigma)
