"""Wrappers of the augmentation path's hand-written CUDA kernels.

Each wrapper takes CUDA tensors only, checks them, allocates its outputs,
launches its kernel on PyTorch's current stream without synchronising,
raises if the launch was refused, and adds one to its counter
``launches.<kernel>`` in :data:`posetpu_torch.utils.profiling.REGISTRY`.
A launch recorded into a CUDA graph is counted when the graph replays
(:func:`posetpu_torch.utils.profiling.counted_as_replays`), since the
capture itself runs nothing.  The kernels build from ``aug/kernels/*.cu`` at first use
(:class:`posetpu_torch.utils.cuda_build.Library`); nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os

import torch

from posetpu_torch.utils import cuda_build, profiling

RASTERIZE = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels", "rasterize.cu"),
    {"rasterize_gaussians_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                    + [ctypes.c_float] * 3 + [ctypes.c_void_p])},
)

# the launch counter of this module's kernel, one a graph captures
RASTERIZE_LAUNCHES = profiling.launch_counter("launches.rasterize_gaussians")


def rasterize_gaussians_cuda(pts, visible, res, denom, win, s3):
    """Kernel counterpart of
    :func:`posetpu_torch.aug.heatmap.rasterize_gaussians_plain`.

    pts (B, K, 2) float32 CUDA; visible (B, K) float32 on the same device;
    res (H, W); denom, win, s3 from ``heatmap.raster_constants(sigma)``.
    Returns (target (B, K, H, W) float32, vis_out (B, K) float32).
    """
    if not (pts.is_cuda and visible.device == pts.device):
        raise ValueError("rasterize_gaussians_cuda takes CUDA tensors on one device")
    if pts.dtype != torch.float32 or visible.dtype != torch.float32:
        raise TypeError("rasterize_gaussians_cuda takes float32 pts and visible")
    if pts.dim() != 3 or pts.shape[-1] != 2 or visible.shape != pts.shape[:2]:
        raise ValueError(
            f"pts must be (B, K, 2) and visible (B, K); got "
            f"{tuple(pts.shape)} and {tuple(visible.shape)}"
        )
    H, W = (int(r) for r in res)
    if H <= 0 or W <= 0:
        raise ValueError(f"empty heatmap resolution {res}")
    B, K = visible.shape
    pts = pts.contiguous()
    visible = visible.contiguous()
    target = torch.empty((B, K, H, W), dtype=torch.float32, device=pts.device)
    vis_out = torch.empty((B, K), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        err = RASTERIZE.rasterize_gaussians_launch(
            pts.data_ptr(), visible.data_ptr(), target.data_ptr(),
            vis_out.data_ptr(), B * K, H, W, denom, win, s3,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.count_launch(err, "rasterize_gaussians", RASTERIZE_LAUNCHES)
    return target, vis_out
