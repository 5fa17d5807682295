"""Wrappers of the augmentation path's hand-written CUDA kernels.

Each wrapper takes CUDA tensors only, checks them, allocates its outputs,
launches its kernel on PyTorch's current stream without synchronising,
raises if the launch was refused, and adds one to its counter
``launches.<kernel>`` in :data:`posetpu_torch.utils.profiling.REGISTRY`.
A launch recorded into a CUDA graph is counted when the graph replays
(:func:`counted_as_replays`, :func:`add_replay`), since the capture itself
runs nothing.  The kernels build from ``aug/kernels/*.cu`` at first use
(:mod:`posetpu_torch.utils.cuda_build`); nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os

import torch

from posetpu_torch.utils import cuda_build, profiling

_KERNEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")
RASTERIZE_SOURCE = os.path.join(_KERNEL_DIR, "rasterize.cu")

# every kernel source of this module, for building them all at once
SOURCES = (RASTERIZE_SOURCE,)

# the launch counters of this module's kernels, the ones a graph captures
RASTERIZE_LAUNCHES = "launches.rasterize_gaussians"
COUNTERS = (RASTERIZE_LAUNCHES,)


@contextlib.contextmanager
def counted_as_replays():
    """Around a CUDA graph's capture, and nothing else (a warm-up before it
    runs its kernels, and they count): the wrappers count the launches they
    record, but a capture runs nothing, so the counts go back to what they
    were on exit.  Yields a dict that holds, on exit, the launches the
    capture recorded by counter; :func:`add_replay` adds them back once per
    replay."""
    before = {name: profiling.counter(name) for name in COUNTERS}
    captured = {}
    try:
        yield captured
    finally:
        for name in COUNTERS:
            captured[name] = profiling.counter(name) - before[name]
            profiling.count(name, -captured[name])


def add_replay(captured):
    """Count one replay of a graph that recorded ``captured`` launches."""
    for name, n in captured.items():
        profiling.count(name, n)


@functools.cache
def _rasterize_fn():
    """The launch function, looked up and typed once per process."""
    fn = cuda_build.load_library(RASTERIZE_SOURCE).rasterize_gaussians_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float
    ] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
        err = _rasterize_fn()(
            pts.data_ptr(), visible.data_ptr(), target.data_ptr(),
            vis_out.data_ptr(), B * K, H, W, denom, win, s3,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_gaussians launch failed: CUDA error {err}")
    profiling.count(RASTERIZE_LAUNCHES)
    return target, vis_out
