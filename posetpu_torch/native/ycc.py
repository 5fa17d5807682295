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
(``kernels/ycc_canvas.cu``): the CPU route and the tests use them, the
card's route does not.  A component's stored size is
``ceil(W * h / hmax) x ceil(H * v / vmax)`` (:func:`component_size`);
``sampling`` names each component's upsampling factors ``(h, v)``, each 1
or 2, with the luma's (1, 1).

:func:`ycc_canvas` is the kernel's wrapper: plain on CPU tensors, the
kernel on CUDA tensors (or it raises), one launch counted in the
registry's :data:`YCC_LAUNCHES` (:mod:`posetpu_torch.utils.profiling`).
The library builds at first use; nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import os

import numpy as np
import torch

from posetpu_torch.native.staging import StagingSet
from posetpu_torch.utils import cuda_build

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


# --- the kernel ---------------------------------------------------------------

# the registry's counter of the kernel's launches, counted where the wrapper
# launches it
YCC_LAUNCHES = "launches.ycc_canvas"

DESC_WORDS = 24  # ycc_canvas.cu's descriptor of one image, in int64 words

_staging = StagingSet()

YCC = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels", "ycc_canvas.cu"),
    {
        # the kernel alone, its descriptors already on the card
        "ycc_canvas_launch": (ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 3
                              + [ctypes.c_void_p] * 2),
        # the kernel after staging its descriptors from the host
        "ycc_canvas_stage_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                    + [ctypes.c_void_p] * 2),
    },
)


def descriptors(planes, samplings, windows, pad_hw, device):
    """(N, DESC_WORDS) int64: ycc_canvas.cu's descriptor of each image, its
    row zero where the window is (0, 0) (such an image needs no planes).
    Raises ValueError on planes, samplings or windows the kernel does not
    take, or planes on another device than ``device``."""
    ph, pw = pad_hw
    windows = np.asarray(windows, np.int64).reshape(len(planes), 4)
    live = (windows[:, 2] > 0) & (windows[:, 3] > 0)
    wins = windows.tolist()
    index = device.index if device.type == "cuda" else -1  # Tensor.get_device()'s
    rows, cols, words = [], [], []  # per plane: its image, component, words
    for n in np.flatnonzero(live).tolist():
        pl, samp = planes[n], samplings[n]
        off_x, off_y, vw, vh = wins[n]
        if len(pl) not in (1, 3) or len(samp) != len(pl) or tuple(samp[0]) != (1, 1):
            raise ValueError(f"bad planes/sampling: {len(pl)} planes, sampling {samp}")
        for c, (p, (hf, vf)) in enumerate(zip(pl, samp)):
            if p.get_device() != index:
                raise ValueError("ycc_canvas_cuda takes tensors on one CUDA device")
            stride = p.stride()
            if p.dtype is not torch.uint8 or len(stride) != 2 or stride[1] != 1:
                raise ValueError("planes must be 2-D uint8 with unit column stride")
            h, w = p.shape
            if c == 0:
                H, W = h, w
            else:
                if hf not in (1, 2) or vf not in (1, 2):
                    raise ValueError(f"upsampling factors must be 1 or 2, got {(hf, vf)}")
                if w != -(-W // hf) or h != -(-H // vf):  # component_size
                    raise ValueError(f"component of shape {(h, w)} for a {W}x{H} image "
                                     f"at {(hf, vf)}")
            rows.append(n)
            cols.append(c)
            words.append((p.data_ptr(), stride[0], w, h, hf, vf))
        if off_x < 0 or off_y < 0 or off_x + vw > W or off_y + vh > H or vw > pw or vh > ph:
            raise ValueError(f"window {[off_x, off_y, vw, vh]} outside a {W}x{H} image "
                             "or the canvas")
    desc = np.zeros((len(planes), DESC_WORDS), np.int64)
    if rows:
        rows = np.array(rows)
        # words 0-17: pointer, pitch, width, height, h, v, each for 3 components
        desc[rows[:, None], np.array(cols)[:, None] + 3 * np.arange(6)] = np.array(words, np.int64)
        np.add.at(desc[:, 18], rows, 1)
    desc[live, 19:23] = windows[live]
    return desc


def canvas_out(out, shape, device):
    """``out`` once checked, or a new uint8 tensor of ``shape`` on ``device``."""
    if out is None:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    if (out.dtype != torch.uint8 or tuple(out.shape) != shape or not out.is_contiguous()
            or out.device != device):
        raise ValueError(f"out must be a contiguous uint8 tensor of shape {shape} on {device}")
    return out


def ycc_canvas_cuda(planes, samplings, windows, pad_hw, out=None):
    """Kernel counterpart of :func:`window_canvas` for a batch, in one
    launch on the current stream.  ``planes``: per image a tuple of 1
    (grayscale) or 3 2-D uint8 CUDA tensors at their stored sizes (rows may
    be padded: any row stride, unit column stride); ``samplings``: per
    image per component (h, v) upsampling factors, the luma's (1, 1), the
    others 1 or 2; ``windows``: (N, 4) (off_x, off_y, valid_w, valid_h),
    (0, 0) sizes for an all-zero slot.  Returns ``out`` or a new (N, ph,
    pw, 3) uint8 tensor."""
    ph, pw = (int(p) for p in pad_hw)
    n = len(planes)
    windows = np.asarray(windows, np.int64).reshape(n, 4)
    dev = next((p.device for pl in planes if pl for p in pl), None)
    if out is not None:
        dev = out.device
    if dev is None or dev.type != "cuda":
        raise ValueError("ycc_canvas_cuda takes CUDA tensors")
    desc = descriptors(planes, samplings, windows, (ph, pw), dev)
    out = canvas_out(out, (n, ph, pw, 3), dev)
    if n == 0:
        return out
    st = _staging.get(dev)
    # the descriptors go through the device's staging buffers, in the same C
    # call as the launch
    on_dev = torch.cuda.current_device() == dev.index
    with st.lock, contextlib.nullcontext() if on_dev else torch.cuda.device(dev):
        host, dev_descs, done = st.reserve(desc.size)
        err = YCC.ycc_canvas_stage_launch(desc.ctypes.data, host, dev_descs, done, n, ph, pw,
                                          out.data_ptr(),
                                          torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.count_launch(err, "ycc_canvas", YCC_LAUNCHES)
    return out


def ycc_canvas(planes, samplings, windows, pad_hw, out=None):
    """:func:`ycc_canvas_cuda` on CUDA tensors; on CPU tensors the plain
    version, :func:`window_canvas` image by image."""
    on_cuda = (out is not None and out.is_cuda) or any(p.is_cuda for pl in planes for p in pl)
    if on_cuda:
        return ycc_canvas_cuda(planes, samplings, windows, pad_hw, out=out)
    if out is None:
        out = torch.empty((len(planes), *(int(p) for p in pad_hw), 3), dtype=torch.uint8)
    for slot, pl, samp, win in zip(out, planes, samplings, np.asarray(windows).reshape(-1, 4)):
        if pl:
            slot.copy_(window_canvas(pl, samp, win, pad_hw))
        else:
            slot.zero_()
    return out
