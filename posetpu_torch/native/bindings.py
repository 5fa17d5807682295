"""ctypes bindings of the C++ JPEG decode pool (``decode_pool.cpp``).

The pool builds at first use with ``g++ ... -ljpeg -lpthread`` through
:class:`posetpu_torch.utils.cuda_build.Library`, as the CUDA kernels do: into
``posetpu_torch/_build/``, under a name keyed by the source and flags,
written to a file of its own and moved into place.  Processes that start the
first build at once each load a whole library.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from posetpu_torch.utils import cuda_build

POOL = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "decode_pool.cpp"),
    {
        "pool_create": (ctypes.c_void_p, [ctypes.c_int]),
        "pool_destroy": (None, [ctypes.c_void_p]),
        "pool_decode_batch": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]),
        "pool_decode_planes": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_void_p,
                                                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]),
    },
    toolchain="g++", libs=("-ljpeg", "-lpthread"),
)


# libjpeg's J_COLOR_SPACE values (jpeglib.h)
JCS_GRAYSCALE, JCS_RGB, JCS_YCBCR, JCS_CMYK, JCS_YCCK = 1, 2, 3, 4, 5


def read_planes(path):
    """One JPEG file's component planes as stored, before libjpeg's
    upsampling and color conversion (``pool_decode_planes``): returns
    (jpeg_color_space, [(h_samp, v_samp) per component], [(rows, cols) uint8
    array per component]), or None where libjpeg cannot decode the file.
    The image's size is the first plane's when it has the largest
    sampling factors.  Raises RuntimeError when the pool cannot build."""
    info = np.zeros(4 + 4 * 4, np.int32)
    info_p = info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    c_path = os.fsencode(path)
    need = POOL.pool_decode_planes(c_path, None, 0, info_p)
    if need < 0:
        return None
    buf = np.empty(need, np.uint8)
    if POOL.pool_decode_planes(c_path, buf.ctypes.data, need, info_p) != need:
        return None
    factors, planes, at = [], [], 0
    for c in range(int(info[2])):
        h, v, cw, ch = (int(x) for x in info[4 + 4 * c: 8 + 4 * c])
        factors.append((h, v))
        planes.append(buf[at: at + cw * ch].reshape(ch, cw))
        at += cw * ch
    return int(info[3]), factors, planes


def batch_args(paths, centers, pad_hw, out):
    """A decoder's checked arguments: (n, (ph, pw), centers (n, 2) float32,
    out), ``out`` a new array when None, else a writeable C-contiguous
    uint8 array of shape (n, ph, pw, 3)."""
    ph, pw = (int(v) for v in pad_hw)
    n = len(paths)
    if out is None:
        out = np.empty((n, ph, pw, 3), np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (n, ph, pw, 3)
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(
            f"out must be a writeable C-contiguous uint8 array of shape "
            f"{(n, ph, pw, 3)}; got {out.dtype} {out.shape}"
        )
    return n, (ph, pw), checked_centers(centers, n), out


def checked_centers(centers, n):
    """A decoder's ``centers`` as a C-contiguous (n, 2) float32 array."""
    centers = np.ascontiguousarray(centers, np.float32)
    if centers.shape != (n, 2):
        raise ValueError(f"centers must be ({n}, 2); got {centers.shape}")
    return centers


class NativeDecoder:
    """Parallel JPEG batch decoder.

    ``decode_batch(paths, centers, pad_hw, out=None) -> (images, valid_wh,
    offsets, ok)``:

    - images (N, ph, pw, 3) uint8, zero-padded: ``out`` when given (a
      C-contiguous uint8 array of that shape, e.g. the numpy view of a
      pinned tensor), else a new array.  A failed slot reads all zero.
    - valid_wh (N, 2) int32, the (w, h) of the valid region, (0, 0) on
      failure.
    - offsets (N, 2) int32, the integer crop offset (x, y).
    - ok (N,) bool, per-file success (callers fall back to PIL).

    Raises RuntimeError when the pool cannot build (no g++ or no libjpeg).
    """

    def __init__(self, num_threads=None):
        n = num_threads or min(16, os.cpu_count() or 4)
        self._pool = POOL.pool_create(int(n))

    def decode_batch(self, paths, centers, pad_hw, out=None):
        if self._pool is None:
            # a NULL pool handle would segfault inside the C++ call
            raise RuntimeError("NativeDecoder used after close()")
        n, (ph, pw), centers, out = batch_args(paths, centers, pad_hw, out)
        wh = np.zeros((n, 2), np.int32)
        offs = np.zeros((n, 2), np.int32)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        POOL.pool_decode_batch(
            self._pool,
            c_paths,
            n,
            ph,
            pw,
            centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        ok = (wh > 0).all(axis=1)
        return out, wh, offs, ok

    def close(self):
        if self._pool:
            POOL.pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
