"""libjpeg's integer IDCT (``jidctint.c``, ``jpeg_idct_islow``, the decoder's
default ``JDCT_ISLOW``) as plain torch functions, and the wrapper of its
kernel (``kernels/idct_islow.cu``).

For each 8x8 block of quantised coefficients in natural order:

- dequantise, ``coef * q`` (``DEQUANTIZE``);
- pass 1 on the columns: ``CONST_BITS`` 13, ``PASS1_BITS`` 2, the ``FIX_*``
  constants, a column whose AC terms are all zero giving its DC term
  ``<< PASS1_BITS`` at once, each output ``DESCALE``d (rounded right shift)
  by ``CONST_BITS - PASS1_BITS``;
- pass 2 on the rows, ``DESCALE``d by ``CONST_BITS + PASS1_BITS + 3``
  (libjpeg's zero-row shortcut gives the same numbers as the full pass, so
  it is not written out);
- the sample through libjpeg's post-IDCT range-limit table, indexed
  ``& RANGE_MASK`` (``jdmaster.c``, ``prepare_range_limit_table``): values
  within 384 of the range clamp to 0-255, values past that wrap as the
  table does.

Arithmetic is int32 throughout, wrapping, as libjpeg's 8-bit build assumes
it fits (its comments: 11-bit dequantised input, 13-bit pass-1 output);
the kernel computes the same int32 arithmetic, so the two agree on any
input.  libjpeg-turbo's SIMD IDCT, which the reference's libjpeg runs on
x86, computes in 16-bit lanes instead and parts from int32 where large
dequantised values leave them; the decode route refuses such files in its
entropy decoder (``jpeg_entropy.cpp``, status "range") and decodes them
with the reference's libjpeg, so neither version sees them there.  A
component's plane is its stored size: the padded blocks' extra samples are
dropped, as libjpeg's raw output crops them.

:func:`idct_islow` is the kernel's wrapper: the plain version on CPU
tensors, the kernel on CUDA tensors (or it raises), one launch counted in
the registry's :data:`IDCT_LAUNCHES` (:mod:`posetpu_torch.utils.profiling`).
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

# jidctint.c at CONST_BITS 13: FIX(x) = (INT32)(x * (1 << 13) + 0.5)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172
RANGE_MASK = 1023  # MAXJSAMPLE * 4 + 3


def range_limit_table():
    """(1024,) uint8: libjpeg's post-IDCT table (``sample_range_limit +
    CENTERJSAMPLE``), indexed by a descaled value ``& RANGE_MASK``: 128 + x
    for x in [0, 128), 255 up to 511, 0 from 512 to 895, x - 896 above."""
    v = np.arange(RANGE_MASK + 1)
    table = np.select([v < 128, v < 512, v < 896], [v + 128, 255, 0], v - 896)
    return torch.from_numpy(table.astype(np.uint8))


def _pass(x, shift):
    """jidctint.c's 1-D pass over the 8 inputs ``x`` (int32 tensors of one
    shape): its 8 outputs, each ``DESCALE``d by ``shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    t0, t1, t2, t3 = t0 + (z1 + z3), t1 + (z2 + z4), t2 + (z2 + z3), t3 + (z1 + z4)
    r = 1 << (shift - 1)
    return [(v + r) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                       tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_blocks(coefs, qtable):
    """(N, 64) int16 quantised coefficients in natural order and a (64,)
    table (int16 or int32 values, at most 32767) -> (N, 8, 8) uint8 samples,
    as ``jpeg_idct_islow`` writes each block."""
    c = coefs.to(torch.int32).view(-1, 8, 8)
    deq = c * qtable.to(torch.int32).view(8, 8)
    cols = _pass([deq[:, i, :] for i in range(8)], CONST_BITS - PASS1_BITS)
    ws = torch.stack(cols, dim=1)  # (N, row, column)
    ac_zero = (c[:, 1:, :] == 0).all(dim=1, keepdim=True)
    ws = torch.where(ac_zero, (deq[:, :1, :] << PASS1_BITS).expand_as(ws), ws)
    rows = _pass([ws[:, :, j] for j in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = torch.stack(rows, dim=2)  # (N, row, column)
    return range_limit_table().to(out.device)[(out & RANGE_MASK).long()]


def component_plane(coefs, qtable, blocks_w, blocks_h, w, h):
    """One component's (h, w) uint8 plane from its (blocks_h * blocks_w, 64)
    coefficients (raster order over its MCU-padded grid): the blocks that
    cover the plane, inverse-transformed and cropped."""
    nbw, nbh = -(-w // 8), -(-h // 8)
    grid = coefs.view(blocks_h, blocks_w, 64)[:nbh, :nbw].reshape(-1, 64)
    blocks = idct_blocks(grid, qtable).view(nbh, nbw, 8, 8)
    return blocks.permute(0, 2, 1, 3).reshape(nbh * 8, nbw * 8)[:h, :w]


# --- the kernel ---------------------------------------------------------------

# the registry's counter of the kernel's launches, counted where the wrapper
# launches it
IDCT_LAUNCHES = "launches.idct_islow"

# idct_islow.cu's descriptor of one component, in int64 words: coefficient
# offset and table offset (int16 elements), the grid's blocks wide, the
# blocks wide and high that cover the plane, the plane's pointer, pitch,
# width and height, the component's first tile in the launch and its tiles
# a block row
DESC_WORDS = 11
TILE_BLOCKS = 32  # idct_islow.cu's kTileBlocks: blocks of a block row a tile
ALIGN = 8  # coefficient and table offsets, in elements: 16-byte bulk copies

_staging = StagingSet()

IDCT = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels", "idct_islow.cu"),
    {
        # the kernel alone, its descriptors already on the card
        "idct_islow_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
        # the kernel after staging its descriptors from the host
        "idct_islow_stage_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    },
)


def _checked(coefs, qtables, desc, planes):
    """``desc`` as (C, 4) int64 after checking every input against the
    others; raises ValueError on what neither version takes."""
    desc = np.asarray(desc, np.int64).reshape(-1, 4)
    if len(desc) != len(planes):
        raise ValueError(f"{len(desc)} descriptors for {len(planes)} planes")
    for t, name in ((coefs, "coefs"), (qtables, "qtables")):
        if t.dtype is not torch.int16 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int16 tensor")
    for (coef_off, qt_off, bw, bh), p in zip(desc.tolist(), planes):
        if p.dtype is not torch.uint8 or p.dim() != 2 or p.stride(1) != 1:
            raise ValueError("planes must be 2-D uint8 with unit column stride")
        h, w = p.shape
        if min(w, h) < 1 or -(-w // 8) > bw or -(-h // 8) > bh:
            raise ValueError(f"a {w}x{h} plane from a grid of {bw}x{bh} blocks")
        if coef_off < 0 or coef_off + bw * bh * 64 > coefs.numel():
            raise ValueError(f"coefficients {coef_off} + {bw * bh * 64} past the buffer")
        if qt_off < 0 or qt_off + 64 > qtables.numel():
            raise ValueError(f"table {qt_off} past the buffer")
    return desc


def descriptors(desc, planes):
    """(C, DESC_WORDS) int64: idct_islow.cu's descriptor of each component
    and the launch's tile count."""
    words = np.zeros((len(planes), DESC_WORDS), np.int64)
    first = 0
    for row, (coef_off, qt_off, bw, _), p in zip(words, desc.tolist(), planes):
        h, w = p.shape
        nbw, nbh = -(-w // 8), -(-h // 8)
        per_row = -(-nbw // TILE_BLOCKS)
        row[:] = (coef_off, qt_off, bw, nbw, nbh, p.data_ptr(), p.stride(0), w, h, first,
                  per_row)
        first += nbh * per_row
    return words, first


def idct_islow_cuda(coefs, qtables, desc, planes):
    """Kernel counterpart of :func:`component_plane` for every component of
    a batch, in one launch on the current stream: ``coefs`` and ``qtables``
    1-D int16 CUDA tensors, ``desc`` (C, 4) (coefficient offset, table
    offset, both multiples of ALIGN, grid blocks wide and high), ``planes``
    C 2-D uint8 CUDA tensors (any row pitch) written in place."""
    desc = _checked(coefs, qtables, desc, planes)
    dev = coefs.device
    if dev.type != "cuda":
        raise ValueError("idct_islow_cuda takes CUDA tensors")
    if any(t.device != dev for t in (qtables, *planes)):
        raise ValueError("idct_islow_cuda takes tensors on one CUDA device")
    if (desc[:, :2] % ALIGN).any() or coefs.data_ptr() % 16 or qtables.data_ptr() % 16:
        raise ValueError(f"coefficient and table offsets must be multiples of {ALIGN} "
                         "elements from 16-byte aligned buffers")
    words, tiles = descriptors(desc, planes)
    if tiles == 0:
        return planes
    st = _staging.get(dev)
    on_dev = torch.cuda.current_device() == dev.index
    with st.lock, contextlib.nullcontext() if on_dev else torch.cuda.device(dev):
        host, dev_words, done = st.reserve(words.size)
        err = IDCT.idct_islow_stage_launch(words.ctypes.data, host, dev_words, done,
                                           len(planes), tiles, coefs.data_ptr(),
                                           qtables.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.count_launch(err, "idct_islow", IDCT_LAUNCHES)
    return planes


def idct_islow(coefs, qtables, desc, planes):
    """:func:`idct_islow_cuda` on CUDA tensors; on CPU tensors the plain
    version, :func:`component_plane` component by component.  Returns
    ``planes``, written in place."""
    if coefs.is_cuda or qtables.is_cuda or any(p.is_cuda for p in planes):
        return idct_islow_cuda(coefs, qtables, desc, planes)
    desc = _checked(coefs, qtables, desc, planes)
    for (coef_off, qt_off, bw, bh), p in zip(desc.tolist(), planes):
        h, w = p.shape
        p.copy_(component_plane(coefs[coef_off:coef_off + bw * bh * 64],
                                qtables[qt_off:qt_off + 64], bw, bh, w, h))
    return planes
