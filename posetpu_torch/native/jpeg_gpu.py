"""The card's JPEG decode route: a hand-written entropy decoder on the host's
threads, the ``idct_islow`` kernel and the ``ycc_canvas`` kernel.

:class:`GpuJpegDecoder` keeps :class:`~posetpu_torch.native.NativeDecoder`'s
contract and answers, and gives libjpeg's decode with its defaults bit for
bit.  On CUDA a batch goes:

1. the files are read and their headers parsed (``jpe_info``), their
   coefficients and planes laid out;
2. ``num_threads`` workers decode the files' Huffman data
   (``jpeg_entropy.cpp``, the GIL released) into one of two pinned
   buffers, used in turn, after the event of that buffer's last copy;
3. one copy takes the batch's coefficients and tables to the card, on the
   decoder's stream;
4. the ``idct_islow`` kernel (``kernels/idct_islow.cu``, libjpeg's
   ``jpeg_idct_islow``) writes every component's plane at its stored size,
   in one launch;
5. the ``ycc_canvas`` kernel (``kernels/ycc_canvas.cu``) upsamples,
   converts, crops and pads the batch in one launch, and the canvas is
   copied into the caller's (pinned) host buffer, or stays on the card in
   the caller's tensor.

On the CPU the same entropy decoder runs, then the plain versions
(:func:`posetpu_torch.native.islow.idct_islow`,
:func:`posetpu_torch.native.ycc.ycc_canvas`), so the tests reach every step
but the two kernels.  The two kernels' wrappers live beside their plain
versions, in :mod:`posetpu_torch.native.islow` and
:mod:`posetpu_torch.native.ycc`; this module holds the decoder and the
entropy decoder's library (:data:`ENTROPY`).  The libraries build at first
use (:class:`posetpu_torch.utils.cuda_build.Library`); nothing here runs at
import.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time

import numpy as np
import torch

from posetpu_torch.native import islow, ycc
from posetpu_torch.native.bindings import (
    JCS_CMYK,
    JCS_GRAYSCALE,
    JCS_RGB,
    JCS_YCBCR,
    JCS_YCCK,
    batch_args,
    checked_centers,
)
from posetpu_torch.utils import cuda_build, profiling
from posetpu_torch.utils.device import resolve_device

PITCH_ALIGN = 256  # row pitch of the planes the IDCT writes, in bytes

# jpeg_entropy.cpp's statuses, by name; any status but 0 sends the file to
# the caller's Pillow path
JPE_STATUSES = ("ok", "not_jpeg", "progressive", "arithmetic", "lossless", "precision",
                "components", "sampling", "scans", "dnl", "corrupt", "dimensions",
                "exception", "range")
INFO_WORDS = 21  # jpe_info's words: width, height, components, 6 a component

_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_color_space(data):
    """libjpeg's ``jpeg_color_space`` for a file's bytes, by libjpeg-turbo's
    rules (``jdapimin.c``, ``default_decompress_parms``): a JFIF marker means
    YCbCr, else an Adobe marker's transform (0: RGB), else the component ids
    ('R', 'G', 'B': RGB).  None when the header does not parse."""
    if data[:2] != b"\xff\xd8":
        return None
    i, jfif, adobe = 2, False, None
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return None
        m = data[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        seg = data[i + 4:i + 2 + length]
        if m == 0xE0 and length >= 16 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and length >= 14 and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif m in _SOF:
            nc = seg[5] if len(seg) > 5 else 0
            ids = tuple(seg[6 + 3 * k] for k in range(nc)) if len(seg) >= 6 + 3 * nc else ()
            if nc == 1:
                return JCS_GRAYSCALE
            if nc == 3:
                if jfif:
                    return JCS_YCBCR
                if adobe is not None:
                    return JCS_RGB if adobe == 0 else JCS_YCBCR
                return JCS_RGB if ids == (82, 71, 66) else JCS_YCBCR
            if nc == 4:
                return JCS_YCCK if adobe == 2 else JCS_CMYK
            return None
        elif m == 0xDA:  # a scan before the frame header
            return None
        i += 2 + length
    return None


# --- the entropy decoder -----------------------------------------------------------

_P = ctypes.POINTER
# the entropy decoder: g++, no libjpeg; its C functions in its order
ENTROPY = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_entropy.cpp"),
    {
        "jpe_create": (ctypes.c_void_p, [ctypes.c_int]),
        "jpe_destroy": (None, [ctypes.c_void_p]),
        "jpe_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, _P(ctypes.c_int)]),
        "jpe_decode_batch": (None, [ctypes.c_void_p, _P(ctypes.c_char_p), _P(ctypes.c_size_t),
                                    ctypes.c_int, _P(ctypes.c_void_p), _P(ctypes.c_void_p),
                                    _P(ctypes.c_int)]),
        "jpe_counts": (None, [ctypes.c_void_p, _P(ctypes.c_longlong)]),
    },
    toolchain="g++", libs=("-lpthread",),
)


def default_threads():
    """The workers of a decoder by default: the host pool's rule
    (``NativeDecoder``), ``min(16, os.cpu_count() or 4)``."""
    return min(16, os.cpu_count() or 4)


def _read(path):
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _supported(color_space, samplings):
    """Whether libjpeg's JCS_RGB output is this route's: YCbCr at chroma
    factors of 1 or 2 (4:4:4, 4:2:2, 4:4:0, 4:2:0), or grayscale.  CMYK and
    YCCK fail in the pool too; RGB-coded and other subsamplings go to the
    caller's Pillow path."""
    if color_space == JCS_GRAYSCALE:
        return len(samplings) == 1
    return (color_space == JCS_YCBCR and len(samplings) == 3
            and tuple(samplings[0]) == (1, 1)
            and all(h in (1, 2) and v in (1, 2) for h, v in samplings[1:]))


def plane_sizes(samplings, W, H):
    """The (w, h) of each component's plane, libjpeg's stored size, for a
    W x H file at ``samplings`` (per component (h, v) upsampling factors)."""
    return [(W, H)] + [ycc.component_size(W, H, *s) for s in samplings[1:]]


def plane_layout(sizes):
    """Where the files' planes go in one buffer.  ``sizes``: per file None
    (not decoded) or its planes' (w, h).  Returns (per file None or
    [(w, h, pitch, offset)] a plane, the buffer's bytes): rows padded to
    PITCH_ALIGN bytes, each plane after the previous one, so every plane
    starts PITCH_ALIGN-aligned and no two overlap."""
    layout, at = [], 0
    for planes in sizes:
        if planes is None:
            layout.append(None)
            continue
        comps = []
        for w, h in planes:
            pitch = -(-w // PITCH_ALIGN) * PITCH_ALIGN
            comps.append((w, h, pitch, at))
            at += pitch * h
        layout.append(comps)
    return layout, at


def coefficient_layout(grids):
    """Where the files' tables and coefficients go in one int16 buffer.
    ``grids``: per file None or its components' (blocks_w, blocks_h).
    Returns (per file None or (table offset, [coefficient offset a
    component]), the buffer's elements): a file's tables (64 a component)
    then its components' blocks (64 each), every offset a multiple of 64
    elements (128 bytes), as jpe_decode_batch writes them."""
    layout, at = [], 0
    for comps in grids:
        if comps is None:
            layout.append(None)
            continue
        qt, at = at, at + 64 * len(comps)
        offs = []
        for bw, bh in comps:
            offs.append(at)
            at += 64 * bw * bh
        layout.append((qt, offs))
    return layout, at


class _Header:
    """One file's answer from ``jpe_info``: its size, its components'
    upsampling factors, grids and planes."""

    def __init__(self, words):
        W, H, nc = (int(x) for x in words[:3])
        comps = words[3:3 + 6 * nc].reshape(nc, 6).astype(np.int64)
        hmax, vmax = int(comps[:, 0].max()), int(comps[:, 1].max())
        self.size = (W, H)
        self.samplings = [(hmax // int(h), vmax // int(v)) for h, v in comps[:, :2]]
        self.grids = [tuple(int(x) for x in c) for c in comps[:, 2:4]]
        self.planes = [tuple(int(x) for x in c) for c in comps[:, 4:6]]


class Coefficients:
    """A batch's entropy decode, before the IDCT: ``buffer`` (1-D int16
    tensor) holds every decoded file's tables and coefficients as
    :func:`coefficient_layout` lays them out, in its first ``elements``; ``desc`` ((C, 4) int64) and
    ``sizes`` ((w, h) a component) are :func:`~posetpu_torch.native.islow.idct_islow`'s
    descriptors and planes, component after component of the decoded
    files; ``files`` gives each component's file and index; ``headers`` a
    :class:`_Header` per decoded file, None for the others; ``statuses``
    per file its status (see :data:`JPE_STATUSES`), -1 for a file that
    decodes but is not this route's (RGB-coded, say)."""

    def __init__(self, buffer, elements, headers, layout, statuses):
        self.buffer, self.elements = buffer, elements
        self.headers, self.statuses = headers, statuses
        rows, self.sizes, self.files = [], [], []
        for i, (hd, lay) in enumerate(zip(headers, layout)):
            if hd is None:
                continue
            qt, offs = lay
            for c, (off, (bw, bh), wh) in enumerate(zip(offs, hd.grids, hd.planes)):
                rows.append((off, qt + 64 * c, bw, bh))
                self.sizes.append(wh)
                self.files.append((i, c))
        self.desc = np.array(rows, np.int64).reshape(-1, 4)

    @property
    def refused(self):
        return sum(h is None for h in self.headers)


class GpuJpegDecoder:
    """JPEG batch decoder on the card, with :class:`NativeDecoder`'s
    contract: ``decode_batch(paths, centers, pad_hw, out=None) -> (images,
    valid_wh, offsets, ok)`` (see ``native/bindings.py``), its images equal
    to libjpeg's decode (``JDCT_ISLOW``, fancy upsampling) bit for bit.  A
    file the route refuses (not a JPEG, progressive, arithmetic-coded,
    12-bit, CMYK, RGB-coded, 4:1:1, several scans, corrupt, or a block
    that libjpeg-turbo's 16-bit SIMD IDCT computes otherwise: see
    ``jpeg_entropy.cpp``) reads all zero with ``ok`` False, for the
    caller's Pillow path, and is counted in :attr:`refused`.

    ``device``: "cuda" (the default; raises without CUDA), "cuda:N", or
    "cpu" for the plain route.  ``num_threads``: the entropy decoder's
    worker threads (None: :func:`default_threads`, the host pool's rule);
    the decoder raises if it cannot start them all.  A batch's files are
    decoded on the workers in one call (the GIL released), then the
    coefficients go to the card and the two kernels run on the decoder's
    own stream, whatever thread calls it.  Calls are serialised.  The
    result is the same for every ``num_threads``.  A failed build or a CUDA
    error raises.

    ``out``: None or a host uint8 array, as ``NativeDecoder`` takes (on
    CUDA the canvas is copied into it, and the call returns once it is
    there); or a contiguous (n, ph, pw, 3) uint8 tensor on the decoder's
    device (see :meth:`canvas`): the kernel writes into it, nothing comes
    back to the host, and ``images`` is a :class:`DecodedCanvas` whose
    ``ready`` event orders a reader after the last write.

    ``timing=True`` appends to :attr:`times` one dict a batch: ``threads``,
    ``refused`` (files left to the caller), ``read_ms`` (reading the
    files), ``info_ms`` (parsing their headers, laying out their
    coefficients and planes, and the wait for the pinned buffer's last
    copy), ``host_ms`` (the wall time of the workers' entropy decode),
    ``desc_ms`` (the host clock of the canvas kernel's wrapper) and
    ``total_ms`` (the call's host time): the host's clock alone, so a
    timed call waits for nothing more than an untimed one.

    While tracing is on (:mod:`posetpu_torch.utils.profiling`) the stages
    are spans of the loader's producer, whose step the decode is:
    ``loader.read``, ``loader.header`` and ``loader.entropy`` above, then
    ``loader.device_decode`` (the host's calls of the copy and the two
    kernels).  The card's time of each stage, on the decoder's stream, is a
    device span of it: ``loader.copy_in`` (the coefficients' copy to the
    card), ``loader.idct`` (the IDCT's staging and kernel),
    ``loader.canvas`` (the canvas kernel's staging and kernel) and, for a
    host ``out``, ``loader.copy_out`` (the canvas into it).
    """

    PINNED_BUFFERS = 2  # the coefficients' page-locked buffers, used in turn

    def __init__(self, device="cuda", timing=False, num_threads=None):
        dev = resolve_device(device)
        self.timing = timing
        self.times = []
        self.refused = 0
        self.num_threads = int(num_threads or default_threads())
        self._lock = threading.Lock()
        self._ctx = ENTROPY.jpe_create(self.num_threads)
        if not self._ctx:
            raise RuntimeError(f"the JPEG entropy decoder failed to start {self.num_threads} "
                               "threads")
        if dev.type == "cpu":
            self.device = dev
            return
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if dev.index is None else dev.index)
        islow.IDCT.load()
        ycc.YCC.load()
        self.stream = torch.cuda.Stream(self.device)
        self._pinned = [None] * self.PINNED_BUFFERS
        with torch.cuda.device(self.device):
            self._copied = [torch.cuda.Event() for _ in range(self.PINNED_BUFFERS)]
        self._turn = self._last = 0  # the pinned buffer to fill next, and the one filled last
        self._coefs = None  # the coefficients on the card
        self._buf = None  # the planes on the card
        self._canvas = None

    def close(self):
        if self._ctx:
            ENTROPY.jpe_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _check_open(self):
        if not self._ctx:
            raise RuntimeError("GpuJpegDecoder used after close()")

    @contextlib.contextmanager
    def _on_device(self):
        """Serialised, on the decoder's device and stream."""
        self._check_open()
        with self._lock, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def canvas(self, shape):
        """A new uint8 tensor of ``shape`` on the decoder's device, for
        ``decode_batch``'s tensor ``out``: on CUDA from the caching
        allocator on the decoder's stream, where the kernel writes it, so
        every batch in flight has its own."""
        if self.device.type == "cpu":
            return torch.empty(shape, dtype=torch.uint8)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            return torch.empty(shape, dtype=torch.uint8, device=self.device)

    # -- the entropy decode ----------------------------------------------------------

    def _header(self, path, data, info):
        """A :class:`_Header` of a file the route decodes, else its status
        (-1: it decodes, but libjpeg's RGB output would not come from its
        planes through this route's upsampling and conversion)."""
        if data is None:
            return JPE_STATUSES.index("not_jpeg")
        st = ENTROPY.jpe_info(data, len(data), info.ctypes.data_as(_P(ctypes.c_int)))
        if st != 0:
            return st
        hd = _Header(info)
        if not _supported(jpeg_color_space(data), hd.samplings):
            return -1
        want = plane_sizes(hd.samplings, *hd.size)
        if hd.planes != want:
            raise RuntimeError(f"the entropy decoder's planes {hd.planes} for {path} are not "
                               f"libjpeg's {want}")
        return hd

    def _entropy(self, paths, buffer_for):
        """Read the files, parse their headers, lay out their coefficients
        in ``buffer_for(elements)`` (a 1-D int16 tensor at least that long)
        and decode them with one ``jpe_decode_batch`` on the workers.
        Returns (:class:`Coefficients`, {"read_ms", "info_ms", "host_ms"})."""
        t0 = time.perf_counter()
        with profiling.span("loader.read"):
            datas = [_read(p) for p in paths]
        t1 = time.perf_counter()
        with profiling.span("loader.header"):
            info = np.zeros(INFO_WORDS, np.int32)
            heads = [self._header(p, d, info) for p, d in zip(paths, datas)]
            statuses = np.array([h if isinstance(h, int) else 0 for h in heads], np.int32)
            heads = [h if isinstance(h, _Header) else None for h in heads]
            layout, elements = coefficient_layout([h and h.grids for h in heads])
            live = [i for i, lay in enumerate(layout) if lay is not None]
            buffer = buffer_for(elements)
            base = buffer.data_ptr()
            coef_ptrs = np.array([base + 2 * layout[i][1][0] for i in live], np.uint64)
            qt_ptrs = np.array([base + 2 * layout[i][0] for i in live], np.uint64)
            lengths = np.array([len(datas[i]) for i in live], np.uint64)
            got = np.zeros(len(live), np.int32)
        t2 = time.perf_counter()
        if live:
            with profiling.span("loader.entropy"):
                ENTROPY.jpe_decode_batch(
                    self._ctx, (ctypes.c_char_p * len(live))(*[datas[i] for i in live]),
                    lengths.ctypes.data_as(_P(ctypes.c_size_t)), len(live),
                    coef_ptrs.ctypes.data_as(_P(ctypes.c_void_p)),
                    qt_ptrs.ctypes.data_as(_P(ctypes.c_void_p)),
                    got.ctypes.data_as(_P(ctypes.c_int)))
        t3 = time.perf_counter()
        for i, st in zip(live, got.tolist()):
            if st != 0:
                statuses[i], heads[i] = st, None
        coefs = Coefficients(buffer, elements, heads, layout, statuses)
        self.refused += coefs.refused
        return coefs, {"read_ms": 1e3 * (t1 - t0), "info_ms": 1e3 * (t2 - t1),
                       "host_ms": 1e3 * (t3 - t2), "refused": coefs.refused}

    def block_counts(self):
        """(blocks decoded, blocks over the cheap bound of libjpeg-turbo's
        16-bit IDCT lanes, which took the exact check) since the decoder was
        made (``jpe_counts``)."""
        self._check_open()
        counts = np.zeros(2, np.int64)
        with self._lock:
            ENTROPY.jpe_counts(self._ctx, counts.ctypes.data_as(_P(ctypes.c_longlong)))
        return int(counts[0]), int(counts[1])

    def coefficients(self, paths):
        """The files' entropy decode as the route has it before the IDCT: a
        :class:`Coefficients` whose buffer is a CPU tensor of its own."""
        self._check_open()
        with self._lock:
            return self._entropy(paths, lambda n: torch.empty(max(n, 64), dtype=torch.int16))[0]

    def _pinned_for(self, elements):
        """The next pinned coefficient buffer, once its last copy has run,
        grown to ``elements`` int16 values as needed."""
        s = self._turn
        self._turn = (s + 1) % self.PINNED_BUFFERS
        self._copied[s].synchronize()
        buf = self._pinned[s]
        if buf is None or buf.numel() < elements:
            self._pinned[s] = None
            grown = max(elements, 2 * (0 if buf is None else buf.numel()), 64)
            self._pinned[s] = torch.empty(grown, dtype=torch.int16, pin_memory=True)
        self._last = s
        return self._pinned[s]

    # -- the planes --------------------------------------------------------------------

    def _plane_views(self, coefs, buf):
        """Per file the views of its planes in ``buf`` (laid out by
        :func:`plane_layout`), () for a file not decoded; and the planes of
        every component in ``coefs``' order."""
        layout, _ = plane_layout([h and h.planes for h in coefs.headers])
        planes = [()] * len(coefs.headers)
        for i, lay in enumerate(layout):
            if lay is not None:
                planes[i] = tuple(buf[off:off + pitch * h].view(h, pitch)[:, :w]
                                  for w, h, pitch, off in lay)
        return planes, [planes[i][c] for i, c in coefs.files]

    def _planes_cpu(self, paths):
        coefs = self.coefficients(paths)
        _, nbytes = plane_layout([h and h.planes for h in coefs.headers])
        planes, flat = self._plane_views(coefs, torch.empty(max(nbytes, 1), dtype=torch.uint8))
        islow.idct_islow(coefs.buffer, coefs.buffer, coefs.desc, flat)
        return planes, [h.samplings if h else () for h in coefs.headers]

    def _grown(self, name, elements, dtype):
        """The card buffer ``name``, grown as needed; freed and made on the
        decoder's stream, where it is written and read."""
        t = getattr(self, name)
        if t is None or t.numel() < elements:
            setattr(self, name, None)
            t = torch.empty(max(elements, 64), dtype=dtype, device=self.device)
            setattr(self, name, t)
        return t

    def _planes_cuda(self, coefs):
        """The copy of ``coefs`` (the entropy decode, in a pinned buffer)
        to the card and the IDCT kernel into the plane buffer, on the
        decoder's stream (the caller's context).  Returns (planes,
        samplings)."""
        n = coefs.elements if len(coefs.desc) else 0
        dev_coefs = self._grown("_coefs", n, torch.int16)
        with profiling.device_span("loader.copy_in", self.stream):
            if n:
                dev_coefs[:n].copy_(coefs.buffer[:n], non_blocking=True)
        self._copied[self._last].record(self.stream)
        _, nbytes = plane_layout([h and h.planes for h in coefs.headers])
        planes, flat = self._plane_views(coefs, self._grown("_buf", nbytes, torch.uint8))
        with profiling.device_span("loader.idct", self.stream):
            if flat:
                islow.idct_islow_cuda(dev_coefs, dev_coefs, coefs.desc, flat)
        return planes, [h.samplings if h else () for h in coefs.headers]

    def decode_planes(self, paths):
        """Each file's component planes as this route has them before the
        canvas: (planes, samplings), per file a tuple of 2-D uint8 tensors
        at their stored sizes and their (h, v) upsampling factors, () for a
        file the route refuses.  On CUDA the planes are views of the
        decoder's buffer, valid until its next call."""
        if self.device.type == "cpu":
            return self._planes_cpu(paths)
        with self._on_device():
            planes, samplings = self._planes_cuda(self._entropy(paths, self._pinned_for)[0])
            self.stream.synchronize()
        return planes, samplings

    def decode_batch(self, paths, centers, pad_hw, out=None):
        keep = torch.is_tensor(out)  # the canvas stays on the decoder's device
        if keep:
            n, (ph, pw) = len(paths), (int(v) for v in pad_hw)
            centers = checked_centers(centers, n)
            out = ycc.canvas_out(out, (n, ph, pw, 3), self.device)
        else:
            n, (ph, pw), centers, out = batch_args(paths, centers, pad_hw, out)
        if self.device.type == "cpu":
            planes, samplings = self._planes_cpu(paths)
            windows = _windows(planes, centers, (ph, pw))
            ycc.ycc_canvas(planes, samplings, windows, (ph, pw),
                           out=out if keep else torch.from_numpy(out))
            return (DecodedCanvas(out) if keep else out), *_results(windows)
        with self._on_device():
            t0 = time.perf_counter()
            coefs, ms = self._entropy(paths, self._pinned_for)
            with profiling.span("loader.device_decode"):
                planes, samplings = self._planes_cuda(coefs)
                windows = _windows(planes, centers, (ph, pw))
                with profiling.device_span("loader.canvas", self.stream):
                    t1 = time.perf_counter()
                    canvas = ycc.ycc_canvas_cuda(
                        planes, samplings, windows, (ph, pw),
                        out=out if keep else self._canvas_for((n, ph, pw, 3)))
                    desc_ms = 1e3 * (time.perf_counter() - t1)
                if keep:
                    images = DecodedCanvas(out, self.stream)
                else:
                    # the caller's buffer is pinned on the loader's path: a DMA
                    with profiling.device_span("loader.copy_out", self.stream):
                        torch.from_numpy(out).copy_(canvas, non_blocking=True)
                    images = out
                    self.stream.synchronize()
        if self.timing:
            self.times.append({"threads": self.num_threads, **ms, "desc_ms": desc_ms,
                               "total_ms": 1e3 * (time.perf_counter() - t0)})
        return images, *_results(windows)

    def _canvas_for(self, shape):
        if self._canvas is None or tuple(self._canvas.shape) != shape:
            self._canvas = None
            self._canvas = torch.empty(shape, dtype=torch.uint8, device=self.device)
        return self._canvas


class DecodedCanvas:
    """A batch's canvas left on the decoder's device, as
    :meth:`GpuJpegDecoder.decode_batch` returns it for a tensor ``out``:
    ``tensor`` (``out``) and ``ready``, the event recorded on the decoder's
    stream after the last write to it (None on the CPU, where every write
    has ended when it returns).  ``canvas[j] = image`` writes a host image
    ((ph, pw, 3) uint8) into row j on that stream and records ``ready``
    again: the loader's Pillow path for a file the route refused."""

    def __init__(self, tensor, stream=None):
        self.tensor, self.stream, self.ready = tensor, stream, None
        if stream is not None:
            self.ready = torch.cuda.Event()
            self.ready.record(stream)

    def __setitem__(self, j, image):
        src = torch.from_numpy(np.ascontiguousarray(image, np.uint8))
        if self.stream is None:
            self.tensor[j].copy_(src)
            return
        with torch.cuda.stream(self.stream):
            self.tensor[j].copy_(src)  # from pageable memory: returns once copied
        self.ready.record(self.stream)


def _windows(planes, centers, pad_hw):
    """(N, 4) int64 crop windows of the decoded files, zero for the others."""
    windows = np.zeros((len(planes), 4), np.int64)
    for i, pl in enumerate(planes):
        if pl:
            H, W = pl[0].shape
            windows[i] = ycc.crop_window(W, H, centers[i], pad_hw)
    return windows


def _results(windows):
    """(valid_wh (N, 2) int32, offsets (N, 2) int32, ok (N,) bool)."""
    wh = np.ascontiguousarray(windows[:, 2:], np.int32)
    offs = np.ascontiguousarray(windows[:, :2], np.int32)
    ok = (wh > 0).all(axis=1)
    offs[~ok] = 0
    return wh, offs, ok
