"""The card's JPEG decode route: nvJPEG planes and the ``ycc_canvas`` kernel.

:class:`NvjpegDecoder` keeps :class:`~posetpu_torch.native.NativeDecoder`'s
contract and answers.  On CUDA, nvJPEG (``nvjpeg_pool.cu``, the default
backend: Huffman decode on a host thread, IDCT on the card) writes each
file's component planes at their stored sizes into device memory, on
``num_threads`` worker threads as the host pool decodes, the ``ycc_canvas``
kernel (``kernels/ycc_canvas.cu``) upsamples, converts, crops and pads the
whole batch in one launch, and the canvas is copied into the caller's
(pinned) host buffer, or stays on the card in the caller's tensor.  On the
CPU the planes come from libjpeg's raw output
(:func:`posetpu_torch.native.bindings.read_planes`) and the canvas from the
plain functions of :mod:`posetpu_torch.native.ycc`, so the tests reach
every step but nvJPEG and the kernel.

:func:`ycc_canvas` is the kernel's wrapper: plain on CPU tensors, the kernel
on CUDA tensors (or it raises), one launch counted in :data:`LAUNCHES`.
Both libraries build at first use (:mod:`posetpu_torch.utils.cuda_build`);
nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time

import numpy as np
import torch

from posetpu_torch.native import bindings, ycc
from posetpu_torch.native.bindings import (
    JCS_CMYK,
    JCS_GRAYSCALE,
    JCS_RGB,
    JCS_YCBCR,
    JCS_YCCK,
    batch_args,
    checked_centers,
    read_planes,
)
from posetpu_torch.utils import cuda_build
from posetpu_torch.utils.device import resolve_device

_DIR = os.path.dirname(os.path.abspath(__file__))
NVJPEG_SOURCE = os.path.join(_DIR, "nvjpeg_pool.cu")
YCC_SOURCE = os.path.join(_DIR, "kernels", "ycc_canvas.cu")

# the kernel sources of this module built with cuda_build.NVCC_FLAGS alone
SOURCES = (YCC_SOURCE,)

# launches of the kernel since the last reset_launches(), counted where the
# wrapper launches it (the decode runs in loaders' producer threads)
LAUNCHES = {"ycc_canvas": 0}
_count_lock = threading.Lock()

DESC_WORDS = 24  # ycc_canvas.cu's descriptor of one image, in int64 words
PITCH_ALIGN = 256  # row pitch of the planes nvJPEG writes, in bytes

# nvjpeg_pool.cu's status for a C++ exception inside a worker (a forged
# header's allocation, say): that file goes to the Pillow path, as the host
# pool's catch sends it
NVJ_STATUS_EXCEPTION = 65536
# statuses that mean the file cannot be decoded: nvjpegStatus_t's (nvjpeg.h)
# BAD_JPEG, JPEG_NOT_SUPPORTED, INCOMPLETE_BITSTREAM, and the exception's.
# Any other raises.
_FILE_STATUSES = frozenset({3, 4, 10, NVJ_STATUS_EXCEPTION})

_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def reset_launches():
    with _count_lock:  # a loader's thread may be launching
        for name in LAUNCHES:
            LAUNCHES[name] = 0


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


# --- the kernel ---------------------------------------------------------------


@functools.cache
def _ycc_fn():
    """The kernel's launch, its descriptors already on the card."""
    fn = cuda_build.load_library(YCC_SOURCE).ycc_canvas_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _stage_fn():
    """The kernel's launch after staging its descriptors from the host."""
    fn = cuda_build.load_library(YCC_SOURCE).ycc_canvas_stage_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _descriptors(planes, samplings, windows, pad_hw, device):
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
                if w != -(-W // hf) or h != -(-H // vf):  # ycc.component_size
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


STAGING_SLOTS = 2  # descriptor buffers of a device, used in turn


class _Staging:
    """One device's descriptor buffers: STAGING_SLOTS slots used in turn,
    each page-locked host memory and card memory of the same size, grown as
    needed, with the event recorded after the last launch that read them
    (its copy and its kernel).  A launch waits on its slot's event before it
    rewrites the slot, so one call's host work runs while the previous
    call's kernel does; the lock makes each launch one step, as the decode
    runs in loaders' producer threads."""

    def __init__(self, device):
        self.lock = threading.Lock()
        self.device = device
        self.turn = 0
        self.words = [0] * STAGING_SLOTS
        self.buffers = [()] * STAGING_SLOTS  # (host, device) tensors of a slot
        self.pointers = [None] * STAGING_SLOTS  # (host, device, event) for the C call
        self.done = [torch.cuda.Event() for _ in range(STAGING_SLOTS)]
        with torch.cuda.device(device):
            for event in self.done:
                event.record()  # creates the event on its device

    def reserve(self, words):
        """The next slot's pointers for a launch of ``words`` descriptor words."""
        s = self.turn
        self.turn = (s + 1) % STAGING_SLOTS
        if words > self.words[s]:
            self.done[s].synchronize()  # the old buffers are no longer read
            self.words[s] = max(words, 2 * self.words[s])
            self.buffers[s] = ()
            host = torch.empty(self.words[s], dtype=torch.int64, pin_memory=True)
            dev = torch.empty(self.words[s], dtype=torch.int64, device=self.device)
            self.buffers[s] = (host, dev)
            self.pointers[s] = (host.data_ptr(), dev.data_ptr(), self.done[s].cuda_event)
        return self.pointers[s]


_staging = {}
_staging_lock = threading.Lock()


def _canvas_out(out, shape, device):
    """``out`` once checked, or a new uint8 tensor of ``shape`` on ``device``."""
    if out is None:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    if (out.dtype != torch.uint8 or tuple(out.shape) != shape or not out.is_contiguous()
            or out.device != device):
        raise ValueError(f"out must be a contiguous uint8 tensor of shape {shape} on {device}")
    return out


def ycc_canvas_cuda(planes, samplings, windows, pad_hw, out=None):
    """Kernel counterpart of :func:`posetpu_torch.native.ycc.window_canvas`
    for a batch, in one launch on the current stream.  ``planes``: per image
    a tuple of 1 (grayscale) or 3 2-D uint8 CUDA tensors at their stored
    sizes (rows may be padded: any row stride, unit column stride);
    ``samplings``: per image per component (h, v) upsampling factors, the
    luma's (1, 1), the others 1 or 2; ``windows``: (N, 4) (off_x, off_y,
    valid_w, valid_h), (0, 0) sizes for an all-zero slot.  Returns ``out``
    or a new (N, ph, pw, 3) uint8 tensor."""
    ph, pw = (int(p) for p in pad_hw)
    n = len(planes)
    windows = np.asarray(windows, np.int64).reshape(n, 4)
    dev = next((p.device for pl in planes if pl for p in pl), None)
    if out is not None:
        dev = out.device
    if dev is None or dev.type != "cuda":
        raise ValueError("ycc_canvas_cuda takes CUDA tensors")
    desc = _descriptors(planes, samplings, windows, (ph, pw), dev)
    out = _canvas_out(out, (n, ph, pw, 3), dev)
    if n == 0:
        return out
    with _staging_lock:
        if dev.index not in _staging:
            _staging[dev.index] = _Staging(dev)
        st = _staging[dev.index]
    # the descriptors go through the device's staging buffers, in the same C
    # call as the launch
    on_dev = torch.cuda.current_device() == dev.index
    with st.lock, contextlib.nullcontext() if on_dev else torch.cuda.device(dev):
        host, dev_descs, done = st.reserve(desc.size)
        err = _stage_fn()(desc.ctypes.data, host, dev_descs, done, n, ph, pw, out.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ycc_canvas launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES["ycc_canvas"] += 1
    return out


def ycc_canvas(planes, samplings, windows, pad_hw, out=None):
    """:func:`ycc_canvas_cuda` on CUDA tensors; on CPU tensors the plain
    version, :func:`~posetpu_torch.native.ycc.window_canvas` image by image."""
    on_cuda = (out is not None and out.is_cuda) or any(p.is_cuda for pl in planes for p in pl)
    if on_cuda:
        return ycc_canvas_cuda(planes, samplings, windows, pad_hw, out=out)
    if out is None:
        out = torch.empty((len(planes), *(int(p) for p in pad_hw), 3), dtype=torch.uint8)
    for slot, pl, samp, win in zip(out, planes, samplings, np.asarray(windows).reshape(-1, 4)):
        if pl:
            slot.copy_(ycc.window_canvas(pl, samp, win, pad_hw))
        else:
            slot.zero_()
    return out


# --- nvJPEG ---------------------------------------------------------------------

_P = ctypes.POINTER
# nvjpeg_pool.cu's C functions: (restype, argtypes), in its order
SIGNATURES = {
    "nvj_create": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_int, _P(ctypes.c_int)]),
    "nvj_destroy": (None, [ctypes.c_void_p]),
    "nvj_stream": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int]),
    "nvj_info": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                _P(ctypes.c_int)]),
    "nvj_decode_batch": (None, [ctypes.c_void_p, _P(ctypes.c_char_p), _P(ctypes.c_size_t),
                                ctypes.c_int, _P(ctypes.c_void_p), _P(ctypes.c_longlong),
                                _P(ctypes.c_int)]),
}


def default_threads():
    """The workers of a decoder by default: the host pool's rule
    (``NativeDecoder``), ``min(16, os.cpu_count() or 4)``."""
    return min(16, os.cpu_count() or 4)


def _cuda_lib_dir():
    """The toolkit's library directory, which holds libnvjpeg."""
    from torch.utils.cpp_extension import CUDA_HOME

    lib_dir = os.path.join(CUDA_HOME or "/usr/local/cuda", "lib64")
    if not os.path.exists(os.path.join(lib_dir, "libnvjpeg.so")):
        raise RuntimeError(f"no libnvjpeg.so in {lib_dir}: the nvJPEG route cannot build")
    return lib_dir


def _nvjpeg_libs(lib_dir):
    return (f"-L{lib_dir}", "-lnvjpeg", "-lpthread")


@functools.cache
def _nvjpeg_lib():
    """The decoder's library, built if needed, its functions typed once.
    libnvjpeg is loaded first from the toolkit's directory, so the
    library's dependency resolves without a search path."""
    lib_dir = _cuda_lib_dir()
    ctypes.CDLL(os.path.join(lib_dir, "libnvjpeg.so"), mode=ctypes.RTLD_GLOBAL)
    lib = cuda_build.load_library(NVJPEG_SOURCE, libs=_nvjpeg_libs(lib_dir))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def build_all():
    """Build every library of this module at once (the kernel and the
    nvJPEG decoder): {source: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    lib_dir = _cuda_lib_dir()
    with ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(cuda_build.build, SOURCES),
                ex.submit(cuda_build.build, [NVJPEG_SOURCE], libs=_nvjpeg_libs(lib_dir))]
        paths = {}
        for j in jobs:
            paths.update(j.result())
    return paths


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
    """The (w, h) of the three planes nvJPEG's YUV output may write for a
    W x H file at ``samplings`` (per component (h, v)): a grayscale file's
    luma, and room for chroma planes of its size."""
    if len(samplings) == 1:
        return [(W, H)] * 3
    return [(W, H)] + [ycc.component_size(W, H, *s) for s in samplings[1:]]


def plane_layout(sizes):
    """Where the files' planes go in one device buffer.  ``sizes``: per
    file None (not decoded) or its planes' (w, h).  Returns (per file None
    or [(w, h, pitch, offset)] a plane, the buffer's bytes): rows padded to
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


class DecodedCanvas:
    """A batch's canvas left on the decoder's device, as
    :meth:`NvjpegDecoder.decode_batch` returns it for a tensor ``out``:
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


class NvjpegDecoder:
    """JPEG batch decoder on the card, with :class:`NativeDecoder`'s
    contract: ``decode_batch(paths, centers, pad_hw, out=None) -> (images,
    valid_wh, offsets, ok)`` (see ``native/bindings.py``).  A file that
    does not decode, or that libjpeg's ``JCS_RGB`` output would not give
    through upsampling and YCbCr conversion (CMYK, RGB-coded, 4:1:1),
    reads all zero with ``ok`` False, for the caller's Pillow path.

    ``device``: "cuda" (the default; raises without CUDA), "cuda:N", or
    "cpu" for the plain route.  ``num_threads``: nvJPEG's worker threads on
    CUDA, each with its own nvJPEG state and stream (None:
    :func:`default_threads`, the host pool's rule); the decoder raises if
    it cannot start them all.  A batch's files are decoded on the workers
    in one call (the GIL released), then the kernel makes the canvas on the
    decoder's own stream, whatever thread calls it.  Calls are serialised.
    The CPU route is the plain version and reads the files in turn: its
    batch is the same for every ``num_threads``.  A failed build, a CUDA
    error or any other nvJPEG status raises.

    ``out``: None or a host uint8 array, as ``NativeDecoder`` takes (on
    CUDA the canvas is copied into it, and the call returns once it is
    there); or a contiguous (n, ph, pw, 3) uint8 tensor on the decoder's
    device (see :meth:`canvas`): the kernel writes into it, nothing comes
    back to the host, and ``images`` is a :class:`DecodedCanvas` whose
    ``ready`` event orders a reader after the last write.

    ``timing=True`` appends to :attr:`times` one dict a batch: ``threads``,
    ``read_ms`` (reading the files), ``info_ms`` (parsing their headers and
    laying out their planes; on the buffer's reuse, the wait for the last
    kernel that read it), ``host_ms`` (the wall time of the workers'
    decode of the batch), ``desc_ms`` (the host clock of the kernel's wrapper: its
    checks, the descriptors, their staging and the launch), ``canvas_ms``
    (from the decodes' end to the canvas: ``desc_ms`` while the stream
    waits, then the descriptors' copy and the kernel) and ``copy_ms`` (the
    canvas into a host ``out``; 0 for a tensor ``out``), both from CUDA
    events on the decoder's stream, and ``total_ms``.  With a tensor
    ``out`` a timed call waits for its canvas before it returns.
    """

    def __init__(self, device="cuda", timing=False, num_threads=None):
        dev = resolve_device(device)
        self.timing = timing
        self.times = []
        self.num_threads = int(num_threads or default_threads())
        self._lock = threading.Lock()
        self._ctx = None
        if dev.type == "cpu":
            bindings._lib()  # build now: a failed build raises here
            self.device = dev
            return
        self.device = torch.device("cuda", torch.cuda.current_device()
                                   if dev.index is None else dev.index)
        self._lib = _nvjpeg_lib()
        _ycc_fn()
        status = ctypes.c_int(0)
        with torch.cuda.device(self.device):  # restores this thread's device
            ctx = self._lib.nvj_create(self.device.index, self.num_threads, ctypes.byref(status))
        if not ctx:
            raise RuntimeError(f"nvJPEG decoder on {self.device} with {self.num_threads} "
                               f"threads failed: status {status.value}")
        self._ctx = ctx
        self.stream = torch.cuda.Stream(self.device)
        self._buf = None
        self._canvas = None
        self._planes_read = None  # recorded after the last kernel that read the buffer

    def close(self):
        if self._ctx:
            with torch.cuda.device(self.device):
                self._lib.nvj_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def worker_streams(self):
        """The workers' streams (``torch.cuda.ExternalStream``), where
        nvJPEG's copies and IDCTs run."""
        if not self._ctx:
            raise RuntimeError("NvjpegDecoder used after close()")
        return [torch.cuda.ExternalStream(self._lib.nvj_stream(self._ctx, i), self.device)
                for i in range(self.num_threads)]

    @contextlib.contextmanager
    def _on_device(self):
        """Serialised, on the decoder's device and stream."""
        if not self._ctx:
            raise RuntimeError("NvjpegDecoder used after close()")
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

    def decode_planes(self, paths):
        """Each file's component planes as this route has them before the
        canvas: (planes, samplings), per file a tuple of 2-D uint8 tensors
        at their stored sizes and their (h, v) upsampling factors, () for a
        file the route refuses.  On CUDA the planes are nvJPEG's, views of
        the decoder's buffer, valid until its next call."""
        if self.device.type == "cpu":
            return self._planes_cpu(paths)
        with self._on_device():
            planes, samplings, _ = self._planes_cuda(paths)
            self.stream.synchronize()
        return planes, samplings

    def decode_batch(self, paths, centers, pad_hw, out=None):
        keep = torch.is_tensor(out)  # the canvas stays on the decoder's device
        if keep:
            n, (ph, pw) = len(paths), (int(v) for v in pad_hw)
            centers = checked_centers(centers, n)
            out = _canvas_out(out, (n, ph, pw, 3), self.device)
        else:
            n, (ph, pw), centers, out = batch_args(paths, centers, pad_hw, out)
        if self.device.type == "cpu":
            planes, samplings = self._planes_cpu(paths)
            windows = _windows(planes, centers, (ph, pw))
            ycc_canvas(planes, samplings, windows, (ph, pw),
                       out=out if keep else torch.from_numpy(out))
            return (DecodedCanvas(out) if keep else out), *_results(windows)
        with self._on_device():
            t0 = time.perf_counter()
            planes, samplings, ms = self._planes_cuda(paths)
            windows = _windows(planes, centers, (ph, pw))
            if self.timing:
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                marks[0].record(self.stream)
            t1 = time.perf_counter()
            canvas = ycc_canvas_cuda(planes, samplings, windows, (ph, pw),
                                     out=out if keep else self._canvas_for((n, ph, pw, 3)))
            desc_ms = 1e3 * (time.perf_counter() - t1)
            self._planes_read = torch.cuda.Event()
            self._planes_read.record(self.stream)
            if self.timing:
                marks[1].record(self.stream)
            if keep:
                images = DecodedCanvas(out, self.stream)
            else:
                # the caller's buffer is pinned on the loader's path: a DMA
                torch.from_numpy(out).copy_(canvas, non_blocking=True)
                images = out
            if self.timing:
                marks[2].record(self.stream)
            if not keep:
                self.stream.synchronize()
            elif self.timing:
                marks[2].synchronize()
        if self.timing:
            self.times.append({"threads": self.num_threads, **ms, "desc_ms": desc_ms,
                               "canvas_ms": marks[0].elapsed_time(marks[1]),
                               "copy_ms": 0.0 if keep else marks[1].elapsed_time(marks[2]),
                               "total_ms": 1e3 * (time.perf_counter() - t0)})
        return images, *_results(windows)

    def _planes_cpu(self, paths):
        planes, samplings = [()] * len(paths), [()] * len(paths)
        for i, path in enumerate(paths):
            got = read_planes(path)
            if got is None:
                continue
            color, factors, pl = got
            hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
            samp = [(hmax // h, vmax // v) if hmax % h == 0 and vmax % v == 0 else (0, 0)
                    for h, v in factors]
            if _supported(color, samp):
                planes[i] = tuple(torch.from_numpy(p) for p in pl)
                samplings[i] = samp
        return planes, samplings

    def _buffer(self, nbytes):
        """The planes' device buffer, grown as needed (written by the
        workers and read by the kernel on this decoder's stream; the caller
        has waited for the last kernel that read it)."""
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None
            self._buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=self.device)
        return self._buf

    def _canvas_for(self, shape):
        if self._canvas is None or tuple(self._canvas.shape) != shape:
            self._canvas = None
            self._canvas = torch.empty(shape, dtype=torch.uint8, device=self.device)
        return self._canvas

    def _header(self, path, data, info):
        """(samplings, plane sizes) of a file the route decodes, else None."""
        if data is None:
            return None
        st = self._lib.nvj_info(self._ctx, data, len(data),
                                info.ctypes.data_as(_P(ctypes.c_int)))
        if st in _FILE_STATUSES:
            return None
        if st != 0:
            raise RuntimeError(f"nvjpegGetImageInfo failed on {path}: status {st}")
        nc, hf, vf = int(info[0]), int(info[1]), int(info[2])
        W, H = int(info[4]), int(info[7])
        samp = [(1, 1)] + [(hf, vf)] * (nc - 1) if nc in (1, 3) else []
        if not samp or not _supported(jpeg_color_space(data), samp):
            return None
        sizes = plane_sizes(samp, W, H)
        got = [(int(info[4 + c]), int(info[7 + c])) for c in range(nc)]
        if got != sizes[:nc]:
            raise RuntimeError(f"nvJPEG's component sizes {got} for {path} are not "
                               f"libjpeg's {sizes[:nc]}")
        return samp, sizes

    def _planes_cuda(self, paths):
        """Read the files, parse their headers, lay their planes out in the
        buffer (rows padded to PITCH_ALIGN) and decode them all with one
        ``nvj_decode_batch`` on the workers (each waits for its own file's
        work: nvJPEG's next host phase reuses its state's pinned buffer).
        The reads and headers stay on the calling thread: on an H100
        host, threads read these files no faster, and the headers take
        about a millisecond a batch (PERF.md §6).  Returns
        (planes, samplings, {"read_ms", "info_ms", "host_ms"})."""
        t0 = time.perf_counter()
        datas = [_read(p) for p in paths]
        t1 = time.perf_counter()
        info = np.zeros(11, np.int32)
        heads = [self._header(p, d, info) for p, d in zip(paths, datas)]
        layout, nbytes = plane_layout([h and h[1] for h in heads])
        live = [i for i, lay in enumerate(layout) if lay is not None]
        ptrs = np.array([off for i in live for *_, off in layout[i]], np.uint64)
        pitches = np.array([pitch for i in live for _, _, pitch, _ in layout[i]], np.int64)
        lengths = np.array([len(datas[i]) for i in live], np.uint64)
        statuses = np.zeros(len(live), np.int32)
        if self._planes_read is not None:
            self._planes_read.synchronize()  # the last kernel no longer reads the buffer
        buf = self._buffer(nbytes)
        ptrs += np.uint64(buf.data_ptr())
        t2 = time.perf_counter()
        self._lib.nvj_decode_batch(
            self._ctx, (ctypes.c_char_p * len(live))(*[datas[i] for i in live]),
            lengths.ctypes.data_as(_P(ctypes.c_size_t)), len(live),
            ptrs.ctypes.data_as(_P(ctypes.c_void_p)), pitches.ctypes.data_as(_P(ctypes.c_longlong)),
            statuses.ctypes.data_as(_P(ctypes.c_int)))
        t3 = time.perf_counter()
        planes, samplings = [()] * len(paths), [()] * len(paths)
        for i, st in zip(live, statuses.tolist()):
            if st in _FILE_STATUSES:
                continue
            if st != 0:
                raise RuntimeError(f"nvjpegDecode failed on {paths[i]}: status {st}")
            samp = heads[i][0]
            planes[i] = tuple(buf[off:off + pitch * h].view(h, pitch)[:, :w]
                              for w, h, pitch, off in layout[i][:len(samp)])
            samplings[i] = samp
        return planes, samplings, {"read_ms": 1e3 * (t1 - t0), "info_ms": 1e3 * (t2 - t1),
                                   "host_ms": 1e3 * (t3 - t2)}


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
