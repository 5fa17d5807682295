"""Build the port's native libraries at first use and load them with ctypes.

Each library is one :class:`Library`, declared beside the code that calls
it: a source with a plain C interface (no PyTorch headers), its toolchain
and its C entry points.  The CUDA kernels (``.cu``) compile with ``nvcc``
in seconds, the host libraries (``.cpp``) with ``g++``.  The shared library
goes into ``posetpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source text and the compiler flags: an edited source
or a changed flag builds anew, an unchanged one is reused.  Each build
writes a file of its own (named by the process id) and moves it into place
with ``os.replace``, so processes that start the same first build at once
each load a whole library.  A failed build raises; nothing falls back to a
plain version.  The registry (:mod:`posetpu_torch.utils.profiling`) counts
the libraries compiled as ``build.compiles``, and :meth:`Library.load` is
the span ``build.<library>`` (its build, where one is due, and its load).
:mod:`posetpu_torch.libraries` lists every library of the port.  What the
wrappers' launches share lives here too: :func:`sm_count`,
:func:`ticket_slot` (for kernels whose last block finishes the work) and
:func:`count_launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from posetpu_torch.utils import profiling

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)

# sm_90a: Hopper with its architecture-specific features.  No fast math:
# the kernels divide and exponentiate exactly as their plain versions do;
# --fmad=false keeps a*b+c from contracting into an FMA for the same reason.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# the host libraries' g++ flags; each library adds its link libraries after
# the source
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_TIMEOUT_S = 600


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host libraries cannot build")
    return gxx


def library_path(source: str, flags=NVCC_FLAGS, libs=()) -> str:
    """Where the library built from ``source`` with ``flags`` (before the
    source) and ``libs`` (after it) lives."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update("\0".join(flags).encode())
    if libs:
        h.update(b"\1" + "\0".join(libs).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


class Library:
    """One native library: ``source``, built with ``nvcc`` and
    :data:`NVCC_FLAGS` or, with ``toolchain="g++"``, with ``g++``,
    :data:`GXX_FLAGS` and the link libraries ``libs``; and its C entry
    points, ``functions`` {name: (restype, argtypes)}.

    Nothing builds until an entry point is first read: then the library is
    built if needed and loaded (:meth:`load`), and every entry point, typed
    once, becomes an attribute of this declaration, so that a launch looks
    up no more than that attribute.  Raises RuntimeError where the library
    cannot build."""

    def __init__(self, source, functions, *, toolchain="nvcc", libs=()):
        if toolchain not in ("nvcc", "g++"):
            raise ValueError(f"toolchain must be nvcc or g++, got {toolchain!r}")
        self.source, self.functions = source, functions
        self.toolchain, self.libs = toolchain, tuple(libs)
        self.flags = NVCC_FLAGS if toolchain == "nvcc" else GXX_FLAGS
        self.stem = os.path.splitext(os.path.basename(source))[0]
        self._lock = threading.Lock()
        self._handle = None

    def path(self) -> str:
        return library_path(self.source, self.flags, self.libs)

    def compiler(self) -> str:
        return _nvcc() if self.toolchain == "nvcc" else _gxx()

    def load(self) -> ctypes.CDLL:
        """The ctypes handle, built if needed, its entry points typed and
        set on this declaration once a process."""
        with self._lock:
            if self._handle is None:
                with profiling.span(f"build.{self.stem}"):
                    handle = ctypes.CDLL(build([self])[self.source])
                for name, (restype, argtypes) in self.functions.items():
                    fn = getattr(handle, name)
                    fn.restype, fn.argtypes = restype, argtypes
                    setattr(self, name, fn)
                self._handle = handle
        return self._handle

    def __getattr__(self, name):
        # reached for an entry point only before the first load
        if name in self.__dict__.get("functions", ()):
            self.load()
            return self.__dict__[name]
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")


def build(libraries) -> dict[str, str]:
    """Compile every one of ``libraries`` (:class:`Library`) that has no
    library file yet, one compiler process each, all started together:
    ``compiler flags -o out source libs``.  Returns {source: library path}.
    The compiler's report (for ``nvcc``, ``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<library>.log``."""
    paths = {lib.source: lib.path() for lib in libraries}
    todo = [(lib, paths[lib.source]) for lib in libraries
            if not os.path.exists(paths[lib.source])]
    if not todo:
        return paths
    compilers = [lib.compiler() for lib, _ in todo]
    os.makedirs(BUILD_DIR, exist_ok=True)
    profiling.count("build.compiles", len(todo))
    procs = []
    try:
        for compiler, (lib, out) in zip(compilers, todo):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [compiler, *lib.flags, "-o", tmp, lib.source, *lib.libs]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((compiler, lib.source, out, tmp, proc))
        for compiler, src, out, tmp, proc in procs:
            log, _ = proc.communicate(timeout=_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n{log}")
            with open(f"{out}.{os.getpid()}.log", "w") as f:
                f.write(log)
            os.replace(f"{out}.{os.getpid()}.log", out + ".log")
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    finally:
        for *_, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


# the ticket slots of a kernel that finishes in its last block to arrive:
# each such library declares this many (kTicketSlots)
TICKET_SLOTS = 64
_slots: dict[tuple[int, int], int] = {}


def ticket_slot(index, stream):
    """A ticket slot for ``stream`` on device ``index``: one a stream, so
    that launches on two streams never share one.  Each library keeps its
    own tickets, so one numbering serves them all."""
    key = (index, stream)
    if key not in _slots:
        _slots[key] = len(_slots) % TICKET_SLOTS
    return _slots[key]


def sm_count(device):
    """The SMs of CUDA ``device``."""
    return _sms(torch.device(device).index)


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_launch(err, kernel, counter):
    """After a launch that returned ``err`` (its cudaError_t): raise unless
    it is 0, else add one to the registry's ``counter``."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    profiling.count(counter)
