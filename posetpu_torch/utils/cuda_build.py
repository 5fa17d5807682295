"""Build the port's native sources at first use and load them with ctypes.

Each source exposes a plain C interface (no PyTorch headers): the CUDA
kernels (``.cu``) compile with ``nvcc`` in seconds, the host JPEG pool
(``native/decode_pool.cpp``) with ``g++``.  The shared library goes into
``posetpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the source text and the compiler flags: an edited source or a
changed flag builds anew, an unchanged one is reused.  Each build writes a
file of its own (named by the process id) and moves it into place with
``os.replace``, so processes that start the same first build at once each
load a whole library.  A failed build raises; nothing falls back to a plain
version.  The registry (:mod:`posetpu_torch.utils.profiling`) counts the
libraries compiled as ``build.compiles``, and :func:`load_library` is the
span ``build.<library>`` (its build, where one is due, and its load).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

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

_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


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


def build(sources, *, compiler=None, flags=NVCC_FLAGS, libs=()) -> dict[str, str]:
    """Compile every source that has no library yet, one compiler process
    per source, all started together: ``compiler flags -o out source
    libs``.  ``compiler`` defaults to ``nvcc``.  Returns {source: library
    path}.  The compiler's report (for ``nvcc``, ``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``<library>.log``."""
    paths = {s: library_path(s, flags, libs) for s in sources}
    todo = [(s, p) for s, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = compiler or _nvcc()
    profiling.count("build.compiles", len(todo))
    procs = []
    try:
        for src, lib in todo:
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [compiler, *flags, "-o", tmp, src, *libs]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((src, lib, tmp, proc))
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate(timeout=_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n{out}")
            with open(f"{lib}.{os.getpid()}.log", "w") as f:
                f.write(out)
            os.replace(f"{lib}.{os.getpid()}.log", lib + ".log")
            os.replace(tmp, lib)  # atomic: a reader never sees half a library
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load_library(source: str, **build_kw) -> ctypes.CDLL:
    """The ctypes handle of ``source``'s library, built if needed
    (``build_kw`` as :func:`build` takes them)."""
    if source not in _loaded:
        stem = os.path.splitext(os.path.basename(source))[0]
        with profiling.span(f"build.{stem}"):
            _loaded[source] = ctypes.CDLL(build([source], **build_kw)[source])
    return _loaded[source]
