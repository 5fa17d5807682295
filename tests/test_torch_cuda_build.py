"""posetpu_torch.utils.cuda_build without a GPU: libraries are keyed by
source text, every source is compiled once, and a failed or impossible
build raises (nothing falls back to a plain version)."""

import ctypes
import os
import stat

import pytest
import torch.utils.cpp_extension

from posetpu_torch.aug import cuda_kernels
from posetpu_torch.utils import cuda_build

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: records the call, writes the file named after -o
echo "$@" >> "{calls}"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
echo "ptxas info    : Used 1 registers"
"""


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def _source(path, text):
    path.write_text(text)
    return str(path)


def test_library_path_is_keyed_by_source_text(build_dir):
    src = _source(build_dir / "k.cu", 'extern "C" int f() { return 0; }\n')
    first = cuda_build.library_path(src)
    assert first == cuda_build.library_path(src)
    assert os.path.dirname(first) == cuda_build.BUILD_DIR
    _source(build_dir / "k.cu", 'extern "C" int f() { return 1; }\n')
    assert cuda_build.library_path(src) != first


def test_build_compiles_each_source_once(build_dir, monkeypatch):
    calls = build_dir / "calls.txt"
    nvcc = build_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    srcs = [_source(build_dir / f"k{i}.cu", f"// kernel {i}\n") for i in range(2)]
    paths = cuda_build.build(srcs)
    assert set(paths) == set(srcs)
    for lib in paths.values():
        assert open(lib).read() == "built\n"
        assert "registers" in open(lib + ".log").read()
    assert len(calls.read_text().splitlines()) == 2
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    assert cuda_build.build(srcs) == paths  # present: not compiled again
    assert len(calls.read_text().splitlines()) == 2
    assert not [n for n in os.listdir(cuda_build.BUILD_DIR) if n.endswith(".tmp")]


def test_failed_compile_raises_with_its_output(build_dir, monkeypatch):
    nvcc = build_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: expected a ;'\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    src = _source(build_dir / "bad.cu", "not c++\n")
    with pytest.raises(RuntimeError, match="expected a ;"):
        cuda_build.build([src])
    assert not os.path.exists(cuda_build.library_path(src))


def test_missing_nvcc_raises(build_dir, monkeypatch):
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    src = _source(build_dir / "k.cu", "// kernel\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build([src])


def test_every_kernel_source_ships_with_the_package():
    assert cuda_kernels.SOURCES
    for src in cuda_kernels.SOURCES:
        assert os.path.isfile(src) and src.endswith(".cu")


def test_launch_function_is_looked_up_and_typed_once(monkeypatch):
    """The ctypes launch function is fetched and given its argtypes once per
    process, not on every launch."""
    loads = []

    class Lib:
        def __init__(self):
            self.rasterize_gaussians_launch = type("Fn", (), {})()

    def load(source):
        loads.append(source)
        return Lib()

    monkeypatch.setattr(cuda_build, "load_library", load)
    cuda_kernels._rasterize_fn.cache_clear()
    try:
        fn = cuda_kernels._rasterize_fn()
        assert cuda_kernels._rasterize_fn() is fn
    finally:
        cuda_kernels._rasterize_fn.cache_clear()
    assert loads == [cuda_kernels.RASTERIZE_SOURCE]
    # pointers and the stream as c_void_p (a c_int would cut them)
    assert fn.argtypes == (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_void_p]
    )
    assert fn.restype is ctypes.c_int


def test_build_takes_another_compiler_with_libraries_after_the_source(build_dir):
    """The host pool's g++ build shares this builder: the compiler and its
    flags are the caller's, the libraries follow the source (a linker reads
    them in order), and both key the library's name."""
    calls = build_dir / "calls.txt"
    gxx = build_dir / "gxx"
    gxx.write_text(FAKE_NVCC.format(calls=calls))
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    src = _source(build_dir / "pool.cpp", "// pool\n")
    flags, libs = ("-O3", "-shared"), ("-ljpeg", "-lpthread")
    paths = cuda_build.build([src], compiler=str(gxx), flags=flags, libs=libs)
    line = calls.read_text().split()
    assert line == [*flags, "-o", line[3], src, *libs]
    assert os.path.basename(paths[src]).startswith("pool-")
    assert paths[src] == cuda_build.library_path(src, flags, libs)
    assert cuda_build.library_path(src, flags) != paths[src]
    assert cuda_build.library_path(src) != cuda_build.library_path(src, flags)
    assert open(paths[src]).read() == "built\n"
