"""posetpu_torch.utils.cuda_build without a GPU: libraries are keyed by
source text, every source is compiled once, and a failed or impossible
build raises (nothing falls back to a plain version).  Every native source
of the package is declared once in posetpu_torch.libraries, and each
declared entry point's ctypes are its C declaration's."""

import collections
import ctypes
import os
import re
import stat

import pytest
import torch.utils.cpp_extension

from posetpu_torch.aug import cuda_kernels
from posetpu_torch.libraries import LIBRARIES
from posetpu_torch.utils import cuda_build, profiling

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(cuda_build.__file__)))

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
    libs = [cuda_build.Library(src, {}) for src in srcs]
    paths = cuda_build.build(libs)
    assert set(paths) == set(srcs)
    for lib in paths.values():
        assert open(lib).read() == "built\n"
        assert "registers" in open(lib + ".log").read()
    assert len(calls.read_text().splitlines()) == 2
    assert "arch=compute_90a,code=sm_90a" in calls.read_text()
    assert cuda_build.build(libs) == paths  # present: not compiled again
    assert len(calls.read_text().splitlines()) == 2
    assert not [n for n in os.listdir(cuda_build.BUILD_DIR) if n.endswith(".tmp")]


def test_failed_compile_raises_with_its_output(build_dir, monkeypatch):
    nvcc = build_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: expected a ;'\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    src = _source(build_dir / "bad.cu", "not c++\n")
    with pytest.raises(RuntimeError, match="expected a ;"):
        cuda_build.build([cuda_build.Library(src, {})])
    assert not os.path.exists(cuda_build.library_path(src))


def test_missing_nvcc_raises(build_dir, monkeypatch):
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    src = _source(build_dir / "k.cu", "// kernel\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build([cuda_build.Library(src, {})])


def test_every_kernel_source_ships_with_the_package():
    """Every C++ and CUDA source of the package is declared once in the one
    list, and every declared source exists."""
    found = [os.path.join(root, name)
             for root, dirs, files in os.walk(PACKAGE) if "_build" not in root.split(os.sep)
             for name in files if name.endswith((".cu", ".cpp"))]
    declared = collections.Counter(os.path.abspath(lib.source) for lib in LIBRARIES)
    assert found and sorted(declared) == sorted(found)
    assert set(declared.values()) == {1}
    assert all(os.path.isfile(lib.source) for lib in LIBRARIES)


def test_launch_function_is_looked_up_and_typed_once(monkeypatch):
    """A declaration builds and loads its library at the first read of an
    entry point, types every entry point then, once per process, and hands
    out the same function on every later read; count_launch counts a
    launch that returned 0 and raises on any other status."""
    loads = []

    class Lib:
        def __init__(self):
            self.rasterize_gaussians_launch = type("Fn", (), {})()

    def build(libraries):
        return {lib.source: lib.source + ".so" for lib in libraries}

    def cdll(path):
        loads.append(path)
        return Lib()

    monkeypatch.setattr(cuda_build, "build", build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", cdll)
    lib = cuda_build.Library(cuda_kernels.RASTERIZE.source, cuda_kernels.RASTERIZE.functions)
    fn = lib.rasterize_gaussians_launch
    assert lib.rasterize_gaussians_launch is fn and lib.load() is lib.load()
    assert loads == [cuda_kernels.RASTERIZE.source + ".so"]
    # pointers and the stream as c_void_p (a c_int would cut them)
    assert fn.argtypes == (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_void_p]
    )
    assert fn.restype is ctypes.c_int
    with pytest.raises(AttributeError):
        lib.no_such_launch
    name = "test.cuda_build_launches"
    cuda_build.count_launch(0, "rasterize_gaussians", name)
    with pytest.raises(RuntimeError, match="rasterize_gaussians launch failed: CUDA error 700"):
        cuda_build.count_launch(700, "rasterize_gaussians", name)
    assert profiling.counter(name) == 1
    profiling.reset_counters(name)


def test_build_takes_another_compiler_with_libraries_after_the_source(build_dir, monkeypatch):
    """The host libraries' g++ builds go through cuda_build.build, in one
    call with the kernels': each library its own compiler and flags, the
    link libraries after the source (a linker reads them in order), and
    both key the library's name."""
    calls = build_dir / "calls.txt"
    for name in ("gxx", "nvcc"):
        tool = build_dir / name
        tool.write_text(FAKE_NVCC.format(calls=calls))
        tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_gxx", lambda: str(build_dir / "gxx"))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(build_dir / "nvcc"))
    src = _source(build_dir / "pool.cpp", "// pool\n")
    kernel = _source(build_dir / "k.cu", "// kernel\n")
    libs = ("-ljpeg", "-lpthread")
    pool = cuda_build.Library(src, {}, toolchain="g++", libs=libs)
    paths = cuda_build.build([pool, cuda_build.Library(kernel, {})])
    line = calls.read_text().splitlines()
    gxx_line = next(ln.split() for ln in line if ln.endswith(" ".join(libs)))
    flags = cuda_build.GXX_FLAGS
    assert gxx_line == [*flags, "-o", gxx_line[len(flags) + 1], src, *libs]
    assert len(line) == 2 and any(ln.endswith(kernel) for ln in line)
    assert os.path.basename(paths[src]).startswith("pool-")
    assert paths[src] == cuda_build.library_path(src, flags, libs) == pool.path()
    assert cuda_build.library_path(src, flags) != paths[src]
    assert cuda_build.library_path(src) != cuda_build.library_path(src, flags)
    assert paths[kernel] == cuda_build.library_path(kernel)
    assert open(paths[src]).read() == "built\n"
    with pytest.raises(ValueError, match="toolchain"):
        cuda_build.Library(src, {}, toolchain="clang")


_P = ctypes.POINTER
# the ctypes a C scalar type may be given
SCALARS = {"int": {ctypes.c_int}, "int32_t": {ctypes.c_int32}, "int64_t": {ctypes.c_int64},
           "long long": {ctypes.c_longlong}, "size_t": {ctypes.c_size_t},
           "float": {ctypes.c_float}, "uint8_t": {ctypes.c_uint8}, "char": {ctypes.c_char},
           "unsigned char": {ctypes.c_ubyte}, "cudaStream_t": {ctypes.c_void_p},
           "void": {None}}


def _ctypes_for(ctype):
    """The ctypes that may stand for C type ``ctype`` (``const`` dropped): a
    scalar's own; for a pointer, c_void_p (an address, such as a tensor's
    ``data_ptr()``) or a pointer to what it points at, and for a pointer to
    char, bytes (c_char_p)."""
    t = " ".join(re.sub(r"\s*\*\s*", "*", re.sub(r"\bconst\b", "", ctype)).split())
    if not t.endswith("*"):
        return SCALARS[t]
    inner = t[:-1]
    allowed = {ctypes.c_void_p} | {_P(c) for c in _ctypes_for(inner) if c is not None}
    if inner in ("char", "unsigned char"):
        allowed.add(ctypes.c_char_p)
    return allowed


def _c_functions(path):
    """{name: (C return type, [C parameter types])} of the functions that
    ``path`` defines with C linkage: in an ``extern "C" {`` block (closed
    by ``}  // extern "C"``), or on a line that begins ``extern "C"``."""
    with open(path) as f:
        src = f.read()
    definition = r"(\w[\w ]*?\**)\s*\b(\w+)\(([^)]*)\)\s*\{"
    found = re.findall(r'^extern "C" ' + definition, src, re.M)
    for block in re.findall(r'^extern "C" \{(.*?)^\}\s*// extern "C"', src, re.M | re.S):
        found += re.findall("^" + definition, block, re.M)
    out = {}
    for ret, name, params in found:
        types = [re.sub(r"\s*\b\w+$", "", " ".join(p.split()))
                 for p in params.split(",") if p.strip()]
        out[name] = (ret.strip(), types)
    return out


ENTRY_POINTS = [(lib, name) for lib in LIBRARIES for name in lib.functions]


@pytest.mark.parametrize("lib, name", ENTRY_POINTS, ids=[n for _, n in ENTRY_POINTS])
def test_ctypes_signatures_match_the_source(lib, name):
    """Each declared entry point is defined with C linkage in its library's
    source, and its restype and argtypes are its C declaration's."""
    decl = _c_functions(lib.source)
    assert name in decl, sorted(decl)
    ret, params = decl[name]
    restype, argtypes = lib.functions[name]
    assert restype in _ctypes_for(ret), (ret, restype)
    assert len(argtypes) == len(params), params
    for param, argtype in zip(params, argtypes):
        assert argtype in _ctypes_for(param), (param, argtype)
