"""Time the two ways of building the rasterizer kernel on a CUDA machine.

    python -m posetpu_torch.tools.cuda_build_time

1. The port's route (:mod:`posetpu_torch.utils.cuda_build`): ``nvcc``
   compiles ``aug/kernels/rasterize.cu``, which has a plain C interface, into
   a library loaded with ``ctypes``.
2. ``torch.utils.cpp_extension.load_inline``: the same source plus a small
   binding that includes PyTorch's headers, built with ninja into a Python
   extension module.

Both start from empty build directories under ``posetpu_torch/_build/``
and use the same ``nvcc`` flags.  The extension's output is then checked
against the port's kernel on one input, so a build that produced a broken
module does not count.  Prints one JSON line, then the nvidia-smi name and
power-limit line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

import torch

from posetpu_torch.aug import cuda_kernels
from posetpu_torch.aug.heatmap import raster_constants
from posetpu_torch.utils import cuda_build
from posetpu_torch.utils.device import resolve_device

_BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

extern "C" int rasterize_gaussians_launch(
    const float*, const float*, float*, float*, int, int, int,
    float, float, float, cudaStream_t);

std::vector<torch::Tensor> rasterize(torch::Tensor pts, torch::Tensor vis,
                                     int64_t H, int64_t W, double denom,
                                     double win, double s3) {
  auto out = torch::empty({pts.size(0), pts.size(1), H, W}, pts.options());
  auto vis_out = torch::empty_like(vis);
  int err = rasterize_gaussians_launch(
      pts.data_ptr<float>(), vis.data_ptr<float>(), out.data_ptr<float>(),
      vis_out.data_ptr<float>(), (int)(pts.size(0) * pts.size(1)), (int)H,
      (int)W, (float)denom, (float)win, (float)s3,
      c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == 0, "rasterize launch failed: ", err);
  return {out, vis_out};
}
"""


_BASE = os.path.join(cuda_build.BUILD_DIR, "build_time")


def _fresh(name):
    path = os.path.join(_BASE, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def main():
    from torch.utils import cpp_extension

    dev = resolve_device("cuda")
    cpp_extension.verify_ninja_availability()

    cuda_build.BUILD_DIR = _fresh("ctypes")
    cuda_build._loaded.clear()
    t0 = time.perf_counter()
    cuda_build.build([cuda_kernels.RASTERIZE_SOURCE])
    ctypes_s = time.perf_counter() - t0

    with open(cuda_kernels.RASTERIZE_SOURCE) as f:
        source = f.read()
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    t0 = time.perf_counter()
    ext = cpp_extension.load_inline(
        name="rasterize_ext", cpp_sources=[_BINDING], cuda_sources=[source],
        functions=["rasterize"], extra_cuda_cflags=flags,
        build_directory=_fresh("cpp_extension"), verbose=False,
    )
    ext_s = time.perf_counter() - t0

    g = torch.Generator().manual_seed(0)
    pts = torch.randint(-10, 74, (32, 16, 2), generator=g).float().to(dev)
    vis = torch.randint(0, 2, (32, 16), generator=g).float().to(dev)
    consts = raster_constants(1.0)
    want = cuda_kernels.rasterize_gaussians_cuda(pts, vis, (64, 64), *consts)
    got = ext.rasterize(pts, vis, 64, 64, *consts)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("the cpp_extension build disagrees with the port's kernel")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "ctypes_nvcc_s": ctypes_s,
        "cpp_extension_load_inline_s": ext_s,
        "cpus": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
