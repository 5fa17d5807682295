// Gaussian target rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel posetpu/aug/pallas_kernels.py:rasterize_gaussians_pallas
// (body _rasterize_kernel).  For each (sample, joint) row it writes
//
//     g[y, x] = exp(-(dx^2 + dy^2) / (2 sigma^2)) * [|dx| <= 3 sigma] * [|dy| <= 3 sigma]
//
// over the H*W heatmap, zeroed unless vis > 0 and the integer window
// [pt - int(3 sigma), pt + int(3 sigma) + 1) overlaps the map; vis_out gets
// the same keep flag.  Its plain version is
// posetpu_torch/aug/heatmap.py:rasterize_gaussians_plain.
//
// Bound: the output write.  It reads 12 bytes per row and writes 4*H*W, and
// does about fifteen float operations per output element, far below
// Hopper's ratio of operations to bytes, so the floor is the HBM write
// (8.4 MB at 32x16x64x64).
//
// Design: one thread per output pixel over a grid of (pixel tiles, rows).
// Neighbouring threads write neighbouring floats, so every warp stores 128
// contiguous bytes.  Rows beyond rows_total are never touched: the bounds
// check replaces the TPU kernel's -1e6 row padding.  The TPU kernel filled
// one (8, H*W) VMEM block per grid step; here no block carries anything to
// the next, and no shared memory is needed.
//
// Numerics: IEEE division and expf (no fast math), and explicit
// round-to-nearest intrinsics so that dx*dx + dy*dy never becomes an FMA.
// That keeps the kernel bit-comparable with the plain version, which runs
// each operation as its own rounded step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void rasterize_gaussians_kernel(
    const float* __restrict__ pts,   // (rows, 2): x, y, 0-indexed, integer-valued
    const float* __restrict__ vis,   // (rows,)
    float* __restrict__ out,         // (rows, H*W)
    float* __restrict__ vis_out,     // (rows,)
    int rows, int H, int W,
    float denom,                     // 2 sigma^2
    float win,                       // 3 sigma
    float s3) {                      // float(int(3 sigma))
  const int hw = H * W;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float px = pts[2 * row];
    const float py = pts[2 * row + 1];
    const float ipx = truncf(px);
    const float ipy = truncf(py);
    const bool inside = (__fsub_rn(ipx, s3) < (float)W) &&
                        (__fsub_rn(ipy, s3) < (float)H) &&
                        (__fadd_rn(__fadd_rn(ipx, s3), 1.0f) >= 0.0f) &&
                        (__fadd_rn(__fadd_rn(ipy, s3), 1.0f) >= 0.0f);
    const float keep = (vis[row] > 0.0f && inside) ? 1.0f : 0.0f;
    if (pix == 0) vis_out[row] = keep;
    if (pix < hw) {
      const float dx = __fsub_rn((float)(pix % W), px);
      const float dy = __fsub_rn((float)(pix / W), py);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      float g = expf(__fdiv_rn(-d2, denom));
      if (!(fabsf(dx) <= win && fabsf(dy) <= win)) g = 0.0f;
      out[(size_t)row * hw + pix] = __fmul_rn(g, keep);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// A launch with rows == 0 does nothing.
extern "C" int rasterize_gaussians_launch(
    const float* pts, const float* vis, float* out, float* vis_out,
    int rows, int H, int W, float denom, float win, float s3,
    cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int hw = H * W;
  const dim3 grid((hw + kThreads - 1) / kThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  rasterize_gaussians_kernel<<<grid, kThreads, 0, stream>>>(
      pts, vis, out, vis_out, rows, H, W, denom, win, s3);
  return (int)cudaGetLastError();
}
