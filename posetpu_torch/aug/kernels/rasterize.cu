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
// posetpu_torch/aug/heatmap.py:rasterize_gaussians_plain, and the kernel's
// output equals it bit for bit.
//
// Bound: the output write.  It reads 12 bytes per row and writes 4*H*W, so
// the floor is HBM: 8.4 MB, 0.0025 ms at 3.35 TB/s at (32, 16, 64, 64).
// Only the (2*int(3 sigma)+1)^2 pixels of the 3 sigma window can be
// non-zero: 49 of a 64x64 map's 4,096 at sigma = 1.  Run on every pixel,
// the Gaussian's arithmetic (an IEEE division and an expf) and an integer
// / and % by W to find the pixel would bound the kernel by instruction
// issue instead.
//
// Design:
// - One block per heatmap, rows on blockIdx.x (up to 2^31 - 1 rows).  The
//   block reads its point, vis and keep flag once, and one thread writes
//   vis_out.
// - threadIdx.x walks a map row in chunks of VEC columns and threadIdx.y
//   walks the image rows, in loops: no integer division.  VEC is 4 (float4
//   stores) when W % 4 == 0 and the output is 16-byte aligned, so every
//   image row starts on 16 bytes; else 1.  Consecutive threads store
//   consecutive chunks across image rows, so a warp writes 512 contiguous
//   bytes at VEC = 4.  No streaming hint: the loss reads the targets right
//   after, and 8.4 MB stays in the 50 MB L2.
// - Arithmetic only inside the window.  Each thread decides its columns'
//   half of the window test once, and an image row's half once per row,
//   with the plain version's own float test |x - px| <= 3 sigma.  Integer
//   bounds derived from it would disagree at the edge for fractional points
//   or a non-integer 3 sigma.  A pixel outside stores +0 with no division
//   and no exp; a pixel inside runs the plain version's rounded sequence.
//
// Numerics: IEEE division and expf (no fast math), and explicit
// round-to-nearest intrinsics so that dx*dx + dy*dy never becomes an FMA.
// That keeps the kernel bit-comparable with the plain version, which runs
// each operation as its own rounded step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // per block, at most
constexpr int kWarp = 32;

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) rasterize_gaussians_kernel(
    const float* __restrict__ pts,   // (rows, 2): x, y, 0-indexed
    const float* __restrict__ vis,   // (rows,)
    float* __restrict__ out,         // (rows, H*W)
    float* __restrict__ vis_out,     // (rows,)
    int H, int W,
    float denom,                     // 2 sigma^2
    float win,                       // 3 sigma
    float s3) {                      // float(int(3 sigma))
  const int row = blockIdx.x;
  const float px = pts[2 * row];
  const float py = pts[2 * row + 1];
  const float ipx = truncf(px);
  const float ipy = truncf(py);
  const bool inside = (__fsub_rn(ipx, s3) < (float)W) &&
                      (__fsub_rn(ipy, s3) < (float)H) &&
                      (__fadd_rn(__fadd_rn(ipx, s3), 1.0f) >= 0.0f) &&
                      (__fadd_rn(__fadd_rn(ipy, s3), 1.0f) >= 0.0f);
  const float keep = (vis[row] > 0.0f && inside) ? 1.0f : 0.0f;
  if (threadIdx.x == 0 && threadIdx.y == 0) vis_out[row] = keep;
  float* map = out + (size_t)row * H * W;

  for (int x0 = threadIdx.x * VEC; x0 < W; x0 += blockDim.x * VEC) {
    // the chunk's columns: dx and their half of the window test, once per map
    float dx[VEC];
    bool col_in[VEC];
    bool any_col = false;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      dx[v] = __fsub_rn((float)(x0 + v), px);
      col_in[v] = fabsf(dx[v]) <= win;
      any_col = any_col || col_in[v];
    }
    // a joint that is not kept stores +0 everywhere, as g * 0 does
    any_col = any_col && keep != 0.0f;
    for (int y = threadIdx.y; y < H; y += blockDim.y) {
      float g[VEC] = {};
      if (any_col) {
        const float dy = __fsub_rn((float)y, py);
        if (fabsf(dy) <= win) {
          const float dy2 = __fmul_rn(dy, dy);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (col_in[v]) {
              const float d2 = __fadd_rn(__fmul_rn(dx[v], dx[v]), dy2);
              g[v] = __fmul_rn(expf(__fdiv_rn(-d2, denom)), keep);
            }
          }
        }
      }
      store(map + y * W + x0, g);
    }
  }
}

template <int VEC>
void launch(const float* pts, const float* vis, float* out, float* vis_out,
            int rows, int H, int W, float denom, float win, float s3,
            cudaStream_t stream) {
  const int chunks = W / VEC;
  const int bx = chunks < kWarp ? chunks : kWarp;
  const int by = kThreads / bx < H ? kThreads / bx : H;
  rasterize_gaussians_kernel<VEC><<<rows, dim3(bx, by), 0, stream>>>(
      pts, vis, out, vis_out, H, W, denom, win, s3);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// A launch with rows == 0 does nothing.
extern "C" int rasterize_gaussians_launch(
    const float* pts, const float* vis, float* out, float* vis_out,
    int rows, int H, int W, float denom, float win, float s3,
    cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    launch<4>(pts, vis, out, vis_out, rows, H, W, denom, win, s3, stream);
  } else {
    launch<1>(pts, vis, out, vis_out, rows, H, W, denom, win, s3, stream);
  }
  return (int)cudaGetLastError();
}
