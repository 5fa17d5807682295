// idct_islow: libjpeg's integer IDCT (jidctint.c, jpeg_idct_islow, the
// decoder's default JDCT_ISLOW) for every 8x8 block of every component of a
// batch of JPEG files, in one launch, writing each component's plane at its
// stored size.
//
// Replaces: no TPU kernel.  Its counterpart is libjpeg code inside the host
// decode pool (posetpu/native/decode_pool.cpp, jpeg_read_scanlines: the
// coefficient controller's IDCT).  Its plain version is
// posetpu_torch/native/islow.py:component_plane; the two agree bit for bit
// on any input (the same int32 arithmetic, wrapping, in the same order).
//
// Per block: dequantise (coef * q); pass 1 on the columns (CONST_BITS 13,
// PASS1_BITS 2; a column whose AC coefficients are all zero gives its DC
// term << PASS1_BITS); pass 2 on the rows; each output DESCALEd (a rounded
// arithmetic right shift) and mapped through libjpeg's post-IDCT
// range-limit table (jdmaster.c, prepare_range_limit_table), indexed
// & RANGE_MASK, computed here by comparisons rather than read from a table.
//
// Bound: bytes.  At the loader's batch (32 frames of 1280x720 4:2:0) it
// reads 691,200 blocks of int16 coefficients (88.5 MB) and writes 44.2 MB
// of planes; its integer work is about 850 operations a block, 0.59 G in
// all, a fraction of the bytes' time.
//
// Design: simple and right first.  A block of 4 warps; each warp takes 4
// consecutive 8x8 blocks of the launch, a group of 8 lanes a block:
//  - lane r of a group loads row r of its block's coefficients and of its
//    table, 16 bytes each (a warp reads 512 contiguous bytes when its blocks
//    lie in one grid row), dequantises, and writes the row into the warp's
//    workspace in shared memory (rows of 9 words: no bank conflicts in
//    either pass);
//  - lane c of the group then runs pass 1 on column c, in place; which
//    columns have nonzero AC terms comes from the rows' masks OR-ed across
//    the group with three shuffles;
//  - lane r runs pass 2 on row r and stores its 8 samples as one 8-byte
//    store where the row lies inside the plane and is 8-byte aligned (the
//    route's planes always are), else byte by byte up to the plane's width.
//    The 4 lanes of one row index write 32 contiguous bytes when the
//    warp's blocks are neighbours.
// A block's component comes from a binary search over the descriptors'
// first-block words, and its position in the grid from one 32-bit
// division.
//
// Each component has a descriptor of DESC_WORDS int64 words:
//   0 coefficient offset, 1 table offset (int16 elements; multiples of 8)
//   2 the grid's blocks a row (its row stride, in blocks)
//   3-4 blocks wide and high that cover the plane
//   5 plane device pointer, 6 row pitch in bytes, 7-8 plane width, height
//   9 the component's first block in the launch (ascending)
//
// Build: nvcc (posetpu_torch/utils/cuda_build.py NVCC_FLAGS) -o <lib> idct_islow.cu

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kDescWords = 10;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpBlocks = 4;             // 8x8 blocks of a warp
constexpr int kBlockBlocks = kWarps * kWarpBlocks;
constexpr int kRowWords = 9;               // a workspace row, padded
constexpr int kBlockWords = 8 * kRowWords;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

// jidctint.c's 1-D pass over x[0..7] (int32, wrapping), each output
// DESCALEd by kShift.  Unsigned arithmetic wraps as the plain version's
// int32 tensors do; the shifts right are arithmetic.
template <int kShift>
__device__ __forceinline__ void idct8(const int* x, int* out) {
  using u32 = unsigned;
  const u32 z2 = x[2], z3 = x[6];
  const u32 z1 = (z2 + z3) * 4433u;                // FIX_0_541196100
  const u32 tmp2 = z1 + z3 * static_cast<u32>(-15137);  // -FIX_1_847759065
  const u32 tmp3 = z1 + z2 * 6270u;                // FIX_0_765366865
  const u32 tmp0 = (static_cast<u32>(x[0]) + static_cast<u32>(x[4])) << kConstBits;
  const u32 tmp1 = (static_cast<u32>(x[0]) - static_cast<u32>(x[4])) << kConstBits;
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  u32 t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  u32 a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  const u32 z5 = (a3 + a4) * 9633u;                // FIX_1_175875602
  t0 *= 2446u;                                     // FIX_0_298631336
  t1 *= 16819u;                                    // FIX_2_053119869
  t2 *= 25172u;                                    // FIX_3_072711026
  t3 *= 12299u;                                    // FIX_1_501321110
  a1 *= static_cast<u32>(-7373);                   // -FIX_0_899976223
  a2 *= static_cast<u32>(-20995);                  // -FIX_2_562915447
  a3 = a3 * static_cast<u32>(-16069) + z5;         // -FIX_1_961570560
  a4 = a4 * static_cast<u32>(-3196) + z5;          // -FIX_0_390180644
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  constexpr u32 r = 1u << (kShift - 1);
  out[0] = static_cast<int>(tmp10 + t3 + r) >> kShift;
  out[1] = static_cast<int>(tmp11 + t2 + r) >> kShift;
  out[2] = static_cast<int>(tmp12 + t1 + r) >> kShift;
  out[3] = static_cast<int>(tmp13 + t0 + r) >> kShift;
  out[4] = static_cast<int>(tmp13 - t0 + r) >> kShift;
  out[5] = static_cast<int>(tmp12 - t1 + r) >> kShift;
  out[6] = static_cast<int>(tmp11 - t2 + r) >> kShift;
  out[7] = static_cast<int>(tmp10 - t3 + r) >> kShift;
}

// libjpeg's post-IDCT range-limit table at v = x & RANGE_MASK (1023)
__device__ __forceinline__ uint32_t range_limit(int x) {
  const int v = x & 1023;
  return static_cast<uint32_t>(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
}

__global__ void __launch_bounds__(kThreads)
idct_islow_kernel(const long long* __restrict__ descs, int n, long long blocks,
                  const int16_t* __restrict__ coefs, const int16_t* __restrict__ qtables) {
  __shared__ int workspace[kWarps][kWarpBlocks * kBlockWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 3, r = lane & 7;
  const long long b = static_cast<long long>(blockIdx.x) * kBlockBlocks + warp * kWarpBlocks + g;
  const bool live = b < blocks;
  int* ws = workspace[warp] + g * kBlockWords;

  // the component: the last whose first block is at or below b
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(descs + mid * kDescWords + 9) <= b) lo = mid; else hi = mid - 1;
  }
  const long long* d = descs + lo * kDescWords;
  const long long coef_off = __ldg(d + 0), qt_off = __ldg(d + 1);
  const unsigned stride = static_cast<unsigned>(__ldg(d + 2));
  const unsigned nbw = static_cast<unsigned>(__ldg(d + 3));
  const unsigned local = static_cast<unsigned>(b - __ldg(d + 9));
  const unsigned by = local / nbw, bx = local - by * nbw;

  // row r: dequantise into the workspace; mask of its nonzero coefficients
  unsigned nonzero = 0;
  if (live) {
    const int4 cv = __ldg(reinterpret_cast<const int4*>(
        coefs + coef_off + (static_cast<long long>(by) * stride + bx) * 64 + r * 8));
    const int4 qv = __ldg(reinterpret_cast<const int4*>(qtables + qt_off + r * 8));
    const int cw[4] = {cv.x, cv.y, cv.z, cv.w}, qw[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c0 = static_cast<int16_t>(cw[k] & 0xFFFF), c1 = cw[k] >> 16;
      const int q0 = qw[k] & 0xFFFF, q1 = (qw[k] >> 16) & 0xFFFF;
      ws[r * kRowWords + 2 * k] = c0 * q0;
      ws[r * kRowWords + 2 * k + 1] = c1 * q1;
      nonzero |= (c0 != 0 ? 1u : 0u) << (2 * k) | (c1 != 0 ? 1u : 0u) << (2 * k + 1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) ws[r * kRowWords + j] = 0;
  }
  // the columns with a nonzero AC term: rows 1-7's masks across the group
  unsigned ac = r ? nonzero : 0u;
  ac |= __shfl_xor_sync(0xFFFFFFFFu, ac, 1);
  ac |= __shfl_xor_sync(0xFFFFFFFFu, ac, 2);
  ac |= __shfl_xor_sync(0xFFFFFFFFu, ac, 4);
  __syncwarp();

  // pass 1: column r, in place
  {
    int x[8], out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = ws[i * kRowWords + r];
    if ((ac >> r) & 1u) {
      idct8<kConstBits - kPass1Bits>(x, out);
    } else {
      const int dc = static_cast<int>(static_cast<unsigned>(x[0]) << kPass1Bits);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = dc;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ws[i * kRowWords + r] = out[i];
  }
  __syncwarp();

  // pass 2: row r, range-limited, stored
  int x[8], out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = ws[r * kRowWords + j];
  idct8<kConstBits + kPass1Bits + 3>(x, out);
  const uint32_t lo4 = range_limit(out[0]) | range_limit(out[1]) << 8 |
                       range_limit(out[2]) << 16 | range_limit(out[3]) << 24;
  const uint32_t hi4 = range_limit(out[4]) | range_limit(out[5]) << 8 |
                       range_limit(out[6]) << 16 | range_limit(out[7]) << 24;
  const int pw = static_cast<int>(__ldg(d + 7)), ph = static_cast<int>(__ldg(d + 8));
  const long long y = static_cast<long long>(by) * 8 + r;
  if (!live || y >= ph) return;
  uint8_t* dst = reinterpret_cast<uint8_t*>(__ldg(d + 5)) + y * __ldg(d + 6) + bx * 8;
  const int cols = pw - static_cast<int>(bx) * 8;
  if (cols >= 8 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo4, hi4);
  } else {
    for (int j = 0; j < 8 && j < cols; ++j)
      dst[j] = static_cast<uint8_t>((j < 4 ? lo4 >> (8 * j) : hi4 >> (8 * (j - 4))) & 0xFF);
  }
}

}  // namespace

extern "C" {

// descs: n * 10 int64 words in device memory; blocks: the 8x8 blocks of
// the launch (the last descriptor's first block plus its count); coefs and
// qtables: int16 device buffers the descriptors' offsets index, 16-byte
// aligned.  Launches on `stream`; returns the launch's cudaError_t.
int idct_islow_launch(const void* descs, int n, long long blocks, const void* coefs,
                      const void* qtables, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((blocks + kBlockBlocks - 1) / kBlockBlocks);
  idct_islow_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(descs), n, blocks, static_cast<const int16_t*>(coefs),
      static_cast<const int16_t*>(qtables));
  return static_cast<int>(cudaGetLastError());
}

// The same after staging the descriptors: waits for `done` (recorded after
// the previous call with these buffers: its copy and its kernel have run),
// copies descs (n * 10 int64 words in any host memory) into `pinned` (host,
// page-locked) and from there into `dev_descs` (device) on `stream`,
// launches, and records `done` on `stream`.  Returns the first cudaError_t
// (0 when all is queued).
int idct_islow_stage_launch(const void* descs, void* pinned, void* dev_descs, void* done, int n,
                            long long blocks, const void* coefs, const void* qtables,
                            void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaEvent_t event = static_cast<cudaEvent_t>(done);
  const size_t bytes = static_cast<size_t>(n) * kDescWords * sizeof(long long);
  cudaError_t err = cudaEventSynchronize(event);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(pinned, descs, bytes);
  err = cudaMemcpyAsync(dev_descs, pinned, bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = idct_islow_launch(dev_descs, n, blocks, coefs, qtables, stream);
  if (launched != 0) return launched;
  return static_cast<int>(cudaEventRecord(event, s));
}

}  // extern "C"
