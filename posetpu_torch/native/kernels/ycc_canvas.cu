// ycc_canvas: the last steps of libjpeg's decode, and the decode pool's crop
// and pad, for a batch of JPEG component planes in device memory (the
// idct_islow kernel's output), in one launch.
//
// Replaces: no TPU kernel.  Its counterpart is libjpeg code inside the host
// decode pool (posetpu/native/decode_pool.cpp): jpeg_read_scanlines'
// chroma upsampling (jdsample.c, h2v1/h1v2/h2v2_fancy_upsample) and
// YCbCr->RGB conversion (jdcolor.c, ycc_rgb_convert), then the pool's
// integer crop window and zero padding (process_one).  Its plain version is
// posetpu_torch/native/ycc.py:window_canvas; the two agree bit for bit
// (integer arithmetic only).
//
// Bound: bytes.  The least time is the planes read once plus the
// (N, ph, pw, 3) canvas written once at the card's memory rate.  Each output
// pixel also costs a few dozen 32-bit integer instructions (loads from
// shared memory, the 3:1 taps, the conversion, the packing), and on the
// H100 those, not the bytes, set the time: the design keeps both the memory
// operations and the instructions a pixel few.
//
// Design.  One block of 4 warps builds a tile of 256 output columns of one
// image, two bands of 16 rows: the bands on blockIdx.x, the image on
// blockIdx.y, the tile of columns on blockIdx.z.  Every index is 32-bit with
// no division, and shared memory stays 29 KB, static, whatever the canvas
// width.
//  - The block reads its image's descriptor once, into shared memory with
//    the chroma planes' geometry for its columns, and picks the code of its
//    component layout (gray, 4:4:4, 4:2:2, 4:4:0,
//    4:2:0, or the general one for chroma planes with factors of their own
//    or a replicated chroma of width <= 2): a template instance, so the
//    4:2:0 path has no branch on the layout.
//  - It stages each band's luma rows, and the chroma rows they need, in
//    shared memory: one bulk copy of the Tensor Memory Accelerator a row,
//    issued by a thread of its own and counted on the band's mbarrier, from
//    the 16-byte boundary at or below the row's first byte, so any row pitch
//    and base works (the route's pitches are 256-byte multiples; views such as
//    [:, :w] are not).  The next band's copies run while the block builds
//    this one.  At v = 2, output rows 2j and 2j+1 share chroma row j, paired
//    by image row (the crop's off_y may be odd), so 16 rows need at most 11
//    chroma rows.
//  - Each warp builds 4 rows of a band, each lane 8 pixels of a row: each
//    chroma column sum 3*near + far of the lane's columns once (and two of
//    its neighbours'), each horizontal 3:1 pair once, with libjpeg's
//    alternating biases; the conversion's -128s folded into its constants;
//    the clamp and the packing of 4 bytes in two I2IP instructions.  Only a
//    lane at the plane's left or right edge clamps its columns.
//  - The lane's 24 bytes go into the warp's segment buffer at the
//    segment's own 16-byte alignment, and the warp writes its row segment
//    with 16-byte stores, bytes at its ragged ends (a canvas row starts on
//    a 16-byte boundary only when pw % 16 == 0).
//  - A band wholly in the padding, and a (0, 0) window's slot, is a plain
//    zero fill with 16-byte stores.
//
// Each image has a descriptor of DESC_WORDS int64 words:
//   0-2   plane device pointers (Y, Cb, Cr; Cb = Cr = 0 for grayscale)
//   3-5   row pitches in bytes
//   6-8   stored widths, 9-11 stored heights
//   12-14 horizontal upsampling factors, 15-17 vertical ones (1 or 2)
//   18    components (1 or 3)
//   19-20 crop offset (x, y); 21-22 valid (w, h), (0, 0) for a failed file
//
// Build: nvcc (posetpu_torch/utils/cuda_build.py NVCC_FLAGS) -o <lib> ycc_canvas.cu

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kDescWords = 24;
constexpr int kWarps = 4;
constexpr int kWarpRows = 4;           // output rows of a warp in a band
constexpr int kRows = kWarps * kWarpRows;  // output rows of a band
constexpr int kBands = 2;              // bands of a block
constexpr int kStages = 2;             // bands staged at once: kStages - 1 ahead
// blocks an SM keeps in flight: 7 caps a thread at 72 registers without a
// spill, and the extra resident warps hide more latency than the registers
// past 72 would save (PERF.md)
constexpr int kMinBlocks = 7;
constexpr int kLanePixels = 8;         // output pixels of a lane
constexpr int kLaneCols = kLanePixels / 2 + 2;  // the chroma columns they read at h = 2
constexpr int kCols = 32 * kLanePixels;  // output columns of a tile
constexpr int kThreads = 32 * kWarps;
// a staged plane row: up to 15 bytes below its first column, then the
// tile's columns (and at h = 2 their neighbours), in whole 16-byte chunks
constexpr int kStage = 16 * ((kCols + 31) / 16);
constexpr int kSegment = 16 + 3 * kCols;  // a warp's canvas bytes at their alignment

// jdcolor.c: SCALEBITS 16, FIX(x) = x * 65536 + 0.5.  Each constant term
// below also holds the -128 of Cb and Cr times its factor, so that
// F * (c - 128) + ONE_HALF = F * c + K exactly (the products fit in int).
constexpr int kOneHalf = 1 << 15;
constexpr int kFix1_40200 = 91881;
constexpr int kFix1_77200 = 116130;
constexpr int kFix0_71414 = 46802;
constexpr int kFix0_34414 = 22554;
constexpr int kR = kOneHalf - 128 * kFix1_40200;
constexpr int kG = kOneHalf + 128 * (kFix0_34414 + kFix0_71414);
constexpr int kB = kOneHalf - 128 * kFix1_77200;

// One band's staged rows, and each staged row's offset (its first byte's
// distance from the 16-byte boundary below it): luma, Cb, Cr.
struct alignas(16) Band {
  uint8_t luma[kRows][kStage];
  uint8_t chroma[2][kRows][kStage];
  int lead[3][kRows];
};

// One chroma component's geometry, and the stored columns [i0, i1] that
// image columns [x0, x1) read, the 3:1 taps' neighbours included, clamped
// to the plane.
struct Comp {
  const uint8_t* plane;
  long long pitch;
  int w, h, hf, vf, i0, i1;
};

__device__ __forceinline__ Comp comp_at(const long long* d, int k, int x0, int x1) {
  Comp c;
  c.plane = reinterpret_cast<const uint8_t*>(d[k]);
  c.pitch = d[3 + k];
  c.w = static_cast<int>(d[6 + k]);
  c.h = static_cast<int>(d[9 + k]);
  c.hf = static_cast<int>(d[12 + k]);
  c.vf = static_cast<int>(d[15 + k]);
  c.i0 = c.hf == 2 ? max((x0 >> 1) - 1, 0) : x0;
  c.i1 = c.hf == 2 ? min(((x1 - 1) >> 1) + 1, c.w - 1) : x1 - 1;
  return c;
}

// The first stored row that image rows from y0 read.
__device__ __forceinline__ int first_row(const Comp& c, int y0) {
  return c.vf == 2 ? max((y0 >> 1) - 1, 0) : y0;
}

// The component layouts with code of their own.  kAny reads the factors at
// run time: chroma planes with factors of their own, or a replicated chroma
// plane (h = 2, stored width <= 2).
enum Layout { kGray, k444, k422, k440, k420, kAny };

__device__ __forceinline__ int layout_of(const long long* d) {
  if (d[18] != 3) return kGray;
  const long long hf = d[13], vf = d[16];
  if (d[14] != hf || d[17] != vf || (hf == 2 && (d[7] <= 2 || d[8] <= 2))) return kAny;
  return hf == 1 ? (vf == 1 ? k444 : k440) : (vf == 1 ? k422 : k420);
}

// The staging's copies: one bulk copy (the Tensor Memory Accelerator's
// cp.async.bulk) a plane row, from device memory into shared memory, its
// bytes counted on an mbarrier that the readers wait on.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// This thread's arrival, after the bytes of its own bulk copies.
__device__ __forceinline__ void bar_arrive(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from 16-byte aligned src into 16-byte aligned
// shared memory at dst, counted on bar.  The fence orders the buffer's
// earlier reads by this block before the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Starts copying bytes [src, src + n) of a plane row into dst, from the
// 16-byte boundary at or below src: a copy never leaves the aligned 16 bytes
// around a byte of the row, so it stays inside the plane's allocation.
// Returns the bytes copied; *lead gets src's offset in dst.
__device__ __forceinline__ unsigned stage_row(uint8_t* dst, const uint8_t* src, int n, int* lead,
                                              uint64_t* bar) {
  const int at = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const unsigned bytes = static_cast<unsigned>((at + n + 15) & ~15);
  *lead = at;
  bulk_copy(dst, src - at, bytes, bar);
  return bytes;
}

// The 3:1 horizontal pairs of a lane's output pixels from the values cs[]
// of columns i-1 .. i+kLanePixels/2, pixel 0 being column 2i + S: each takes
// 3 x its nearer column plus the further one, and libjpeg's bias for even
// (BE) or odd (BO) pixels, shifted right by SHIFT.
template <int S, int SHIFT, int BE, int BO>
__device__ __forceinline__ void pairs(const int cs[kLaneCols], int v[kLanePixels]) {
#pragma unroll
  for (int p = 0; p < kLanePixels; ++p) {
    const int xo = p + S, i = xo >> 1;
    const bool odd = xo & 1;
    v[p] = (3 * cs[i + 1] + cs[odd ? i + 2 : i] + (odd ? BO : BE)) >> SHIFT;
  }
}

// A lane's samples of one chroma component at image row y, columns from x
// (x's parity S), as libjpeg-turbo's decoder upsamples them with
// do_fancy_upsampling.  rows, lead: the component's staged rows from
// stored row j0 on, and their offsets.
template <int S, int L>
__device__ __forceinline__ void upsample_lane(const Comp& c, const uint8_t (*rows)[kStage],
                                              const int* lead, int j0, int x, int y,
                                              int v[kLanePixels]) {
  // the factors, constants but in kAny
  const int hf = L == kAny ? c.hf : (L == k422 || L == k420 ? 2 : 1);
  const int vf = L == kAny ? c.vf : (L == k440 || L == k420 ? 2 : 1);
  int j = y, jf = y;
  if (vf == 2) {  // the nearer and the further stored row
    j = y >> 1;
    jf = (y & 1) ? min(j + 1, c.h - 1) : max(j - 1, 0);
  }
  const uint8_t* a = rows[j - j0] + lead[j - j0] - c.i0;  // stored column 0
  const uint8_t* b = rows[jf - j0] + lead[jf - j0] - c.i0;
  if (hf == 1) {
    if (vf == 2) {  // h1v2
      const int bias = (y & 1) ? 2 : 1;
#pragma unroll
      for (int p = 0; p < kLanePixels; ++p) v[p] = (3 * a[x + p] + b[x + p] + bias) >> 2;
    } else {
#pragma unroll
      for (int p = 0; p < kLanePixels; ++p) v[p] = a[x + p];
    }
    return;
  }
  const int i = x >> 1;
  if (L == kAny && c.w <= 2) {  // h2v1_upsample, h2v2_upsample: each sample replicated
#pragma unroll
    for (int p = 0; p < kLanePixels; ++p) v[p] = a[i + ((S + p) >> 1)];
    return;
  }
  // the values of the lane's columns from i-1 on: 3 x the nearer row plus
  // the further one at v = 2; the plane's edge columns stand for those past
  // them
  int cs[kLaneCols];
  if (i >= 1 && i + kLaneCols - 2 <= c.w - 1) {
    a += i - 1;
    b += i - 1;
    if (vf == 2) {
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) cs[k] = 3 * a[k] + b[k];
    } else {
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) cs[k] = a[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      const int col = min(max(i - 1 + k, 0), c.w - 1);
      cs[k] = vf == 2 ? 3 * a[col] + b[col] : a[col];
    }
  }
  if (vf == 2) {
    pairs<S, 4, 8, 7>(cs, v);  // h2v2: column sums, then 3:1 across
  } else {
    pairs<S, 2, 1, 2>(cs, v);  // h2v1
  }
}

// Four ints saturated to 0..255 and packed into a word, b0 in its low byte
// (two I2IP instructions: the clamp and the packing at once).
__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  uint32_t hi, word;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(b3), "r"(b2), "r"(0));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;" : "=r"(word) : "r"(b1), "r"(b0), "r"(hi));
  return word;
}

// A canvas segment [dst, dst + n) from the warp's buffer (its byte b at
// dst's 16-byte boundary + b), or zeros: 16-byte stores, bytes at the ends.
template <bool kZeros>
__device__ __forceinline__ void store_segment(uint8_t* dst, int n, const uint8_t* seg,
                                              int lane) {
  constexpr int kRounds = (kSegment + 511) / 512;  // 32 lanes x 16 bytes a round
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* base = dst - m;
  const int end = m + n;
  if (m == 0 && (n & 15) == 0) {  // whole chunks: rows on 16-byte boundaries
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = (lane << 4) + 512 * r;
      if (k < n) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if constexpr (!kZeros) v = *reinterpret_cast<const uint4*>(seg + k);
        *reinterpret_cast<uint4*>(dst + k) = v;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = (lane << 4) + 512 * r;
    if (k >= end) break;
    if (k >= m && k + 16 <= end) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if constexpr (!kZeros) v = *reinterpret_cast<const uint4*>(seg + k);
      *reinterpret_cast<uint4*>(base + k) = v;
    } else {
      for (int b = max(k, m); b < min(k + 16, end); ++b) {
        if constexpr (kZeros) {
          base[b] = 0;
        } else {
          base[b] = seg[b];
        }
      }
    }
  }
}

// One block's tile of image blockIdx.y, its layout L, from its descriptor d:
// every band of the tile, staged kStages - 1 ahead.
template <int L>
__device__ __forceinline__ void tile(const long long* d, const Comp* comp, int ph, int pw,
                                     uint8_t* out, Band* band, uint64_t* bars,
                                     uint8_t (*seg)[kSegment]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.z * kCols, cols = min(kCols, pw - c0);
  const int r_first = blockIdx.x * kBands * kRows;
  const int bands = min(kBands, (ph - r_first + kRows - 1) / kRows);
  const int off_x = static_cast<int>(d[19]), off_y = static_cast<int>(d[20]);
  const int vw = static_cast<int>(d[21]), vh = static_cast<int>(d[22]);
  // bands that hold image rows (none where the tile is right of the window
  // or the window is (0, 0)); the others are padding
  const int live = c0 >= vw || vh <= r_first ? 0 : min(bands, (vh - r_first + kRows - 1) / kRows);
  constexpr bool color = L != kGray;
  const int x0 = off_x + c0, x1 = off_x + min(c0 + kCols, vw);
  const uint8_t* luma = reinterpret_cast<const uint8_t*>(d[0]);
  const long long luma_pitch = d[3];

  // starts staging band b's rows (image rows [y0, y1), columns [x0, x1)):
  // one bulk copy a row, each by a thread of its own (luma rows, then each
  // chroma's); every thread arrives on the band's barrier once
  auto stage = [&](int b) {
    Band& s = band[b % kStages];
    uint64_t* bar = &bars[b % kStages];
    const int r0 = r_first + b * kRows, rows = min(kRows, vh - r0);
    const int y0 = off_y + r0, y1 = y0 + rows;
    int t = threadIdx.x;
    unsigned bytes = 0;
    if (t < rows) {
      bytes = stage_row(s.luma[t], luma + (y0 + t) * luma_pitch + x0, x1 - x0, &s.lead[0][t], bar);
    } else if constexpr (color) {
      t -= rows;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Comp& cp = comp[c];
        const int j0 = first_row(cp, y0);
        const int j1 = cp.vf == 2 ? min(((y1 - 1) >> 1) + 1, cp.h - 1) : y1 - 1;
        if (t >= 0 && t <= j1 - j0) {
          bytes = stage_row(s.chroma[c][t], cp.plane + (j0 + t) * cp.pitch + cp.i0,
                            cp.i1 - cp.i0 + 1, &s.lead[1 + c][t], bar);
        }
        t -= j1 - j0 + 1;
      }
    }
    bar_arrive(bar, bytes);
  };

  for (int b = 0; b < kStages - 1 && b < live; ++b) stage(b);
  for (int b = 0; b < bands; ++b) {
    if (b + kStages - 1 < live) stage(b + kStages - 1);
    if (b < live) bar_wait(&bars[b % kStages], (b / kStages) & 1);  // band b has landed
    const int r0 = r_first + b * kRows;
    // the band's first canvas row in this tile
    uint8_t* band_out = out + ((static_cast<long long>(blockIdx.y) * ph + r0) * pw + c0) * 3;
    for (int k = warp; k < kRows && r0 + k < ph; k += kWarps) {
      const int r = r0 + k;
      uint8_t* dst = band_out + k * 3 * pw;
      if (b >= live || r >= vh) {
        store_segment<true>(dst, 3 * cols, nullptr, lane);
        continue;
      }
      const Band& s = band[b % kStages];
      const int m = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
      const int xs = lane * kLanePixels;
      if (xs < cols) {
        const int x = x0 + xs, y = off_y + r;
        const uint8_t* lp = s.luma[k] + s.lead[0][k] + xs;
        int rgb[3 * kLanePixels];
        if constexpr (color) {
          const int y0 = off_y + r0;
          const int j0 = first_row(comp[0], y0), j1 = first_row(comp[1], y0);
          int u[kLanePixels], v[kLanePixels];
          if (x & 1) {
            upsample_lane<1, L>(comp[0], s.chroma[0], s.lead[1], j0, x, y, u);
            upsample_lane<1, L>(comp[1], s.chroma[1], s.lead[2], j1, x, y, v);
          } else {
            upsample_lane<0, L>(comp[0], s.chroma[0], s.lead[1], j0, x, y, u);
            upsample_lane<0, L>(comp[1], s.chroma[1], s.lead[2], j1, x, y, v);
          }
#pragma unroll
          for (int p = 0; p < kLanePixels; ++p) {
            // arithmetic right shifts of signed ints, as jdcolor.c's RIGHT_SHIFT
            const int yv = lp[p];
            rgb[3 * p] = yv + ((kFix1_40200 * v[p] + kR) >> 16);
            rgb[3 * p + 1] = yv + ((kG - kFix0_34414 * u[p] - kFix0_71414 * v[p]) >> 16);
            rgb[3 * p + 2] = yv + ((kFix1_77200 * u[p] + kB) >> 16);
          }
        } else {
#pragma unroll
          for (int p = 0; p < kLanePixels; ++p) rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = lp[p];
        }
        const int valid = vw - c0 - xs;  // pixels left of the window's right edge
        if (valid < kLanePixels) {
#pragma unroll
          for (int p = 0; p < kLanePixels; ++p) {
            if (p >= valid) rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = 0;
          }
        }
        uint32_t words[3 * kLanePixels / 4];
#pragma unroll
        for (int q = 0; q < 3 * kLanePixels / 4; ++q) {
          words[q] = pack4(rgb[4 * q], rgb[4 * q + 1], rgb[4 * q + 2], rgb[4 * q + 3]);
        }
        uint8_t* o = seg[warp] + m + 3 * xs;
        if ((m & 3) == 0) {
#pragma unroll
          for (int q = 0; q < 3 * kLanePixels / 4; ++q) reinterpret_cast<uint32_t*>(o)[q] = words[q];
        } else {
#pragma unroll
          for (int q = 0; q < 3 * kLanePixels; ++q) {
            o[q] = static_cast<uint8_t>(words[q >> 2] >> (8 * (q & 3)));
          }
        }
      }
      __syncwarp();
      store_segment<false>(dst, 3 * cols, seg[warp], lane);
      __syncwarp();  // the buffer is read before the warp's next row
    }
    __syncthreads();  // band b's buffer is free for band b + kStages
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ycc_canvas_kernel(const long long* __restrict__ descs, int ph, int pw,
                      uint8_t* __restrict__ out) {
  __shared__ long long d[kDescWords];
  __shared__ Comp comp[2];  // the chroma planes' geometry for this tile
  __shared__ Band band[kStages];
  __shared__ uint64_t bars[kStages];  // a band's copies have landed: one phase a band
  __shared__ __align__(16) uint8_t seg[kWarps][kSegment];

  const long long* desc = descs + static_cast<long long>(blockIdx.y) * kDescWords;
  if (threadIdx.x < kDescWords) d[threadIdx.x] = desc[threadIdx.x];
  if (threadIdx.x < 2 && desc[18] == 3) {
    const int off_x = static_cast<int>(desc[19]), vw = static_cast<int>(desc[21]);
    const int c0 = blockIdx.z * kCols;
    comp[threadIdx.x] = comp_at(desc, 1 + threadIdx.x, off_x + c0, off_x + min(c0 + kCols, vw));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&bars[s], kThreads);
    bar_init_fence();
  }
  __syncthreads();
  switch (layout_of(d)) {  // the same for the whole block
    case kGray: tile<kGray>(d, comp, ph, pw, out, band, bars, seg); break;
    case k444: tile<k444>(d, comp, ph, pw, out, band, bars, seg); break;
    case k422: tile<k422>(d, comp, ph, pw, out, band, bars, seg); break;
    case k440: tile<k440>(d, comp, ph, pw, out, band, bars, seg); break;
    case k420: tile<k420>(d, comp, ph, pw, out, band, bars, seg); break;
    default: tile<kAny>(d, comp, ph, pw, out, band, bars, seg); break;
  }
}

}  // namespace

extern "C" {

// descs: n * 24 int64 words in device memory; out: (n, ph, pw, 3) uint8.
// Launches on `stream`; returns the launch's cudaError_t (0 when queued).
int ycc_canvas_launch(const void* descs, int n, int ph, int pw, void* out, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return 0;
  const int bands = (ph + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>((bands + kBands - 1) / kBands), static_cast<unsigned>(n),
                  static_cast<unsigned>((pw + kCols - 1) / kCols));
  ycc_canvas_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(descs), ph, pw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same after staging the descriptors: waits for `done` (recorded after
// the previous call with these buffers: its copy and its kernel have run),
// copies descs (n * 24 int64 words in any host memory) into `pinned` (host,
// page-locked) and from there into `dev_descs` (device) on `stream`, launches,
// and records `done` on `stream`.  Returns the first cudaError_t (0 when all
// is queued).
int ycc_canvas_stage_launch(const void* descs, void* pinned, void* dev_descs, void* done, int n,
                            int ph, int pw, void* out, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaEvent_t event = static_cast<cudaEvent_t>(done);
  const size_t bytes = static_cast<size_t>(n) * kDescWords * sizeof(long long);
  cudaError_t err = cudaEventSynchronize(event);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(pinned, descs, bytes);
  err = cudaMemcpyAsync(dev_descs, pinned, bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = ycc_canvas_launch(dev_descs, n, ph, pw, out, stream);
  if (launched != 0) return launched;
  return static_cast<int>(cudaEventRecord(event, s));
}

int ycc_desc_words() { return kDescWords; }

}  // extern "C"
