// ycc_canvas: the last steps of libjpeg's decode, and the decode pool's crop
// and pad, for a batch of JPEG component planes in device memory (nvJPEG's
// YUV output), in one launch.
//
// Replaces: no TPU kernel.  Its counterpart is libjpeg code inside the host
// decode pool (posetpu/native/decode_pool.cpp): jpeg_read_scanlines'
// chroma upsampling (jdsample.c, h2v1/h1v2/h2v2_fancy_upsample) and
// YCbCr->RGB conversion (jdcolor.c, ycc_rgb_convert), then the pool's
// integer crop window and zero padding (process_one).  Its plain version is
// posetpu_torch/native/ycc.py:window_canvas; the two agree bit for bit
// (integer arithmetic only).
//
// Bound: bytes.  Each output sample is a few integer operations; the least
// time is the planes read once plus the (N, ph, pw, 3) canvas written once
// at the card's memory rate.  Design: one thread per output pixel, the
// pixel's taps read straight from the planes (they hit L1/L2: neighbouring
// threads share them), three byte stores.  Simple first; shared-memory
// tiles and vector stores are for a later change.
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

#include <cuda_runtime.h>

namespace {

constexpr int kDescWords = 24;
constexpr int kThreads = 256;

// jdcolor.c: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
constexpr int kOneHalf = 1 << 15;
constexpr int kFix1_40200 = 91881;
constexpr int kFix1_77200 = 116130;
constexpr int kFix0_71414 = 46802;
constexpr int kFix0_34414 = 22554;

__device__ __forceinline__ int sample(const uint8_t* p, long long pitch, int x, int y) {
  return p[static_cast<long long>(y) * pitch + x];
}

// The component sample at full-resolution (x, y), as libjpeg-turbo's
// decoder upsamples it with do_fancy_upsampling: 3:1 taps with alternating
// rounding biases; rows and columns past the edge take the nearest real
// one; an h2 component of stored width <= 2 is replicated (h2v1_upsample,
// h2v2_upsample), h1v2 is always fancy.
__device__ int upsample(const uint8_t* p, long long pitch, int cw, int ch, int hf,
                        int vf, int x, int y) {
  if (hf == 1 && vf == 1) return sample(p, pitch, x, y);
  const int i = x >> 1, odd_x = x & 1;
  if (hf == 2 && cw <= 2) return sample(p, pitch, i, vf == 2 ? y >> 1 : y);
  if (vf == 1) {  // h2v1
    const int far = odd_x ? min(i + 1, cw - 1) : max(i - 1, 0);
    return (3 * sample(p, pitch, i, y) + sample(p, pitch, far, y) + (odd_x ? 2 : 1)) >> 2;
  }
  const int j = y >> 1, odd_y = y & 1;
  const int jf = odd_y ? min(j + 1, ch - 1) : max(j - 1, 0);
  if (hf == 1) {  // h1v2
    return (3 * sample(p, pitch, x, j) + sample(p, pitch, x, jf) + (odd_y ? 2 : 1)) >> 2;
  }
  // h2v2: column sums of the nearer and further rows, then 3:1 across
  const int far = odd_x ? min(i + 1, cw - 1) : max(i - 1, 0);
  const int s0 = 3 * sample(p, pitch, i, j) + sample(p, pitch, i, jf);
  const int s1 = 3 * sample(p, pitch, far, j) + sample(p, pitch, far, jf);
  return (3 * s0 + s1 + (odd_x ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void ycc_canvas_kernel(const long long* __restrict__ descs, int ph, int pw,
                                  uint8_t* __restrict__ out) {
  const long long pixels = static_cast<long long>(ph) * pw;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= pixels) return;
  const int n = blockIdx.y;
  const long long* d = descs + static_cast<long long>(n) * kDescWords;
  uint8_t* o = out + (static_cast<long long>(n) * pixels + idx) * 3;
  const int ox = static_cast<int>(idx % pw), oy = static_cast<int>(idx / pw);
  const int vw = static_cast<int>(d[21]), vh = static_cast<int>(d[22]);
  if (ox >= vw || oy >= vh) {
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const int x = ox + static_cast<int>(d[19]), y = oy + static_cast<int>(d[20]);
  const int yv = sample(reinterpret_cast<const uint8_t*>(d[0]), d[3], x, y);
  if (d[18] == 1) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(yv);
    return;
  }
  const int cb = upsample(reinterpret_cast<const uint8_t*>(d[1]), d[4], static_cast<int>(d[7]),
                          static_cast<int>(d[10]), static_cast<int>(d[13]),
                          static_cast<int>(d[16]), x, y) - 128;
  const int cr = upsample(reinterpret_cast<const uint8_t*>(d[2]), d[5], static_cast<int>(d[8]),
                          static_cast<int>(d[11]), static_cast<int>(d[14]),
                          static_cast<int>(d[17]), x, y) - 128;
  // arithmetic right shifts of signed ints, as jdcolor.c's RIGHT_SHIFT
  o[0] = clamp255(yv + ((kFix1_40200 * cr + kOneHalf) >> 16));
  o[1] = clamp255(yv + ((-kFix0_34414 * cb + kOneHalf - kFix0_71414 * cr) >> 16));
  o[2] = clamp255(yv + ((kFix1_77200 * cb + kOneHalf) >> 16));
}

}  // namespace

extern "C" {

// descs: n * 24 int64 words in device memory; out: (n, ph, pw, 3) uint8.
// Launches on `stream`; returns the launch's cudaError_t (0 when queued).
int ycc_canvas_launch(const void* descs, int n, int ph, int pw, void* out, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return 0;
  const long long pixels = static_cast<long long>(ph) * pw;
  const dim3 grid(static_cast<unsigned>((pixels + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  ycc_canvas_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(descs), ph, pw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int ycc_desc_words() { return kDescWords; }

}  // extern "C"
