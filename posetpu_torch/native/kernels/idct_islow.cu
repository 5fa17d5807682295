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
// & RANGE_MASK: the table is clamp(x + 128, 0, 255) on x's low 10 bits read
// as a signed number, which pass 2 computes by its last shift and a
// saturating pack.
//
// Bound: bytes.  At the loader's batch (32 frames of 1280x720 4:2:0) it
// reads 691,200 blocks of int16 coefficients (88.5 MB) and writes 44.2 MB
// of planes: 0.0396 ms at the card's memory rate.  Its integer work, about
// 1,300 operations a block, keeps the integer pipes (a warp's instruction
// in 2 cycles) about as long, and on the H100 that issue and the latency of
// each block's chain, not the bytes, set its time (PERF.md).
//
// Design: bulk-copied tiles on persistent blocks, with the instructions a
// block few and the warps free of one another: no division, search or
// descriptor load in the consumers, the table in registers, no
// transposition of coefficients, no block-wide barrier.
//  - A tile is up to kTileBlocks consecutive blocks of one block row of one
//    component: its coefficients are one contiguous span of the grid.  The
//    Tensor Memory Accelerator's bulk copies (cp.async.bulk) take each of
//    its blocks into shared memory 16 bytes apart (so that reading a column
//    of 4 blocks at once meets no bank twice), and the component's table,
//    all counted on the stage's "full" mbarrier.
//  - The grid is what the card keeps resident; each block takes an equal
//    run of consecutive tiles and walks it through a ring of kStages
//    stages.  A producer warp issues the copies, up to kStages tiles ahead,
//    each stage once its "empty" mbarrier says the consumer warps have read
//    it.  Its lane 0 steps through the descriptors in order (one search and
//    one division a block, at its first tile; a component's words loaded
//    once) and leaves the tile's geometry in the stage beside the copies.
//  - Each consumer warp takes 8 blocks of a tile in two rounds of 4, a
//    group of 8 lanes a block.  Lane c reads column c of its block from the
//    stage, dequantises it with column c of the table (held in registers
//    while the component stays the same), finds whether its AC terms are
//    zero (three ORs), runs pass 1 and writes the column into the warp's
//    workspace (rows of 12 words, blocks 104 words apart: no bank conflicts
//    in either pass); lane r runs pass 2 on row r, whose last shift gives
//    the range limit's signed 10 bits (its constants scaled by 16 to leave
//    them at the top of the word), packed to bytes with saturation, and
//    stores the row's 8 bytes (the 4 blocks of a warp: 32 contiguous bytes
//    a plane row), bytes at the plane's right edge or an unaligned row.
//
// Each component has a descriptor of DESC_WORDS int64 words:
//   0 coefficient offset, 1 table offset (int16 elements; multiples of 8)
//   2 the grid's blocks a row (its row stride, in blocks)
//   3-4 blocks wide and high that cover the plane
//   5 plane device pointer, 6 row pitch in bytes, 7-8 plane width, height
//   9 the component's first tile in the launch (ascending)
//   10 its tiles a block row, ceil(blocks wide / kTileBlocks)
//
// Build: nvcc (posetpu_torch/utils/cuda_build.py NVCC_FLAGS) -o <lib> idct_islow.cu

#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kDescWords = 11;
constexpr int kConsumers = 4;              // consumer warps; one producer warp more
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kRounds = 2;                 // blocks of a group of 8 lanes a tile
constexpr int kTileBlocks = 4 * kConsumers * kRounds;  // 8x8 blocks of a tile
constexpr int kStages = 4;                 // tiles staged at once
constexpr int kMinBlocks = 8;              // blocks an SM keeps resident
constexpr int kBlockStride = 72;           // a staged block, int16: 128 bytes, 16 apart
constexpr int kRowWords = 12;              // a workspace row: 8 values, 16-byte aligned
constexpr int kBlockWords = 8 * kRowWords + 8;  // 104: a block's rows, 8 banks on
static_assert(kTileBlocks <= 32, "the producer warp copies a tile's blocks a lane each");

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

// A stage of the ring: a tile's blocks and table, copied in bulk, and
// where its samples go, written by the lane that issues the copies.
struct alignas(16) Stage {
  int16_t coefs[kTileBlocks * kBlockStride];
  int16_t table[64];
  const uint8_t* plane;  // the tile's first sample: row by * 8, column bx0 * 8
  long long pitch;
  int rows;              // plane rows of the tile, up to 8
  int cols;              // plane columns of the tile, up to 8 * kTileBlocks
  int blocks;            // blocks of the tile
  int comp;              // its component
};

// The producer's place in the descriptors: the component of its last
// tile, that component's words, and the tile's grid row and first column.
struct Walk {
  const uint8_t* plane;
  long long coef_off, qt_off, stride, pitch;
  int comp, nbw, nbh, w, h, by, bx0;
};

// jidctint.c's 1-D pass over x[0..7] (int32, wrapping), each output
// DESCALEd by kShift.  Unsigned arithmetic wraps as the plain version's
// int32 tensors do; the shifts right are arithmetic.  With kScale > 0 every
// constant and the rounding are multiplied by 2^kScale and the shift is
// kShift + kScale: the same sums, kScale bits higher in the word (mod 2^32),
// so an output keeps only the DESCALEd value's low 32 - kShift - kScale
// bits, sign-extended.
template <int kShift, int kScale>
__device__ __forceinline__ void idct8(const int* x, int* out) {
  using u32 = unsigned;
  constexpr u32 m = 1u << kScale;
  const u32 z2 = x[2], z3 = x[6];
  const u32 z1 = (z2 + z3) * (4433u * m);                    // FIX_0_541196100
  const u32 tmp2 = z1 + z3 * (static_cast<u32>(-15137) * m);  // -FIX_1_847759065
  const u32 tmp3 = z1 + z2 * (6270u * m);                    // FIX_0_765366865
  constexpr u32 r = (1u << (kShift - 1)) * m;
  const u32 tmp0 = ((static_cast<u32>(x[0]) + static_cast<u32>(x[4])) << (kConstBits + kScale)) + r;
  const u32 tmp1 = ((static_cast<u32>(x[0]) - static_cast<u32>(x[4])) << (kConstBits + kScale)) + r;
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  u32 t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  u32 a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  const u32 z5 = (a3 + a4) * (9633u * m);                    // FIX_1_175875602
  t0 *= 2446u * m;                                           // FIX_0_298631336
  t1 *= 16819u * m;                                          // FIX_2_053119869
  t2 *= 25172u * m;                                          // FIX_3_072711026
  t3 *= 12299u * m;                                          // FIX_1_501321110
  a1 *= static_cast<u32>(-7373) * m;                         // -FIX_0_899976223
  a2 *= static_cast<u32>(-20995) * m;                        // -FIX_2_562915447
  a3 = a3 * (static_cast<u32>(-16069) * m) + z5;             // -FIX_1_961570560
  a4 = a4 * (static_cast<u32>(-3196) * m) + z5;              // -FIX_0_390180644
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  constexpr int s = kShift + kScale;
  out[0] = static_cast<int>(tmp10 + t3) >> s;
  out[1] = static_cast<int>(tmp11 + t2) >> s;
  out[2] = static_cast<int>(tmp12 + t1) >> s;
  out[3] = static_cast<int>(tmp13 + t0) >> s;
  out[4] = static_cast<int>(tmp13 - t0) >> s;
  out[5] = static_cast<int>(tmp12 - t1) >> s;
  out[6] = static_cast<int>(tmp11 - t2) >> s;
  out[7] = static_cast<int>(tmp10 - t3) >> s;
}

// The range limit of four signed 10-bit values y (x's low bits, x a
// DESCALEd sample): clamp(y + 128, 0, 255) as bytes, b0 in the low byte.
// Saturated to -128..127 and packed (two I2IP instructions), then
// + 128 in each byte as an XOR.
__device__ __forceinline__ uint32_t range_limit4(int b0, int b1, int b2, int b3) {
  uint32_t hi, word;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(hi) : "r"(b3), "r"(b2), "r"(0));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(word) : "r"(b1), "r"(b0), "r"(hi));
  return word ^ 0x80808080u;
}

// The staging's copies: one bulk copy (the Tensor Memory Accelerator's
// cp.async.bulk) from device memory into shared memory, its bytes counted
// on an mbarrier that the readers wait on.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// This thread's arrival.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// This thread's arrival, expecting the bytes of the copies it issues next.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
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

// A staged coefficient, sign-extended by the load itself (from a plain
// int16 load the compiler ORs the raw halves and widens each with one
// more instruction).
__device__ __forceinline__ int load_coef(const int16_t* p) {
  int v;
  asm volatile("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}

// Pass 1 on column c of a staged block (col: its first coefficient),
// dequantised by column c of the table (q), into the block's workspace.
__device__ __forceinline__ void column_pass(const int16_t* col, const int* q, int* ws, int c) {
  int cf[8], x[8], out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cf[i] = load_coef(col + 8 * i);
  const bool ac = (cf[1] | cf[2] | cf[3] | cf[4] | cf[5] | cf[6] | cf[7]) != 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = cf[i] * q[i];
  idct8<kConstBits - kPass1Bits, 0>(x, out);
  const int dc = static_cast<int>(static_cast<unsigned>(x[0]) << kPass1Bits);
#pragma unroll
  for (int i = 0; i < 8; ++i) ws[i * kRowWords + c] = ac ? out[i] : dc;
}

// Pass 2 on row c of a block's workspace, range-limited: the row's 8
// samples.
__device__ __forceinline__ uint2 row_pass(const int* ws, int c) {
  const int4* row = reinterpret_cast<const int4*>(ws + c * kRowWords);
  const int4 a = row[0], b = row[1];
  const int x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int y[8];
  // scaled by 16: the DESCALEd value's low 10 bits, signed
  idct8<kConstBits + kPass1Bits + 3, 4>(x, y);
  return make_uint2(range_limit4(y[0], y[1], y[2], y[3]), range_limit4(y[4], y[5], y[6], y[7]));
}

// The producer's walk onto component c's descriptor.
__device__ __forceinline__ void walk_to(Walk& w, const long long* descs, int c) {
  const long long* d = descs + static_cast<long long>(c) * kDescWords;
  w.comp = c;
  w.coef_off = __ldg(d + 0);
  w.qt_off = __ldg(d + 1);
  w.stride = __ldg(d + 2);
  w.nbw = static_cast<int>(__ldg(d + 3));
  w.nbh = static_cast<int>(__ldg(d + 4));
  w.plane = reinterpret_cast<const uint8_t*>(__ldg(d + 5));
  w.pitch = __ldg(d + 6);
  w.w = static_cast<int>(__ldg(d + 7));
  w.h = static_cast<int>(__ldg(d + 8));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
idct_islow_kernel(const long long* __restrict__ descs, int n, long long tiles,
                  const int16_t* __restrict__ coefs, const int16_t* __restrict__ qtables) {
  __shared__ Stage stages[kStages];
  __shared__ uint64_t full[kStages];   // a stage's copies have landed: one phase a tile
  __shared__ uint64_t empty[kStages];  // the consumers have read a stage: one phase a tile
  __shared__ __align__(16) int workspace[kConsumers][4 * kBlockWords];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this block's run of tiles, [first, first + count)
  const long long first = blockIdx.x * tiles / gridDim.x;
  const int count = static_cast<int>((blockIdx.x + 1) * tiles / gridDim.x - first);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer: the run's tiles into the ring, in order
    Walk w;
    if (lane == 0) {
      // the component of the first tile: the last whose first tile is at
      // or below it; its grid row and column
      int lo = 0, hi = n - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(descs + static_cast<long long>(mid) * kDescWords + 9) <= first) lo = mid;
        else hi = mid - 1;
      }
      walk_to(w, descs, lo);
      const long long* d = descs + static_cast<long long>(lo) * kDescWords;
      const unsigned local = static_cast<unsigned>(first - __ldg(d + 9));
      const unsigned per_row = static_cast<unsigned>(__ldg(d + 10));
      w.by = static_cast<int>(local / per_row);
      w.bx0 = static_cast<int>(local - w.by * per_row) * kTileBlocks;
    }
    for (int j = 0; j < count; ++j) {
      const int s = j % kStages;
      if (j >= kStages) bar_wait(&empty[s], (j / kStages - 1) & 1);
      Stage& st = stages[s];
      const int16_t* src = nullptr;
      int blocks = 0;
      if (lane == 0) {
        if (j > 0) {  // the next tile of the block row, or of the next row or component
          w.bx0 += kTileBlocks;
          if (w.bx0 >= w.nbw) {
            w.bx0 = 0;
            if (++w.by >= w.nbh) {
              w.by = 0;
              walk_to(w, descs, w.comp + 1);
            }
          }
        }
        blocks = min(kTileBlocks, w.nbw - w.bx0);
        st.plane = w.plane + w.by * 8 * w.pitch + w.bx0 * 8;
        st.pitch = w.pitch;
        st.rows = min(8, w.h - w.by * 8);
        st.cols = min(8 * blocks, w.w - w.bx0 * 8);
        st.blocks = blocks;
        st.comp = w.comp;
        src = coefs + w.coef_off + (w.by * w.stride + w.bx0) * 64;
        bar_arrive_tx(&full[s], 128u * (blocks + 1));
        bulk_copy(st.table, qtables + w.qt_off, 128, &full[s]);
      }
      blocks = __shfl_sync(0xFFFFFFFFu, blocks, 0);
      src = reinterpret_cast<const int16_t*>(
          __shfl_sync(0xFFFFFFFFu, reinterpret_cast<long long>(src), 0));
      if (lane < blocks) bulk_copy(st.coefs + lane * kBlockStride, src + lane * 64, 128, &full[s]);
    }
    return;
  }

  // the consumers
  const int g = lane >> 3, c = lane & 7;  // the lane's block slot, and its column and row
  int* const ws = workspace[warp] + g * kBlockWords;
  int comp = -1;
  int q[8];  // column c of the component's table
  for (int j = 0; j < count; ++j) {
    const int s = j % kStages;
    const Stage& st = stages[s];
    bar_wait(&full[s], (j / kStages) & 1);
    uint8_t* const plane = const_cast<uint8_t*>(st.plane);
    const long long pitch = st.pitch;
    const int rows = st.rows, cols = st.cols, blocks = st.blocks;
    // every row and column of the tile's blocks inside the plane, rows
    // 8-byte aligned: the route's tiles but a plane's last row or column
    const bool whole = rows == 8 && cols == 8 * blocks &&
                       ((reinterpret_cast<uintptr_t>(plane) | pitch) & 7) == 0;
    if (st.comp != comp) {
      comp = st.comp;
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = static_cast<uint16_t>(st.table[8 * i + c]);
    }
#pragma unroll
    for (int round = 0; round < kRounds; ++round) {
      const int first_k = 4 * (kRounds * warp + round);
      if (first_k >= blocks) break;  // the whole warp: a ragged tile's end
      const int k = first_k + g;     // the group's block in the tile
      column_pass(st.coefs + k * kBlockStride + c, q, ws, c);
      __syncwarp();
      const uint2 v = row_pass(ws, c);
      // row c of the block into the plane: 8 bytes, or bytes at its edge
      const int left = cols - 8 * k;
      if (whole) {
        if (k < blocks) *reinterpret_cast<uint2*>(plane + c * pitch + 8 * k) = v;
      } else if (c < rows && left > 0) {
        uint8_t* dst = plane + c * pitch + 8 * k;
        if (left >= 8 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
          *reinterpret_cast<uint2*>(dst) = v;
        } else {
          for (int b = 0; b < 8 && b < left; ++b)
            dst[b] = static_cast<uint8_t>((b < 4 ? v.x >> (8 * b) : v.y >> (8 * (b - 4))) & 0xFF);
        }
      }
      __syncwarp();  // the workspace is read before the next round writes it
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }
}

// The kernel's grid on the current device: what the card keeps resident,
// the SMs times the blocks an SM takes, read once a device.
int resident_blocks() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 64 && cached[dev].load() > 0) return cached[dev].load();
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_islow_kernel, kThreads, 0) !=
          cudaSuccess)
    return 0;
  const int blocks = sms * per_sm;
  if (dev < 64) cached[dev].store(blocks);
  return blocks;
}

}  // namespace

extern "C" {

// descs: n * 11 int64 words in device memory; tiles: the tiles of the launch
// (the last descriptor's first tile plus its count); coefs and qtables:
// int16 device buffers the descriptors' offsets index, 16-byte aligned.
// Launches on `stream`; returns the launch's cudaError_t.
int idct_islow_launch(const void* descs, int n, long long tiles, const void* coefs,
                      const void* qtables, void* stream) {
  if (n <= 0 || tiles <= 0) return 0;
  const int resident = resident_blocks();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  idct_islow_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(descs), n, tiles, static_cast<const int16_t*>(coefs),
      static_cast<const int16_t*>(qtables));
  return static_cast<int>(cudaGetLastError());
}

// The same after staging the descriptors: waits for `done` (recorded after
// the previous call with these buffers: its copy and its kernel have run),
// copies descs (n * 11 int64 words in any host memory) into `pinned` (host,
// page-locked) and from there into `dev_descs` (device) on `stream`,
// launches, and records `done` on `stream`.  Returns the first cudaError_t
// (0 when all is queued).
int idct_islow_stage_launch(const void* descs, void* pinned, void* dev_descs, void* done, int n,
                            long long tiles, const void* coefs, const void* qtables,
                            void* stream) {
  if (n <= 0 || tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaEvent_t event = static_cast<cudaEvent_t>(done);
  const size_t bytes = static_cast<size_t>(n) * kDescWords * sizeof(long long);
  cudaError_t err = cudaEventSynchronize(event);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(pinned, descs, bytes);
  err = cudaMemcpyAsync(dev_descs, pinned, bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = idct_islow_launch(dev_descs, n, tiles, coefs, qtables, stream);
  if (launched != 0) return launched;
  return static_cast<int>(cudaEventRecord(event, s));
}

}  // extern "C"
