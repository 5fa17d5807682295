// Convolution bias for Hopper (sm_90a): the forward's in-place add and the
// backward's bias gradient, for every biased convolution of the stacked
// hourglass (posetpu_torch/models/conv_bias.py).
//
// Replaces no TPU kernel: XLA fused the bias into the convolution.  On cuDNN
// torch's _convolution runs the convolution without its bias and then
// output.add_(bias.reshape(1, C, 1, 1)).  The broadcast operand sends that
// add to TensorIterator's legacy elementwise_kernel<128,4>, which computes an
// offset for each element and moves one bf16 at a time.
// convolution_backward takes the bias gradient as grad_output.sum((0, 2, 3)):
// over a channels-last tensor a column reduction, reduce_kernel<128,4>.
//
// Bound: bytes.  The add reads and writes each element once, the gradient
// reads each element once and writes C.  hg8 at 256^2 has 86,441,984
// conv-output elements an image: a train step of 32 moves 11.06 GB for the
// adds (3.30 ms at 3.35 TB/s) and 5.53 GB for the gradients (1.65 ms).
//
// Both take channels-last bf16 or float tensors only, the layout of every
// convolution output of the hourglass on the card (its forward permutes an
// NHWC input): a dense (rows, C) matrix, rows = N*H*W.
//
// Design:
// - Add: 16-byte vectors (8 bf16, 4 float) where the row of
//   channels holds whole vectors and the pointers are 16-byte aligned, else
//   one element; a grid-stride loop.  A vector's channels are its index mod
//   C/V, the bias vector one 16-byte load that stays in L1.  The sum runs in
//   float and is rounded once to the element type, as
//   torch's add_ computes it, so the output equals it bit for bit.
// - Gradient: the (rows, C) gradient summed down its columns.  A block of
//   1024 threads covers a tile of up to 1024 columns (grid y walks the
//   tiles): each thread owns one vector of columns and a strided set of
//   rows, with four loads in flight, and sums in float.  The block sums its
//   rows in shared memory and writes one partial row.
// - One launch: the last block to finish (an atomic ticket) sums the partial
//   rows in a fixed order, writes the gradient rounded once to the element
//   type (torch's bf16 sum also rounds its float sum once), and resets the
//   ticket for the next launch or graph replay.  Every order is fixed by the
//   shape and the grid, so the result is deterministic.  The tickets are
//   __device__ globals, one slot for each stream the wrapper launches on:
//   launches on one stream run one after another.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAddThreads = 256;
constexpr int kAddBlocksPerSm = 8;
constexpr int kSumThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kTicketSlots = 64;
constexpr int kCluster = 8;

__device__ unsigned int g_tickets[kTicketSlots];

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ void store_as(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_as(float& d, float v) { d = v; }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// out[e] = T(float(out[e]) + float(bias[e mod C])) for every element e < 2^31 of
// the channels-last output (32-bit indices; C % V == 0).
template <typename T, int V>
__global__ void __launch_bounds__(kAddThreads) bias_add_kernel(
    T* __restrict__ out, const T* __restrict__ bias, uint32_t nvec, uint32_t C) {
  using I = uint32_t;
  Vec<T, V>* __restrict__ vout = reinterpret_cast<Vec<T, V>*>(out);
  const Vec<T, V>* __restrict__ vbias = reinterpret_cast<const Vec<T, V>*>(bias);
  const I stride = (I)gridDim.x * kAddThreads;
  const I cvecs = C / V;
  for (I v = (I)blockIdx.x * kAddThreads + threadIdx.x; v < nvec; v += stride) {
    Vec<T, V> x = vout[v];
    const Vec<T, V> b = vbias[v % cvecs];
#pragma unroll
    for (int k = 0; k < V; ++k) store_as(x.v[k], add_rn(widen(x.v[k]), widen(b.v[k])));
    vout[v] = x;
  }
}

template <typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const Vec<T, V>& x) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = add_rn(acc[k], widen(x.v[k]));
}

// Every block calls this last.  The last block of the grid to arrive sums
// the (nparts, C) partial rows into out, P threads a column (each a strided
// set of rows, then the P sums in order), and resets its ticket.
template <typename T>
__device__ void finish(const float* partial, int nparts, int C,
                       T* __restrict__ out, int slot, float* sm) {
  __shared__ bool last;
  __threadfence();  // this block's partial row, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    last = atomicAdd(&g_tickets[slot], 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int base = 0; base < C; base += kSumThreads) {
    const int w = min(C - base, kSumThreads);
    const int P = kSumThreads / w;
    const int j = threadIdx.x % w;
    const int p = threadIdx.x / w;
    float s = 0;
    if (p < P) {
      const float* col = partial + base + j;
#pragma unroll 8
      for (int b = p; b < nparts; b += P) s = add_rn(s, __ldcg(col + (size_t)b * C));
    }
    sm[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < w) {
      float t = sm[threadIdx.x];
      for (int q = 1; q < P; ++q) t = add_rn(t, sm[q * w + threadIdx.x]);
      store_as(out[base + threadIdx.x], t);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) g_tickets[slot] = 0;
}

// g is (rows, C) dense, C % V == 0.  A block takes R =
// kSumThreads / tile rows at a time over a tile of `tile` column vectors
// (tile * V <= kSumThreads); block (x, y) sums rows x*R + ty, stepping by
// gridDim.x * R, of tile y, kUnroll loads in flight a round (the last round
// predicated, so that no load waits on another).  Its shared rows are laid
// out [k][thread] with a plane of kSumThreads + tile, so that the stores
// (consecutive threads) and the column sums (consecutive k * tile + tx) meet
// no bank conflict.  Returns, to thread j < tile * V, the block's sum of
// column column_of(j, tile) of its tile.
template <typename T, int V>
__device__ __forceinline__ float block_column_sums(
    const T* __restrict__ g, long long rows, int C, int tile, float* rows_sm,
    float* cols_sm) {
  const int cvecs = C / V;
  const int R = kSumThreads / tile;
  const int tx = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const int cv = blockIdx.y * tile + tx;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0;
  if (ty < R && cv < cvecs) {
    const Vec<T, V>* p = reinterpret_cast<const Vec<T, V>*>(g) + cv;
    const long long step = (long long)gridDim.x * R;
    for (long long r = (long long)blockIdx.x * R + ty; r < rows; r += kUnroll * step) {
      Vec<T, V> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < rows) x[u] = p[(r + u * step) * cvecs];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < rows) accumulate<T, V>(acc, x[u]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) rows_sm[k * (kSumThreads + tile) + threadIdx.x] = acc[k];
  __syncthreads();
  // column (k, tx) of the tile, summed over the R rows by P threads each
  const int width = tile * V;
  const int P = kSumThreads / width;
  {
    const int j = threadIdx.x % width;
    const int p = threadIdx.x / width;
    const float* src = rows_sm + (j / tile) * (kSumThreads + tile) + j % tile;
    float s = 0;
    if (p < P) {
      for (int q = p; q < R; q += P) s = add_rn(s, src[q * tile]);
    }
    cols_sm[threadIdx.x] = s;
  }
  __syncthreads();
  float t = 0;
  if (threadIdx.x < width) {
    t = cols_sm[threadIdx.x];
    for (int q = 1; q < P; ++q) t = add_rn(t, cols_sm[q * width + threadIdx.x]);
  }
  return t;
}

// The column of a tile that thread j < tile * V sums: (k, tx) = (j / tile,
// j % tile) is column tx * V + k.
__device__ __forceinline__ int column_of(int j, int tile, int V) {
  return (j % tile) * V + j / tile;
}

template <typename T, int V>
__global__ void __launch_bounds__(kSumThreads) bias_grad_rows_kernel(
    const T* __restrict__ g, long long rows, int C, int tile,
    float* __restrict__ partial, T* __restrict__ out, int slot) {
  __shared__ float rows_sm[V * kSumThreads + kSumThreads];
  __shared__ float cols_sm[kSumThreads];
  const float t = block_column_sums<T, V>(g, rows, C, tile, rows_sm, cols_sm);
  if (threadIdx.x < tile * V) {
    const int col = blockIdx.y * tile * V + column_of(threadIdx.x, tile, V);
    if (col < C) partial[(size_t)blockIdx.x * C + col] = t;
  }
  finish<T>(partial, gridDim.x, C, out, slot, cols_sm);
}

// One tile (C / V <= tile): a cluster of kCluster blocks sums
// its rows as bias_grad_rows_kernel's blocks do, and block 0 adds the
// blocks' column sums in rank order from their shared memory.  No partial
// rows in device memory and no ticket: the small gradients, whose time is
// the chain of dependent steps and not their bytes, take one cluster
// barrier instead of a fence, an atomic and a second read.
template <typename T, int V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSumThreads)
    bias_grad_cluster_kernel(const T* __restrict__ g, long long rows, int C, int tile,
                             T* __restrict__ out) {
  __shared__ float rows_sm[V * kSumThreads + kSumThreads];
  __shared__ float cols_sm[kSumThreads];
  __shared__ float sums_sm[kSumThreads];
  const float t = block_column_sums<T, V>(g, rows, C, tile, rows_sm, cols_sm);
  const int width = tile * V;
  if (threadIdx.x < width) sums_sm[threadIdx.x] = t;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < width) {
    float s = sums_sm[threadIdx.x];
    for (int r = 1; r < kCluster; ++r)
      s = add_rn(s, cluster.map_shared_rank(sums_sm, r)[threadIdx.x]);
    const int col = column_of(threadIdx.x, tile, V);
    if (col < C) store_as(out[col], s);
  }
  cluster.sync();  // each block's shared memory stays until block 0 has read it
}

template <typename T, int V>
void launch_add(void* out, const void* bias, long long numel, int C, int sms,
                cudaStream_t stream) {
  const long long nvec = numel / V;
  long long blocks = (nvec + kAddThreads - 1) / kAddThreads;
  if (blocks > (long long)sms * kAddBlocksPerSm) blocks = (long long)sms * kAddBlocksPerSm;
  bias_add_kernel<T, V><<<(int)blocks, kAddThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(bias), (uint32_t)nvec, (uint32_t)C);
}

template <typename T>
int add_by_width(void* out, const void* bias, long long numel, int C, int vec, int sms,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    launch_add<T, kVec>(out, bias, numel, C, sms, stream);
  } else if (vec == 1) {
    launch_add<T, 1>(out, bias, numel, C, sms, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T, int V>
void launch_grad(const void* grad, long long rows, int C, int blocks, int tile, int cluster,
                 void* partial, void* out, int slot, cudaStream_t stream) {
  if (cluster) {
    bias_grad_cluster_kernel<T, V><<<kCluster, kSumThreads, 0, stream>>>(
        static_cast<const T*>(grad), rows, C, tile, static_cast<T*>(out));
  } else {
    const int tiles = (C / V + tile - 1) / tile;
    bias_grad_rows_kernel<T, V><<<dim3(blocks, tiles), kSumThreads, 0, stream>>>(
        static_cast<const T*>(grad), rows, C, tile, static_cast<float*>(partial),
        static_cast<T*>(out), slot);
  }
}

template <typename T>
int grad_by_width(const void* grad, long long rows, int C, int vec, int blocks, int tile,
                  int cluster, void* partial, void* out, int slot, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  if (tile * vec > kSumThreads) return (int)cudaErrorInvalidValue;
  // a cluster covers gradients of one tile with kCluster blocks
  if (cluster && (C / vec > tile || blocks != kCluster)) return (int)cudaErrorInvalidValue;
  if (vec == kVec) {
    launch_grad<T, kVec>(grad, rows, C, blocks, tile, cluster, partial, out, slot, stream);
  } else {
    launch_grad<T, 1>(grad, rows, C, blocks, tile, cluster, partial, out, slot, stream);
  }
  return 0;
}

}  // namespace

// out: channels-last, numel elements (at most 2^31 - 1), C channels.
// dtype: 0 bf16, 1 float.  vec: 16 / element size, or 1.
// sms: the card's SMs.
extern "C" int conv_bias_add_launch(void* out, const void* bias, long long numel, int C,
                                    int dtype, int vec, int sms, cudaStream_t stream) {
  if (numel <= 0) return 0;
  if (numel > INT32_MAX || C <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  int err;
  switch (dtype) {
    case 0: err = add_by_width<__nv_bfloat16>(out, bias, numel, C, vec, sms, stream); break;
    case 1: err = add_by_width<float>(out, bias, numel, C, vec, sms, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// grad (rows, C) dense, channels-last; partial holds blocks * C float sums;
// out (C,) in grad's type; slot < 64 names the ticket.
// tile: column vectors a block covers.  cluster: one cluster of 8 blocks
// instead (one tile, blocks == 8; partial and slot unused).
extern "C" int conv_bias_grad_launch(const void* grad, long long rows, int C, int dtype,
                                     int vec, int blocks, int tile, int cluster,
                                     void* partial, void* out, int slot,
                                     cudaStream_t stream) {
  if (C <= 0 || rows < 0 || blocks <= 0 || tile <= 0 || slot < 0 || slot >= kTicketSlots)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (dtype) {
    case 0:
      err = grad_by_width<__nv_bfloat16>(grad, rows, C, vec, blocks, tile, cluster, partial,
                                         out, slot, stream);
      break;
    case 1:
      err = grad_by_width<float>(grad, rows, C, vec, blocks, tile, cluster, partial, out,
                                 slot, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
