// BatchNorm followed by ReLU, fused, for Hopper (sm_90a): the train-mode
// forward (batch statistics, then the normalized and rectified output), its
// backward, and the eval-mode forward, for every norm of the stacked
// hourglass (posetpu_torch/models/bn_relu.py).
//
// Replaces no TPU kernel: XLA fused the norm and its ReLU into the
// neighbouring fusions.  On the card torch runs a channels-last norm as four
// kernels (batch_norm_collect_statistics, batch_norm_transform_input,
// batch_norm_backward_reduce, batch_norm_backward_elemt), each over the whole
// activation, and the ReLU after it as two more passes (its clamp forward,
// threshold_backward after).
//
// Bound: bytes.  bf16 activations with float32 statistics, per element: the
// statistics read x (2 B), the apply reads x and writes r = relu(z) (4 B);
// the backward's sums read dr and x (4 B), its elementwise pass reads dr and
// x and writes dx (6 B): 16 B an element a train step, where torch's norm
// alone moves 16 and its ReLU 10 more.  The eval forward reads x and writes
// r (4 B, torch 8 with its ReLU).
//
// All kernels take a dense (rows, C) matrix, rows = N*H*W: a channels-last
// (N, C, H, W) tensor, bf16 or float, C % 8 == 0, 16-byte aligned.  A thread
// owns one vector of V channels of a tile of column vectors and a strided
// set of rows (16-byte vectors in the statistics and the apply; 8-byte ones
// in the sums and the gradient's elementwise pass, which keep more
// per-channel values), and loads every per-channel value it needs once.
//
// Design:
// - Statistics: each thread keeps float (count, mean, M2) for its channels
//   by Welford's update, four loads in flight; a block merges its threads'
//   by Chan's parallel rule in shared memory and writes one partial row.  No
//   unshifted E[x^2] - E[x]^2.
// - One launch finishes them: the last block to arrive (an atomic ticket, as
//   in conv_bias.cu) merges the partial rows in a fixed order, writes mean
//   and invstd = rsqrt(var + eps) (var biased, as torch's training norm
//   takes it), updates the running statistics as torch's BatchNorm2d does
//   (unbiased variance, momentum), adds one to num_batches_tracked, and
//   resets its ticket.  Every order is fixed by the shape and the grid, so
//   the result is deterministic and capturable in a CUDA graph.
// - Apply: z = w * (x - mean) * invstd + b in float, in the order of torch's
//   channels-last transform kernel, r = relu(T(z)).  Given the same
//   statistics r is torch's F.relu(batch_norm(x)) bit for bit.  The
//   pre-ReLU tensor is never stored.
// - Backward: the mask is rebuilt from x and the saved statistics as
//   T(z) > 0, which is what threshold_backward sees as r > 0.  A pass like
//   the statistics' sums dz and dz * (x - mean) per channel in float (block
//   partial rows, a ticket's last block in a fixed order), giving the bias
//   and weight gradients and the coefficients of the elementwise pass,
//   dx = (dz - mean(dz) - (x - mean) * invstd^2 * mean(dz * (x - mean)))
//        * w * invstd, as torch's batch_norm_backward_elemt computes it.
// - Small norms (whose activations the wrapper finds under 256 KiB: hg8's
//   4^2 ones at batch 32) run forward and backward each as one launch of
//   one cluster of 8 blocks: the blocks merge their statistics (or sums)
//   over distributed shared memory, each in rank order, so that every block
//   holds the same result, and then apply it to its own rows.  Their second
//   read of x (and dr) is served by the L2: the whole tensor was read by the
//   same blocks a few microseconds before.  No partial rows in device
//   memory, no ticket, one launch where the others take two: these norms'
//   time is the chain of dependent steps, not their bytes.
// - Eval: one pass, with invstd = rsqrt(running_var + eps) computed a
//   thread, as torch's eval norm computes its invstd, and the train apply's
//   arithmetic.

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// the statistics' and sums' blocks: 512 threads, one block an SM, so that
// a thread may hold up to 128 registers (at 1024 threads the sums' loads in
// flight and per-channel constants spilled at 64, and their loads waited
// on the spills: on the H100 the backward took 17.8 ms a train step, 11.8
// at 512)
constexpr int kThreads = 512;
constexpr int kApplyThreads = 512;  // the elementwise passes' blocks
// loads in flight a thread: the reductions' threads (16-byte vectors for
// the statistics, 8 for the sums) and the elementwise passes' (16-byte
// vectors for the apply, 8 for the gradient)
constexpr int kSumUnroll = 8;
constexpr int kApplyUnroll = 4;
// partial rows a thread of the last block loads at once: its sums are a
// chain of dependent adds, its loads need not be
constexpr int kPartBatch = 16;
constexpr int kTicketSlots = 64;
constexpr int kCluster = 8;
// a block's merge stages at most half its threads' states; a cluster takes
// norms of at most this many channels
constexpr int kStage = kThreads / 2;

__device__ unsigned int g_tickets[kTicketSlots];

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }

__device__ __forceinline__ void store_as(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_as(float& d, float v) { d = v; }

// v as the element type T would hold it, widened again
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rounded(float v, float) { return v; }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The per-channel constants of one thread's V channels.
template <int V>
struct Channels {
  float mean[V], invstd[V], w[V], b[V];
};

// torch's channels-last transform, w * (x - mean) * invstd + b, in float as
// torch's build computes it: the last multiply and the add one FMA (the
// library is built with --fmad=false, so the FMA is written out)
__device__ __forceinline__ float pre_relu(float x, float mean, float invstd, float w, float b) {
  return __fmaf_rn(__fmul_rn(w, __fsub_rn(x, mean)), invstd, b);
}

// relu(T(z)) as F.relu sees T(z): z > 0 keeps T(z) (which may round to +0),
// z <= 0 gives +0, NaN stays NaN
__device__ __forceinline__ float relu_of(float z) { return (z > 0.f || z != z) ? z : 0.f; }

// the rebuilt ReLU mask: T(z) > 0, i.e. r > 0
template <typename T>
__device__ __forceinline__ bool passes(float z) {
  return rounded(z, T()) > 0.f;
}

// A block's layout over tile `index` of column vectors: tile threads across
// the tile, R rows at once (a power of two), threads beyond tile * R idle.
struct Layout {
  int tile, R, tx, ty, cv;
  bool active;
  __device__ Layout(int tile_, int cvecs, int threads, int index) {
    tile = tile_;
    R = 1;
    while (R * 2 * tile <= threads) R *= 2;
    tx = threadIdx.x % tile;
    ty = threadIdx.x / tile;
    cv = index * tile + tx;
    active = ty < R && cv < cvecs;
  }
};

template <int V>
__device__ __forceinline__ void load_channels(Channels<V>& k, int c0, const float* mean,
                                              const float* invstd, const float* w,
                                              const float* b) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k.mean[j] = mean[c0 + j];
    k.invstd[j] = invstd[c0 + j];
    k.w[j] = w[c0 + j];
    k.b[j] = b[c0 + j];
  }
}

// ---- statistics -----------------------------------------------------------

// Chan's rule: (n, mean, m2) with (nb, meanb, m2b) merged in.
template <int V>
__device__ __forceinline__ void chan_merge(int& n, float (&mean)[V], float (&m2)[V], int nb,
                                           const float* meanb, const float* m2b, int stride) {
  const int total = n + nb;
  if (nb == 0 || total == 0) return;
  const float fb = __fdiv_rn((float)nb, (float)total);
  const float na = (float)n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float mb = meanb[j * stride], qb = m2b[j * stride];
    const float delta = __fsub_rn(mb, mean[j]);
    mean[j] = __fadd_rn(mean[j], __fmul_rn(delta, fb));
    m2[j] = __fadd_rn(__fadd_rn(m2[j], qb), __fmul_rn(__fmul_rn(__fmul_rn(delta, delta), na), fb));
  }
  n = total;
}

// One thread's Welford statistics of its rows r0, r0 + step, ... of column
// vector cv.
template <typename T, int V, int U>
__device__ __forceinline__ void thread_stats(const T* __restrict__ x, long long rows, int cvecs,
                                             int cv, long long r0, long long step, int& n,
                                             float (&mean)[V], float (&m2)[V]) {
  const Vec<T, V>* p = reinterpret_cast<const Vec<T, V>*>(x) + cv;
  for (long long r = r0; r < rows; r += U * step) {
    Vec<T, V> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) v[u] = p[(r + u * step) * cvecs];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
        ++n;
        const float inv = __frcp_rn((float)n);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = widen(v[u].v[j]);
          const float d = __fsub_rn(xv, mean[j]);
          mean[j] = __fadd_rn(mean[j], __fmul_rn(d, inv));
          m2[j] = __fadd_rn(m2[j], __fmul_rn(d, __fsub_rn(xv, mean[j])));
        }
      }
    }
  }
}

// The block's threads' statistics merged down its R rows of threads (a
// tree over ty, fixed by R): thread ty == 0 of each column ends with the
// block's.  Shared: s_n[kStage], s_mean and s_m2 [V * kStage].
template <int V>
__device__ __forceinline__ void block_merge(const Layout& L, int& n, float (&mean)[V],
                                            float (&m2)[V], int* s_n, float* s_mean,
                                            float* s_m2) {
  for (int half = L.R / 2; half > 0; half /= 2) {
    const int slot = (L.ty - half) * L.tile + L.tx;
    if (L.ty >= half && L.ty < 2 * half) {
      s_n[slot] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_mean[j * kStage + slot] = mean[j];
        s_m2[j * kStage + slot] = m2[j];
      }
    }
    __syncthreads();
    if (L.ty < half) {
      const int from = L.ty * L.tile + L.tx;
      chan_merge<V>(n, mean, m2, s_n[from], s_mean + from, s_m2 + from, kStage);
    }
    __syncthreads();
  }
}

struct Stats {
  float* mean;           // (C,) the batch mean, saved for the backward
  float* invstd;         // (C,) rsqrt(biased var + eps), saved
  float* running_mean;   // (C,) or null: left alone (a recompute)
  float* running_var;    // (C,) or null
  long long* batches;    // num_batches_tracked, or null
  float momentum, eps, bessel;  // bessel: n / (n - 1)
};

// Channel c's final statistics from its merged (n, mean, m2): saved, and
// the running statistics updated as torch's update_stats does.
__device__ __forceinline__ void finish_channel(const Stats& s, int c, int n, float mean,
                                               float m2) {
  const float var = __fdiv_rn(m2, (float)n);
  s.mean[c] = mean;
  s.invstd[c] = rsqrtf(__fadd_rn(var, s.eps));
  if (s.running_mean != nullptr) {
    const float keep = __fsub_rn(1.f, s.momentum);
    s.running_mean[c] =
        __fadd_rn(__fmul_rn(mean, s.momentum), __fmul_rn(keep, s.running_mean[c]));
    s.running_var[c] = __fadd_rn(__fmul_rn(__fmul_rn(var, s.bessel), s.momentum),
                                 __fmul_rn(keep, s.running_var[c]));
  }
}

// The last block to arrive (of every block of the grid) merges the partial
// rows (nparts, C) of means and m2s, whose counts are part_n[nparts], into
// the statistics; P threads a channel, each a strided set of partial rows
// in order, then the P results in order.  Shared: s_n[kThreads], s_mean and
// s_m2 at least [kThreads].
__device__ void finish_stats(const float* part_mean, const float* part_m2, const int* part_n,
                             int nparts, int C, const Stats& s, int slot, int* s_n,
                             float* s_mean, float* s_m2) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    last = atomicAdd(&g_tickets[slot], 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int base = 0; base < C; base += kThreads) {
    const int w = min(C - base, kThreads);
    const int P = kThreads / w;
    const int c = threadIdx.x % w, p = threadIdx.x / w;
    int n = 0;
    float mean[1] = {0.f}, m2[1] = {0.f};
    if (p < P) {
      for (int b0 = p; b0 < nparts; b0 += kPartBatch * P) {
        float mb[kPartBatch], qb[kPartBatch];
        int nb[kPartBatch];
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) {
          const int b = b0 + u * P;
          const bool in = b < nparts;
          mb[u] = in ? __ldcg(part_mean + (size_t)b * C + base + c) : 0.f;
          qb[u] = in ? __ldcg(part_m2 + (size_t)b * C + base + c) : 0.f;
          nb[u] = in ? __ldcg(part_n + b) : 0;
        }
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) chan_merge<1>(n, mean, m2, nb[u], &mb[u], &qb[u], 0);
      }
      s_n[threadIdx.x] = n;
      s_mean[threadIdx.x] = mean[0];
      s_m2[threadIdx.x] = m2[0];
    }
    __syncthreads();
    if (threadIdx.x < w) {
      for (int q = 1; q < P; ++q) {
        const int from = q * w + threadIdx.x;
        chan_merge<1>(n, mean, m2, s_n[from], s_mean + from, s_m2 + from, 0);
      }
      finish_channel(s, base + threadIdx.x, n, mean[0], m2[0]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (s.batches != nullptr) *s.batches += 1;
    g_tickets[slot] = 0;
  }
}

// grid (tiles, blocks): block (x, y) takes rows y*R + ty, stepping by
// blocks * R, of tile x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) batch_norm_relu_stats_kernel(
    const T* __restrict__ x, long long rows, int C, int tile, float* __restrict__ part_mean,
    float* __restrict__ part_m2, int* __restrict__ part_n, Stats s, int slot) {
  __shared__ int s_n[kThreads];
  __shared__ float s_mean[V * kStage];
  __shared__ float s_m2[V * kStage];
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kThreads, blockIdx.x);
  int n = 0;
  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  if (L.active) {
    thread_stats<T, V, kSumUnroll>(x, rows, cvecs, L.cv, (long long)blockIdx.y * L.R + L.ty,
                       (long long)gridDim.y * L.R, n, mean, m2);
  }
  block_merge<V>(L, n, mean, m2, s_n, s_mean, s_m2);
  if (L.ty == 0 && L.cv < cvecs) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part_mean[(size_t)blockIdx.y * C + L.cv * V + j] = mean[j];
      part_m2[(size_t)blockIdx.y * C + L.cv * V + j] = m2[j];
    }
    if (L.tx == 0 && blockIdx.x == 0) part_n[blockIdx.y] = n;
  }
  finish_stats(part_mean, part_m2, part_n, gridDim.y, C, s, slot, s_n, s_mean, s_m2);
}

// ---- apply ----------------------------------------------------------------

// r = relu(T(z)) over rows r0, r0 + step, ... of column vector cv.
template <typename T, int V, int U>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, T* __restrict__ out,
                                           long long rows, int cvecs, int cv, long long r0,
                                           long long step, const Channels<V>& k) {
  const Vec<T, V>* px = reinterpret_cast<const Vec<T, V>*>(x) + cv;
  Vec<T, V>* po = reinterpret_cast<Vec<T, V>*>(out) + cv;
  for (long long r = r0; r < rows; r += U * step) {
    Vec<T, V> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) v[u] = px[(r + u * step) * cvecs];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
        Vec<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float z = pre_relu(widen(v[u].v[j]), k.mean[j], k.invstd[j], k.w[j], k.b[j]);
          store_as(o.v[j], relu_of(z));
        }
        po[(r + u * step) * cvecs] = o;
      }
    }
  }
}

// Train: mean and invstd the batch's.  Eval (kEval): mean the running mean,
// invstd = rsqrt(running_var + eps).
template <typename T, int V, bool kEval>
__global__ void __launch_bounds__(kApplyThreads) batch_norm_relu_apply_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long rows, int C, int tile,
    const float* __restrict__ mean, const float* __restrict__ stat, const float* __restrict__ w,
    const float* __restrict__ b, float eps) {
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kApplyThreads, blockIdx.x);
  if (!L.active) return;
  Channels<V> k;
  load_channels<V>(k, L.cv * V, mean, stat, w, b);
  if (kEval) {
#pragma unroll
    for (int j = 0; j < V; ++j) k.invstd[j] = rsqrtf(__fadd_rn(k.invstd[j], eps));
  }
  apply_rows<T, V, kApplyUnroll>(x, out, rows, cvecs, L.cv, (long long)blockIdx.y * L.R + L.ty,
                   (long long)gridDim.y * L.R, k);
}

// ---- backward -------------------------------------------------------------

// One thread's sums of dz and dz * (x - mean) over its rows, dz = dr where
// T(z) > 0, else 0.
template <typename T, int V, int U>
__device__ __forceinline__ void thread_sums(const T* __restrict__ dr, const T* __restrict__ x,
                                            long long rows, int cvecs, int cv, long long r0,
                                            long long step, const Channels<V>& k,
                                            float (&s1)[V], float (&s2)[V]) {
  const Vec<T, V>* pg = reinterpret_cast<const Vec<T, V>*>(dr) + cv;
  const Vec<T, V>* px = reinterpret_cast<const Vec<T, V>*>(x) + cv;
  for (long long r = r0; r < rows; r += U * step) {
    Vec<T, V> g[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
        g[u] = pg[(r + u * step) * cvecs];
        v[u] = px[(r + u * step) * cvecs];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = widen(v[u].v[j]);
          const float z = pre_relu(xv, k.mean[j], k.invstd[j], k.w[j], k.b[j]);
          const float dz = passes<T>(z) ? widen(g[u].v[j]) : 0.f;
          s1[j] = __fadd_rn(s1[j], dz);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(dz, __fsub_rn(xv, k.mean[j])));
        }
      }
    }
  }
}

// The block's sums down its R rows of threads (a tree over ty): thread
// ty == 0 of each column ends with the block's.  Shared: [V * kStage] each.
template <int V>
__device__ __forceinline__ void block_sums(const Layout& L, float (&s1)[V], float (&s2)[V],
                                           float* a1, float* a2) {
  for (int half = L.R / 2; half > 0; half /= 2) {
    const int slot = (L.ty - half) * L.tile + L.tx;
    if (L.ty >= half && L.ty < 2 * half) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a1[j * kStage + slot] = s1[j];
        a2[j * kStage + slot] = s2[j];
      }
    }
    __syncthreads();
    if (L.ty < half) {
      const int from = L.ty * L.tile + L.tx;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] = __fadd_rn(s1[j], a1[j * kStage + from]);
        s2[j] = __fadd_rn(s2[j], a2[j * kStage + from]);
      }
    }
    __syncthreads();
  }
}

struct Grads {
  const float* mean;
  const float* invstd;
  const float* w;
  float* grad_w;  // (C,) sum dz * (x - mean) * invstd
  float* grad_b;  // (C,) sum dz
  float* coef;    // (3, C): mean(dz), invstd^2 * mean(dz * (x - mean)), w * invstd
};

// Channel c's gradients and elementwise coefficients from its sums over
// rows, in the order of torch's batch_norm_backward_elemt: grad_w, grad_b,
// then q[3]: mean(dz), invstd^2 * mean(dz * (x - mean)), w * invstd.
__device__ __forceinline__ void channel_grads(const Grads& g, int c, long long rows, float s1,
                                              float s2, float& gw, float& gb, float (&q)[3]) {
  const float inv = g.invstd[c];
  const float norm = __frcp_rn((float)rows);
  gb = s1;
  gw = __fmul_rn(s2, inv);
  q[0] = __fmul_rn(s1, norm);
  q[1] = __fmul_rn(__fmul_rn(__fmul_rn(inv, inv), s2), norm);
  q[2] = __fmul_rn(g.w[c], inv);
}

// The last block sums the (nparts, C) partial rows of both sums in a fixed
// order (P threads a channel, then the P sums in order) and finishes them.
__device__ void finish_sums(const float* part1, const float* part2, int nparts, int C,
                            long long rows, const Grads& g, int slot, float* a1, float* a2) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    last = atomicAdd(&g_tickets[slot], 1u) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int base = 0; base < C; base += kThreads) {
    const int w = min(C - base, kThreads);
    const int P = kThreads / w;
    const int c = threadIdx.x % w, p = threadIdx.x / w;
    float t1 = 0.f, t2 = 0.f;
    if (p < P) {
      for (int b0 = p; b0 < nparts; b0 += kPartBatch * P) {
        float v1[kPartBatch], v2[kPartBatch];
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) {
          const int b = b0 + u * P;
          v1[u] = b < nparts ? __ldcg(part1 + (size_t)b * C + base + c) : 0.f;
          v2[u] = b < nparts ? __ldcg(part2 + (size_t)b * C + base + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) {
          t1 = __fadd_rn(t1, v1[u]);
          t2 = __fadd_rn(t2, v2[u]);
        }
      }
    }
    a1[threadIdx.x] = t1;
    a2[threadIdx.x] = t2;
    __syncthreads();
    if (threadIdx.x < w) {
      for (int q = 1; q < P; ++q) {
        t1 = __fadd_rn(t1, a1[q * w + threadIdx.x]);
        t2 = __fadd_rn(t2, a2[q * w + threadIdx.x]);
      }
      const int ch = base + threadIdx.x;
      float q[3];
      channel_grads(g, ch, rows, t1, t2, g.grad_w[ch], g.grad_b[ch], q);
#pragma unroll
      for (int i = 0; i < 3; ++i) g.coef[i * C + ch] = q[i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) g_tickets[slot] = 0;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1) batch_norm_relu_grad_sums_kernel(
    const T* __restrict__ dr, const T* __restrict__ x, long long rows, int C, int tile,
    const float* __restrict__ b, float* __restrict__ part1, float* __restrict__ part2, Grads g,
    int slot) {
  __shared__ float a1[V * kStage];
  __shared__ float a2[V * kStage];
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kThreads, blockIdx.x);
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  if (L.active) {
    Channels<V> k;
    load_channels<V>(k, L.cv * V, g.mean, g.invstd, g.w, b);
    thread_sums<T, V, kSumUnroll>(dr, x, rows, cvecs, L.cv, (long long)blockIdx.y * L.R + L.ty,
                      (long long)gridDim.y * L.R, k, s1, s2);
  }
  block_sums<V>(L, s1, s2, a1, a2);
  if (L.ty == 0 && L.cv < cvecs) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part1[(size_t)blockIdx.y * C + L.cv * V + j] = s1[j];
      part2[(size_t)blockIdx.y * C + L.cv * V + j] = s2[j];
    }
  }
  finish_sums(part1, part2, gridDim.y, C, rows, g, slot, a1, a2);
}

// dx over rows r0, r0 + step, ... of column vector cv; q: the thread's
// coefficients (mean(dz), f1, f2 for each channel).
template <typename T, int V, int U>
__device__ __forceinline__ void grad_rows(const T* __restrict__ dr, const T* __restrict__ x,
                                          T* __restrict__ dx, long long rows, int cvecs, int cv,
                                          long long r0, long long step, const Channels<V>& k,
                                          const float (&q)[3][V]) {
  const Vec<T, V>* pg = reinterpret_cast<const Vec<T, V>*>(dr) + cv;
  const Vec<T, V>* px = reinterpret_cast<const Vec<T, V>*>(x) + cv;
  Vec<T, V>* po = reinterpret_cast<Vec<T, V>*>(dx) + cv;
  for (long long r = r0; r < rows; r += U * step) {
    Vec<T, V> g[U], v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
        g[u] = pg[(r + u * step) * cvecs];
        v[u] = px[(r + u * step) * cvecs];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step < rows) {
        Vec<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = widen(v[u].v[j]);
          const float z = pre_relu(xv, k.mean[j], k.invstd[j], k.w[j], k.b[j]);
          const float dz = passes<T>(z) ? widen(g[u].v[j]) : 0.f;
          const float xmu = __fsub_rn(xv, k.mean[j]);
          store_as(o.v[j], __fmul_rn(__fsub_rn(__fsub_rn(dz, q[0][j]), __fmul_rn(xmu, q[1][j])),
                                     q[2][j]));
        }
        po[(r + u * step) * cvecs] = o;
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads) batch_norm_relu_grad_input_kernel(
    const T* __restrict__ dr, const T* __restrict__ x, T* __restrict__ dx, long long rows, int C,
    int tile, const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ w, const float* __restrict__ b, const float* __restrict__ coef) {
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kApplyThreads, blockIdx.x);
  if (!L.active) return;
  Channels<V> k;
  load_channels<V>(k, L.cv * V, mean, invstd, w, b);
  float q[3][V];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) q[i][j] = coef[i * C + L.cv * V + j];
  }
  grad_rows<T, V, kApplyUnroll>(dr, x, dx, rows, cvecs, L.cv, (long long)blockIdx.y * L.R + L.ty,
                  (long long)gridDim.y * L.R, k, q);
}

// ---- one cluster ----------------------------------------------------------

// Forward of a small norm (one tile, C <= kStage): each of the kCluster
// blocks takes rows rank*R + ty, stepping by kCluster * R; every block
// merges the blocks' statistics in rank order from their shared memory,
// rank 0 writes them out, and each block applies them to its rows.
template <typename T, int V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    batch_norm_relu_cluster_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows,
                                   int C, int tile, const float* __restrict__ w,
                                   const float* __restrict__ b, Stats s) {
  __shared__ int s_n[kStage];
  __shared__ float s_mean[V * kStage];
  __shared__ float s_m2[V * kStage];
  __shared__ int blk_n;
  __shared__ float blk_mean[kStage], blk_m2[kStage];
  // the final statistics, in the merge's staging (free after block_merge;
  // only blk_* are read by the other blocks)
  float* fin_mean = s_mean;
  float* fin_inv = s_m2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kThreads, 0);
  int n = 0;
  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  if (L.active) {
    thread_stats<T, V, kSumUnroll>(x, rows, cvecs, L.cv, (long long)rank * L.R + L.ty,
                       (long long)kCluster * L.R, n, mean, m2);
  }
  block_merge<V>(L, n, mean, m2, s_n, s_mean, s_m2);
  if (L.ty == 0 && L.cv < cvecs) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      blk_mean[L.cv * V + j] = mean[j];
      blk_m2[L.cv * V + j] = m2[j];
    }
    if (L.tx == 0) blk_n = n;
  }
  cluster.sync();
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    int nc = 0;
    float mc[1] = {0.f}, qc[1] = {0.f};
    for (int r = 0; r < kCluster; ++r) {
      const float mb = cluster.map_shared_rank(blk_mean, r)[c];
      const float qb = cluster.map_shared_rank(blk_m2, r)[c];
      chan_merge<1>(nc, mc, qc, *cluster.map_shared_rank(&blk_n, r), &mb, &qb, 0);
    }
    const float var = __fdiv_rn(qc[0], (float)nc);
    fin_mean[c] = mc[0];
    fin_inv[c] = rsqrtf(__fadd_rn(var, s.eps));
    if (rank == 0) finish_channel(s, c, nc, mc[0], qc[0]);
  }
  if (rank == 0 && threadIdx.x == 0 && s.batches != nullptr) *s.batches += 1;
  cluster.sync();  // every block has read the others' shared memory
  if (!L.active) return;
  Channels<V> k;
  load_channels<V>(k, L.cv * V, fin_mean, fin_inv, w, b);
  apply_rows<T, V, kApplyUnroll>(x, out, rows, cvecs, L.cv, (long long)rank * L.R + L.ty,
                   (long long)kCluster * L.R, k);
}

// Backward of a small norm: the sums over the cluster, summed in rank order
// by every block; rank 0 writes the gradients; each block then writes dx
// for its rows.
template <typename T, int V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    batch_norm_relu_grad_cluster_kernel(const T* __restrict__ dr, const T* __restrict__ x,
                                        T* __restrict__ dx, long long rows, int C, int tile,
                                        const float* __restrict__ b, Grads g) {
  __shared__ float a1[V * kStage];
  __shared__ float a2[V * kStage];
  __shared__ float blk1[kStage], blk2[kStage];
  __shared__ float q_sm[3 * kStage];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cvecs = C / V;
  const Layout L(tile, cvecs, kThreads, 0);
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  Channels<V> k;
  if (L.active) {
    load_channels<V>(k, L.cv * V, g.mean, g.invstd, g.w, b);
    thread_sums<T, V, kSumUnroll>(dr, x, rows, cvecs, L.cv, (long long)rank * L.R + L.ty,
                      (long long)kCluster * L.R, k, s1, s2);
  }
  block_sums<V>(L, s1, s2, a1, a2);
  if (L.ty == 0 && L.cv < cvecs) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      blk1[L.cv * V + j] = s1[j];
      blk2[L.cv * V + j] = s2[j];
    }
  }
  cluster.sync();
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < kCluster; ++r) {
      t1 = __fadd_rn(t1, cluster.map_shared_rank(blk1, r)[c]);
      t2 = __fadd_rn(t2, cluster.map_shared_rank(blk2, r)[c]);
    }
    float gw, gb, q[3];
    channel_grads(g, c, rows, t1, t2, gw, gb, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) q_sm[i * kStage + c] = q[i];
    if (rank == 0) {
      g.grad_w[c] = gw;
      g.grad_b[c] = gb;
    }
  }
  cluster.sync();  // every block has read the others' shared memory
  if (!L.active) return;
  float q[3][V];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) q[i][j] = q_sm[i * kStage + L.cv * V + j];
  }
  grad_rows<T, V, kApplyUnroll>(dr, x, dx, rows, cvecs, L.cv, (long long)rank * L.R + L.ty,
                  (long long)kCluster * L.R, k, q);
}

// ---- launches -------------------------------------------------------------

// Vector widths: the statistics and the apply read 16-byte vectors (twice
// the bytes in flight of 8-byte ones; on the H100, 10.4 against 10.9 ms of
// forward a train step); the sums (and the clusters) 8-byte ones, which
// keeps a thread's per-channel constants, sums and loads in flight in
// registers; the gradient's elementwise pass, with three more constants a
// channel, 8-byte ones.
template <typename T>
constexpr int kNarrow = 8 / sizeof(T);
template <typename T>
constexpr int kWide = 16 / sizeof(T);

// A grid over C / V column vectors: tiles of at most `threads`, and row
// blocks (the sums' `blocks`, or 4x as many for an elementwise pass).
struct Grid {
  int tile, tiles, blocks;
  Grid(int C, int V, int threads, int row_blocks) {
    tile = std::min(C / V, threads);
    tiles = (C / V + tile - 1) / tile;
    blocks = std::max(1, row_blocks / tiles);
  }
};

template <typename T>
int forward_by_type(const void* x, void* out, const float* w, const float* b, Stats s,
                    long long rows, int C, int blocks, int cluster, void* partial, int slot,
                    cudaStream_t stream) {
  constexpr int V = kNarrow<T>;
  if (cluster) {
    if (C > kStage) return (int)cudaErrorInvalidValue;
    batch_norm_relu_cluster_kernel<T, V><<<kCluster, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, C, C / V, w, b, s);
    return 0;
  }
  // blocks row blocks over each tile of W-wide column vectors
  constexpr int W = kWide<T>;
  const Grid g(C, W, kThreads, blocks * ((C / W + kThreads - 1) / kThreads));
  float* part_mean = static_cast<float*>(partial);
  float* part_m2 = part_mean + (size_t)g.blocks * C;
  int* part_n = reinterpret_cast<int*>(part_m2 + (size_t)g.blocks * C);
  batch_norm_relu_stats_kernel<T, W><<<dim3(g.tiles, g.blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, C, g.tile, part_mean, part_m2, part_n, s, slot);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const Grid a(C, kWide<T>, kApplyThreads, 4 * blocks);
  batch_norm_relu_apply_kernel<T, kWide<T>, false>
      <<<dim3(a.tiles, a.blocks), kApplyThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), rows, C, a.tile, s.mean, s.invstd, w,
          b, s.eps);
  return 0;
}

template <typename T>
int eval_by_type(const void* x, void* out, const float* w, const float* b,
                 const float* running_mean, const float* running_var, float eps,
                 long long rows, int C, int blocks, cudaStream_t stream) {
  const Grid a(C, kWide<T>, kApplyThreads, 4 * blocks);
  batch_norm_relu_apply_kernel<T, kWide<T>, true>
      <<<dim3(a.tiles, a.blocks), kApplyThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), rows, C, a.tile, running_mean,
          running_var, w, b, eps);
  return 0;
}

template <typename T>
int backward_by_type(const void* dr, const void* x, void* dx, const float* b, Grads g,
                     long long rows, int C, int blocks, int cluster, void* partial, int slot,
                     cudaStream_t stream) {
  constexpr int V = kNarrow<T>;
  if (cluster) {
    if (C > kStage) return (int)cudaErrorInvalidValue;
    batch_norm_relu_grad_cluster_kernel<T, V><<<kCluster, kThreads, 0, stream>>>(
        static_cast<const T*>(dr), static_cast<const T*>(x), static_cast<T*>(dx), rows, C,
        C / V, b, g);
    return 0;
  }
  const Grid q(C, V, kThreads, blocks * ((C / V + kThreads - 1) / kThreads));
  float* part1 = static_cast<float*>(partial);
  float* part2 = part1 + (size_t)q.blocks * C;
  batch_norm_relu_grad_sums_kernel<T, V><<<dim3(q.tiles, q.blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(dr), static_cast<const T*>(x), rows, C, q.tile, b, part1, part2, g,
      slot);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const Grid a(C, V, kApplyThreads, 4 * blocks);
  batch_norm_relu_grad_input_kernel<T, V><<<dim3(a.tiles, a.blocks), kApplyThreads, 0,
                                             stream>>>(
      static_cast<const T*>(dr), static_cast<const T*>(x), static_cast<T*>(dx), rows, C,
      a.tile, g.mean, g.invstd, g.w, b, g.coef);
  return 0;
}

bool bad_shape(long long rows, int C, int dtype, int blocks, int slot) {
  return rows <= 0 || rows > INT32_MAX || C <= 0 || C % 8 != 0 || blocks <= 0 || slot < 0 ||
         slot >= kTicketSlots || (dtype != 0 && dtype != 1);
}

}  // namespace

// x, out: (rows, C) dense, channels-last, dtype 0 bf16 or 1 float, C % 8 ==
// 0; w, b, mean, invstd (C,) float; running_mean, running_var (C,) float and
// batches (one int64), or all three null.  blocks: the statistics' row
// blocks for each tile of up to 512 8-byte column vectors (the apply takes
// 4x as many over its own tiles: Grid); cluster: one cluster of 8 blocks
// instead (C <= 256; partial and slot unused).  partial: 2 * blocks * C
// floats and blocks ints.  slot < 64 names the ticket.
extern "C" int bn_relu_forward_launch(const void* x, void* out, const float* w, const float* b,
                                      float* mean, float* invstd, float* running_mean,
                                      float* running_var, long long* batches, float momentum,
                                      float eps, float bessel, long long rows, int C, int dtype,
                                      int blocks, int cluster, void* partial, int slot,
                                      cudaStream_t stream) {
  if (bad_shape(rows, C, dtype, blocks, slot)) return (int)cudaErrorInvalidValue;
  const Stats s{mean, invstd, running_mean, running_var, batches, momentum, eps, bessel};
  const int err = dtype == 0
      ? forward_by_type<__nv_bfloat16>(x, out, w, b, s, rows, C, blocks, cluster, partial,
                                       slot, stream)
      : forward_by_type<float>(x, out, w, b, s, rows, C, blocks, cluster, partial, slot,
                               stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The eval forward: x, out as above; running_mean, running_var (C,) float.
// blocks: what the statistics of such a norm would take (the pass takes 4x
// as many over its tiles).
extern "C" int bn_relu_eval_launch(const void* x, void* out, const float* w, const float* b,
                                   const float* running_mean, const float* running_var,
                                   float eps, long long rows, int C, int dtype, int blocks,
                                   cudaStream_t stream) {
  if (bad_shape(rows, C, dtype, blocks, 0)) return (int)cudaErrorInvalidValue;
  const int err = dtype == 0
      ? eval_by_type<__nv_bfloat16>(x, out, w, b, running_mean, running_var, eps, rows, C,
                                    blocks, stream)
      : eval_by_type<float>(x, out, w, b, running_mean, running_var, eps, rows, C, blocks,
                            stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The backward: dr (the gradient of r), x, dx (rows, C) as above; w, b,
// mean, invstd (C,) float (the forward's saved statistics); grad_w,
// grad_b (C,) float; coef 3 * C floats; partial 2 * blocks * C floats;
// blocks, cluster, slot as for the forward.
extern "C" int bn_relu_backward_launch(const void* dr, const void* x, void* dx, const float* w,
                                       const float* b, const float* mean, const float* invstd,
                                       float* grad_w, float* grad_b, float* coef,
                                       long long rows, int C, int dtype, int blocks, int cluster,
                                       void* partial, int slot, cudaStream_t stream) {
  if (bad_shape(rows, C, dtype, blocks, slot)) return (int)cudaErrorInvalidValue;
  const Grads g{mean, invstd, w, grad_w, grad_b, coef};
  const int err = dtype == 0
      ? backward_by_type<__nv_bfloat16>(dr, x, dx, b, g, rows, C, blocks, cluster, partial,
                                        slot, stream)
      : backward_by_type<float>(dr, x, dx, b, g, rows, C, blocks, cluster, partial, slot,
                                stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
