// Shared device helpers for the scso_tpu_torch kernels.
//
// Every reduction here runs in a fixed order, so a kernel built on them
// gives bitwise-identical results from run to run: no float atomics
// anywhere. The greedy accept test of the solver compares two objective
// values that are each a long sum, and reacts to their last bits.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace scso {

// xor-butterfly warp sum. Each step adds the same two values on both
// lanes of a pair (a + b == b + a exactly), so every lane ends with the
// same bits. Requires a full warp.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum, returned to every thread. ``red`` is a shared buffer of
// at least 32 entries; blockDim.x must be a multiple of 32. Safe to call
// repeatedly with the same buffer.
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // a previous call may still be reading red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int k = 0; k < nw; ++k) s += red[k];
  return s;
}

// xor-butterfly warp max (every lane ends with the same value).
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum / max over aligned groups of G lanes (G a power of two <= 32);
// every lane of a group ends with the same bits. Requires a full warp.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int G, typename T>
__device__ __forceinline__ T group_max(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Warp reduce-scatter of N values (N a power of two): each halving step
// swaps half of the live values with the partner lane and adds, so a
// warp sums N values with N - 1 shuffles instead of 5·N. Afterwards
// lane l holds in v[0..max(N/32, 1)) the warp sums of the values with
// index rs_index<N>(l, e); for N < 32 the lanes of each aligned group
// of 32/N hold the same bits. Every sum is taken in a fixed order.
template <int LIVE, int O>
struct ReduceScatter {
  template <typename T, int N>
  static __device__ __forceinline__ void run(T (&v)[N], int lane) {
    if constexpr (LIVE >= 2) {
      constexpr int H = LIVE / 2;
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const T send = hi ? v[i] : v[i + H];
        const T keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if constexpr (O > 1) ReduceScatter<H, O / 2>::run(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      if constexpr (O > 1) ReduceScatter<1, O / 2>::run(v, lane);
    }
  }
};

template <int N, typename T>
__device__ __forceinline__ void warp_reduce_scatter(T (&v)[N], int lane) {
  static_assert(N > 0 && (N & (N - 1)) == 0, "N must be a power of two");
  ReduceScatter<N, 16>::run(v, lane);
}

// Index held in v[e] by ``lane`` after warp_reduce_scatter<N>.
template <int N>
__device__ __forceinline__ int rs_index(int lane, int e) {
  if constexpr (N >= 32) return lane * (N / 32) + e;
  else return lane / (32 / N);
}

// out[j] = Σ_b partials[b·n + j] in double, b in order: the fixed-order
// cross-block sum that keeps a kernel's result bitwise reproducible.
template <typename T>
__global__ void sum_partials(const T* __restrict__ partials,
                             T* __restrict__ out, int64_t n, int64_t nblk) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  double s = 0.0;
  for (int64_t b = 0; b < nblk; ++b) s += static_cast<double>(partials[b * n + j]);
  out[j] = static_cast<T>(s);
}

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }
__device__ __forceinline__ float dlog1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dlog1p(double v) { return log1p(v); }

// bfloat16 bits → float, exactly (what __bfloat162float computes): the
// low and the high half of a 32-bit word of two packed values
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// A value of A (stored in T, or in bfloat16) in the compute type T: a
// bfloat16 value upcast exactly
template <typename T, typename S>
__device__ __forceinline__ T upcast(S v) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return static_cast<T>(__bfloat162float(v));
  } else {
    return static_cast<T>(v);
  }
}

// A 16-byte vector of T (VEC: float4 / double2) or T itself, with the
// ops the kernels need. VEC requires 16-byte aligned rows (n % E == 0).
template <typename T, bool VEC> struct Chunk;
template <typename T> struct Chunk<T, false> {
  using type = T;
  static constexpr int E = 1;
  static __device__ __forceinline__ T dot(T a, T b) { return a * b; }
  static __device__ __forceinline__ void axpy(T& acc, T u, T a) { acc += u * a; }
};
template <> struct Chunk<float, true> {
  using type = float4;
  static constexpr int E = 4;
  static __device__ __forceinline__ float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  static __device__ __forceinline__ void axpy(float4& acc, float u, float4 a) {
    acc.x += u * a.x; acc.y += u * a.y; acc.z += u * a.z; acc.w += u * a.w;
  }
};
template <> struct Chunk<double, true> {
  using type = double2;
  static constexpr int E = 2;
  static __device__ __forceinline__ double dot(double2 a, double2 b) {
    return a.x * b.x + a.y * b.y;
  }
  static __device__ __forceinline__ void axpy(double2& acc, double u, double2 a) {
    acc.x += u * a.x; acc.y += u * a.y;
  }
};

// The most blocks of a cluster (the H100's non-portable limit).
constexpr int kMaxCluster = 16;

// A cluster barrier split in two: a block may write another's shared
// memory only once that block has started, so a cluster kernel arrives
// (relaxed: it orders no memory) as it starts and waits, with every
// thread, just before its first store into another block; the work
// between hides the barrier's latency.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Sums of W values over a thread-block cluster, returned in ``v`` to
// every thread of every block with the same bits:
//   * each warp sums its lanes (warp_sum) into ``red`` (W·32 doubles);
//     after a block barrier warp 0 adds those in warp order: the block's
//     partials;
//   * lane r of warp 0 stores them into block r's ``inbox`` (W·16
//     doubles), at this block's rank, through distributed shared memory:
//     one store a block and value, where reading them remotely would
//     take one load a reading warp;
//   * after cluster.sync() every thread adds the partials in its own
//     inbox in rank order 0, 1, ….
// A call writes every block's inbox, so the next call must take another
// one (two, used in turns, suffice: a block writes an inbox again only
// after every block has passed the barrier of the call between, that
// is, has read it); ``red`` is free again after the cluster barrier.
// No block reads another's shared memory, so a block may leave right
// after; before the first call every block must have passed
// cluster_wait(). With one block the sums are block_sum's order.
template <int W>
__device__ __forceinline__ void cluster_reduce(
    cooperative_groups::cluster_group& cl, double (&v)[W], double* red,
    double* inbox) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned nw = blockDim.x >> 5, nb = cl.num_blocks();
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = warp_sum(v[w]);
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) red[w * 32 + warp] = v[w];
  }
  __syncthreads();
  if (warp == 0) {
    double b[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      b[w] = red[w * 32];
      for (unsigned k = 1; k < nw; ++k) b[w] += red[w * 32 + k];
    }
    if (lane < nb) {
      double* dst = cl.map_shared_rank(inbox, lane) + cl.block_rank() * W;
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = b[w];
    }
  }
  cl.sync();
#pragma unroll
  for (int w = 0; w < W; ++w) {
    v[w] = inbox[w];
    for (unsigned r = 1; r < nb; ++r) v[w] += inbox[r * W + w];
  }
}

// Launch config of one cluster of ``blocks`` blocks (the whole grid).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(unsigned blocks, unsigned threads, size_t smem,
                cudaStream_t stream)
      : cfg(), attr() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of ``blocks`` blocks of ``kernel`` the card can hold
// at once (0: such a cluster cannot be launched).
template <typename K>
inline cudaError_t clusters_that_fit(K kernel, unsigned blocks,
                                     unsigned threads, size_t smem,
                                     int* count) {
  ClusterLaunch l(blocks, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(count, kernel, &l.cfg);
}

// Allow ``bytes`` of dynamic shared memory for a kernel. Without the
// opt-in a block may hold 48 KB in all, its static shared memory
// included (at most 8 KB in every kernel here): from 40 KB of dynamic
// shared memory on, the attribute is set.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 8 * 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Let a cluster kernel run clusters of up to 16 blocks (8 is the
// portable limit) and take ``smem`` bytes of dynamic shared memory.
template <typename K>
inline cudaError_t allow_cluster(K kernel, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e != cudaSuccess ? e : allow_smem(kernel, smem);
}

}  // namespace scso
