// Shared device helpers for the scso_tpu_torch kernels.
//
// Every reduction here runs in a fixed order, so a kernel built on them
// gives bitwise-identical results from run to run: no float atomics
// anywhere. The greedy accept test of the solver compares two objective
// values that are each a long sum, and reacts to their last bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }
__device__ __forceinline__ float dlog1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dlog1p(double v) { return log1p(v); }

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

// Allow more than 48 KB of dynamic shared memory for a kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace scso
