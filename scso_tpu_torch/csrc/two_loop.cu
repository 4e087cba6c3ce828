// K4: the L-BFGS two-loop recursion, d = −H·g.
//
// Replaces the TPU kernel scso_tpu/ops/pallas/two_loop.py:69
// (_two_loop_pallas). Over the circular (s, y) memory S, Y (m × n) with
// the next write slot ``pos`` and ``count`` valid pairs:
//   first loop, k = 0 … count−1 (newest → oldest), slot (pos−1−k) mod m:
//     ρ_k = 1/(yᵀs), or 0 where yᵀs = 0;  α_k = ρ_k·(sᵀq);  q −= α_k·y
//   r = H0·q
//   second loop, k = count−1 … 0 (oldest → newest):
//     β = ρ_k·(yᵀr);  r += (α_k − β)·s
//   d = −r
// Slots k ≥ count are skipped outright, so q and r keep their bits (a
// stale y in an empty slot is never read). pos, count and H0 are read
// from device memory, as the TPU kernel reads them from SMEM, so the
// caller never waits for the device.
//
// What bounds it on the H100: latency. At the L-BFGS path's shape (m =
// 10, n = 10112, f32) S and Y are 0.81 MB and stay in L2; the recursion
// is 2m dependent steps, each a dot product over n followed by an axpy
// that needs its result. So one block of 1024 threads loops over n (as
// K3 does), with one launch and 2m block reductions: the first loop
// reduces yᵀs and sᵀq together, the second yᵀr, each in double and in
// a fixed order (common.cuh), so two runs give the same bits and no
// float atomics are needed. Thread t owns elements t, t + 1024, … of q
// and r: each axpy touches only the thread's own elements, so q and r
// live in the output buffer with no barrier between an axpy and the next
// dot. α and ρ (2·m values) stay in dynamic shared memory sized by m,
// the kernel's own storage (the TPU kernel's SMEM scratch), up to the
// wrapper's 32 KB budget (m ≤ 4096 in f32, 2048 in f64), well inside
// the 48 KB a launch gets without opting in; past that the wrapper passes a device scratch of 2·m values for them,
// so any memory size runs. Thread 0 writes each pair and the barrier of
// the next reduction orders the reads, in shared or device memory
// alike. Arithmetic outside the reductions is in T.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// Two block-wide sums with one pair of barriers; ``red`` holds 64.
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* red) {
  a = scso::warp_sum(a);
  b = scso::warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // a previous call may still be reading red
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  double sa = 0.0, sb = 0.0;
  for (int k = 0; k < nw; ++k) {
    sa += red[k];
    sb += red[32 + k];
  }
  a = sa;
  b = sb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
two_loop(const T* __restrict__ S, const T* __restrict__ Y,
         const T* __restrict__ g, const int* __restrict__ pos_p,
         const int* __restrict__ count_p, const T* __restrict__ h0_p,
         T* scratch, T* __restrict__ out, int64_t m, int64_t n) {
  __shared__ double red[64];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // α then ρ, one slot each per memory pair
  T* alpha_s = scratch != nullptr ? scratch : reinterpret_cast<T*>(smem_raw);
  T* rho_s = alpha_s + m;
  const int64_t pos = *pos_p;
  int64_t count = *count_p;
  count = count < 0 ? 0 : (count > m ? m : count);
  const T h0 = *h0_p;

  for (int64_t i = threadIdx.x; i < n; i += kThreads) out[i] = g[i];  // q

  for (int64_t k = 0; k < count; ++k) {
    const int64_t idx = ((pos - 1 - k) % m + m) % m;
    const T* s = S + idx * n;
    const T* y = Y + idx * n;
    double ys = 0.0, sq = 0.0;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const double si = static_cast<double>(s[i]);
      ys += static_cast<double>(y[i]) * si;
      sq += si * static_cast<double>(out[i]);
    }
    block_sum2(ys, sq, red);
    const T ysT = static_cast<T>(ys);
    const T rho = ysT != T(0) ? T(1) / ysT : T(0);
    const T alpha = rho * static_cast<T>(sq);
    if (threadIdx.x == 0) {
      alpha_s[k] = alpha;
      rho_s[k] = rho;
    }
    for (int64_t i = threadIdx.x; i < n; i += kThreads)
      out[i] = out[i] - alpha * y[i];
  }

  for (int64_t i = threadIdx.x; i < n; i += kThreads) out[i] = h0 * out[i];

  for (int64_t k = count - 1; k >= 0; --k) {
    const int64_t idx = ((pos - 1 - k) % m + m) % m;
    const T* s = S + idx * n;
    const T* y = Y + idx * n;
    double yr = 0.0, unused = 0.0;
    for (int64_t i = threadIdx.x; i < n; i += kThreads)
      yr += static_cast<double>(y[i]) * static_cast<double>(out[i]);
    block_sum2(yr, unused, red);  // also orders alpha_s / rho_s reads
    const T coef = alpha_s[k] - rho_s[k] * static_cast<T>(yr);
    for (int64_t i = threadIdx.x; i < n; i += kThreads)
      out[i] = out[i] + s[i] * coef;
  }

  for (int64_t i = threadIdx.x; i < n; i += kThreads) out[i] = -out[i];
}

template <typename T>
int launch(const void* S, const void* Y, const void* g, const void* pos,
           const void* count, const void* h0, void* scratch, void* out,
           int64_t m, int64_t n, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch != nullptr ? 0 : 2 * m * sizeof(T);
  if (smem > 32 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  two_loop<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(S), static_cast<const T*>(Y),
      static_cast<const T*>(g), static_cast<const int*>(pos),
      static_cast<const int*>(count), static_cast<const T*>(h0),
      static_cast<T*>(scratch), static_cast<T*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SCSO_TWO_LOOP_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* S, const void* Y, const void* g,        \
                      const void* pos, const void* count, const void* h0, \
                      void* scratch, void* out, int64_t m, int64_t n,     \
                      void* stream) {                                     \
    return launch<T>(S, Y, g, pos, count, h0, scratch, out, m, n,         \
                     stream);                                             \
  }

SCSO_TWO_LOOP_ENTRY(scso_two_loop_f32, float)
SCSO_TWO_LOOP_ENTRY(scso_two_loop_f64, double)
