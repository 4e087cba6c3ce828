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
// 10, n = 10112, f32) S and Y are 0.81 MB; the recursion is 2m dependent
// steps, each a dot product over n followed by an axpy that needs its
// result, so the time is 2m times the latency of one step: a reduction
// across the block and a barrier. Design: ONE launch of one thread-block
// cluster of up to 16 blocks of 256 threads (the wrapper's
// ``two_loop_plan``), block b owning a contiguous slice of n:
//   * where the slice fits (the plan's ``resident``), each block first
//     loads its slice of the ``count`` valid S and Y slots into dynamic
//     shared memory, all at once, so the dependent steps never wait on
//     L2; else every step streams the slice from global memory;
//   * q and r stay in the block for the whole recursion, in shared
//     memory (else in the block's slice of the output). Thread t owns
//     elements t, t + 256, … of the slice in every array, so the loads,
//     the axpys and the dots touch only the thread's own elements and
//     need no barrier between them;
//   * each dot product: the block's double partial (a fixed-order block
//     reduction) is pushed by one warp into every block's shared memory
//     through distributed shared memory, one cluster.sync(), then every
//     block adds the partials in rank order from its own shared memory
//     (common.cuh, cluster_reduce), so ρ, α and β have the same bits in
//     every block, and applies the axpy to its own slice. Two inboxes,
//     used in turns, make one cluster.sync() a step enough. Reading the
//     partials remotely instead (one load a reading warp) cost 3.7 µs a
//     step with 16 warps a block and 7.5 µs with a slot a warp, on the
//     H100 (PERF.md §6): the remote reads, not the barrier, were the
//     step's time. The barriers also order the α and ρ that thread 0
//     writes.
// Sums are in double and in a fixed order with no float atomics, so
// reruns are bitwise equal; arithmetic outside the reductions is in T.
// α and ρ (2·m values, the same in every block) sit in each block's
// shared memory up to the wrapper's SMEM_BYTES, past it in block b's 2·m
// values of a device scratch from the wrapper, so any memory size runs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// the most dynamic shared memory a launch takes (the wrapper's
// RESIDENT_BYTES); the H100 gives a block up to 227 KB
constexpr size_t kSmemMax = 200 * 1024;
// the plan's flags
constexpr int64_t kAlphaInSmem = 1, kQInSmem = 2, kResident = 4;

__device__ __forceinline__ int64_t slot_of(int64_t pos, int64_t k,
                                           int64_t m) {
  return ((pos - 1 - k) % m + m) % m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
two_loop_cluster(const T* __restrict__ S, const T* __restrict__ Y,
                 const T* __restrict__ g, const int* __restrict__ pos_p,
                 const int* __restrict__ count_p,
                 const T* __restrict__ h0_p, T* scratch, T* out, int64_t m,
                 int64_t n, int64_t chunk, int64_t flags) {
  __shared__ double red[2 * 32];
  // the blocks' partials by rank, [turn][rank · partials + partial]
  __shared__ double inbox[2][2 * scso::kMaxCluster];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cooperative_groups::cluster_group cl =
      cooperative_groups::this_cluster();
  scso::cluster_arrive_relaxed();
  const int64_t rank = cl.block_rank();
  const int64_t i0 = rank * chunk;
  const int64_t len = scso::imax(0, scso::imin(n, i0 + chunk) - i0);
  // dynamic shared memory: [α, ρ][q][S slots][Y slots], each part only
  // where the plan's flags put it there
  T* sp = reinterpret_cast<T*>(smem_raw);
  T* alpha_s;
  if (flags & kAlphaInSmem) {
    alpha_s = sp;
    sp += 2 * m;
  } else {
    alpha_s = scratch + rank * 2 * m;
  }
  T* rho_s = alpha_s + m;
  T* q;
  if (flags & kQInSmem) {
    q = sp;
    sp += chunk;
  } else {
    q = out + i0;
  }
  const bool resident = (flags & kResident) != 0;
  T* s_res = sp;
  T* y_res = sp + m * chunk;
  const int64_t pos = *pos_p;
  int64_t count = *count_p;
  count = count < 0 ? 0 : (count > m ? m : count);
  const T h0 = *h0_p;

  for (int64_t j = threadIdx.x; j < len; j += kThreads) q[j] = g[i0 + j];
  if (resident) {
    // the k-th newest valid pair goes to slot k
    for (int64_t k = 0; k < count; ++k) {
      const int64_t row = slot_of(pos, k, m) * n + i0;
      for (int64_t j = threadIdx.x; j < len; j += kThreads) {
        s_res[k * chunk + j] = S[row + j];
        y_res[k * chunk + j] = Y[row + j];
      }
    }
  }
  scso::cluster_wait();  // every block has started
  auto s_of = [&](int64_t k) -> const T* {
    return resident ? s_res + k * chunk : S + slot_of(pos, k, m) * n + i0;
  };
  auto y_of = [&](int64_t k) -> const T* {
    return resident ? y_res + k * chunk : Y + slot_of(pos, k, m) * n + i0;
  };

  int buf = 0;
  for (int64_t k = 0; k < count; ++k) {
    const T* s = s_of(k);
    const T* y = y_of(k);
    double dots[2] = {0.0, 0.0};  // yᵀs, sᵀq
    for (int64_t j = threadIdx.x; j < len; j += kThreads) {
      const double sj = static_cast<double>(s[j]);
      dots[0] += static_cast<double>(y[j]) * sj;
      dots[1] += sj * static_cast<double>(q[j]);
    }
    scso::cluster_reduce<2>(cl, dots, red, inbox[buf]);
    buf ^= 1;
    const T ysT = static_cast<T>(dots[0]);
    const T rho = ysT != T(0) ? T(1) / ysT : T(0);
    const T alpha = rho * static_cast<T>(dots[1]);
    if (threadIdx.x == 0) {
      alpha_s[k] = alpha;
      rho_s[k] = rho;
    }
    for (int64_t j = threadIdx.x; j < len; j += kThreads)
      q[j] = q[j] - alpha * y[j];
  }

  for (int64_t j = threadIdx.x; j < len; j += kThreads) q[j] = h0 * q[j];

  for (int64_t k = count - 1; k >= 0; --k) {
    const T* s = s_of(k);
    const T* y = y_of(k);
    double yr[1] = {0.0};
    for (int64_t j = threadIdx.x; j < len; j += kThreads)
      yr[0] += static_cast<double>(y[j]) * static_cast<double>(q[j]);
    // its barriers also order the reads of alpha_s / rho_s
    scso::cluster_reduce<1>(cl, yr, red, inbox[buf]);
    buf ^= 1;
    const T coef = alpha_s[k] - rho_s[k] * static_cast<T>(yr[0]);
    for (int64_t j = threadIdx.x; j < len; j += kThreads)
      q[j] = q[j] + s[j] * coef;
  }

  for (int64_t j = threadIdx.x; j < len; j += kThreads) out[i0 + j] = -q[j];
}

template <typename T>
int launch(const void* S, const void* Y, const void* g, const void* pos,
           const void* count, const void* h0, void* scratch, void* out,
           int64_t m, int64_t n, int64_t blocks, int64_t chunk,
           int64_t flags, int64_t smem, void* stream) {
  // the wrapper's plan must cover n and fit the shared memory it asks for
  if (m < 1 || blocks < 1 || blocks > 16 || chunk < 1 ||
      blocks * chunk < n || smem < 0 || static_cast<size_t>(smem) > kSmemMax ||
      (!(flags & kAlphaInSmem) && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t allowed =
      scso::allow_cluster(two_loop_cluster<T>, kSmemMax);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  scso::ClusterLaunch l(static_cast<unsigned>(blocks), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaLaunchKernelEx(
      &l.cfg, two_loop_cluster<T>, static_cast<const T*>(S),
      static_cast<const T*>(Y), static_cast<const T*>(g),
      static_cast<const int*>(pos), static_cast<const int*>(count),
      static_cast<const T*>(h0), static_cast<T*>(scratch),
      static_cast<T*>(out), m, n, chunk, flags));
}

// clusters of ``blocks`` blocks, each with the most shared memory a
// launch takes, that the card holds at once
template <typename T>
int cluster_fit(int64_t blocks, void* count) {
  cudaError_t e = scso::allow_cluster(two_loop_cluster<T>, kSmemMax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(scso::clusters_that_fit(
      two_loop_cluster<T>, static_cast<unsigned>(blocks), kThreads, kSmemMax,
      static_cast<int*>(count)));
}

}  // namespace

#define SCSO_TWO_LOOP_ENTRY(NAME, FIT, T)                                    \
  extern "C" int NAME(const void* S, const void* Y, const void* g,          \
                      const void* pos, const void* count, const void* h0,   \
                      void* scratch, void* out, int64_t m, int64_t n,       \
                      int64_t blocks, int64_t chunk, int64_t flags,         \
                      int64_t smem, void* stream) {                         \
    return launch<T>(S, Y, g, pos, count, h0, scratch, out, m, n, blocks,    \
                     chunk, flags, smem, stream);                            \
  }                                                                          \
  extern "C" int FIT(int64_t blocks, void* count) {                          \
    return cluster_fit<T>(blocks, count);                                    \
  }

SCSO_TWO_LOOP_ENTRY(scso_two_loop_f32, scso_two_loop_cluster_fit_f32, float)
SCSO_TWO_LOOP_ENTRY(scso_two_loop_f64, scso_two_loop_cluster_fit_f64, double)
