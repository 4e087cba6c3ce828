// K3: the SCORE damped-prox update, the tail of every solver epoch.
//
// Replaces the TPU kernel scso_tpu/ops/pallas/score_update.py:108
// (_fused_update):
//   η     = sqrt(Σ lgr²/hr), a term with lgr = 0 counted as 0
//   α     = ss / (1 + M_g·η);  safe = min(1, α)
//   x⁺    = prox(x + safe·d; t = ss·λ·hr)   for l1, l2, indbox or none
//   pri   = ‖x⁺ − x‖
// The elementwise phase needs the grid-wide η first. What bounds it on
// the H100: at the main path's n ≈ 10⁴ the update is ~7 reads of n
// values, so latency (one launch, two dependent reductions), not bytes;
// at n = 2²⁰ and more it is the bytes, which one SM cannot pull at the
// card's rate.
//
// Cluster form (the wrapper's ``update_form``): ONE launch of one
// thread-block cluster of up to 16 blocks of 1024 threads, block b owning
// a contiguous slice of n. Each block reduces its double partial of
// Σ lgr²/hr and pushes it into every block's shared memory through
// distributed shared memory; after cluster.sync() every block adds the
// partials in rank order (common.cuh, cluster_reduce), so every block
// forms the same η, α and safe; each block applies the prox to its slice
// and the partials of ‖x⁺ − x‖² are added the same way.
// Grid form, from the cluster's n limit on: three launches, still in a
// fixed order: (1) each block writes its slice's partial of Σ lgr²/hr;
// (2) every block adds all those partials in the same order, applies the
// prox to its slice and writes its partial of ‖x⁺ − x‖²; (3) one block
// adds those in order.
// Every sum is in double and in a fixed order, with no float atomics, so
// reruns are bitwise equal. λ and ss are read from device memory and
// pri, safe, η are written there, so the caller never waits for the
// device.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

enum Reg : int64_t { kL1 = 0, kL2 = 1, kIndBox = 2, kNone = 3 };

// lgr²/hr → 0 where lgr = 0, even at hr = 0
template <typename T>
__device__ __forceinline__ double eta_term(T g, T h) {
  return g == T(0) ? 0.0 : static_cast<double>(g * g / h);
}

// max and min that return NaN where either operand is NaN, as
// torch.maximum/minimum, torch.clamp and jnp.maximum/minimum do: a plain
// `a > b ? a : b` would turn a runaway step's NaN into a finite value
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T prox_one(T xs, T h, T lam, T ss, int64_t reg,
                                      const T* __restrict__ lb,
                                      const T* __restrict__ ub, int64_t i) {
  if (reg == kL1) {
    const T t = ss * lam * h;
    const T mag = (xs < T(0) ? -xs : xs) - t;
    const T sgn = static_cast<T>((xs > T(0)) - (xs < T(0)));
    return sgn * nan_max(mag, T(0));
  }
  if (reg == kL2) {
    const T t = ss * lam * h;
    const T xs2 = xs * xs;
    const T scale = xs2 == T(0) ? T(0) : nan_max(T(1) - t / xs2, T(0));
    return xs * scale;
  }
  if (reg == kIndBox) return nan_min(nan_max(xs, lb[i]), ub[i]);
  return xs;
}

// The prox over [i0, i1) with safe; returns the thread's Σ (x⁺ − x)².
template <typename T>
__device__ __forceinline__ double apply(
    const T* __restrict__ x, const T* __restrict__ d,
    const T* __restrict__ hr, const T* __restrict__ lb,
    const T* __restrict__ ub, T lam, T ss, T safe, int64_t reg,
    T* __restrict__ x_new, int64_t i0, int64_t i1) {
  double pri2 = 0.0;
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const T xi = x[i];
    const T xn = prox_one(xi + safe * d[i], hr[i], lam, ss, reg, lb, ub, i);
    x_new[i] = xn;
    const double dx = static_cast<double>(xn - xi);
    pri2 += dx * dx;
  }
  return pri2;
}

template <typename T>
__device__ __forceinline__ T safe_step(T eta, T ss, T Mg) {
  return nan_min(ss / (T(1) + Mg * eta), T(1));
}

// cluster form: block of rank b owns [b·chunk, min(n, (b+1)·chunk))
template <typename T>
__global__ void __launch_bounds__(kThreads)
score_update_cluster(const T* __restrict__ x, const T* __restrict__ d,
                     const T* __restrict__ lgr, const T* __restrict__ hr,
                     const T* __restrict__ lb, const T* __restrict__ ub,
                     const T* __restrict__ lam_p, const T* __restrict__ ss_p,
                     const T* __restrict__ Mg_p, int64_t reg,
                     T* __restrict__ x_new,
                     T* __restrict__ stats, int64_t n, int64_t chunk) {
  __shared__ double red[32];
  // the blocks' partials of Σ lgr²/hr, then of Σ (x⁺ − x)², by rank
  __shared__ double inbox[2][scso::kMaxCluster];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  scso::cluster_arrive_relaxed();
  const int64_t i0 = static_cast<int64_t>(cl.block_rank()) * chunk;
  const int64_t i1 = scso::imin(n, i0 + chunk);
  double acc[1] = {0.0};
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads)
    acc[0] += eta_term(lgr[i], hr[i]);
  scso::cluster_wait();  // every block has started
  scso::cluster_reduce<1>(cl, acc, red, inbox[0]);
  const T eta = static_cast<T>(sqrt(acc[0]));
  const T lam = *lam_p, ss = *ss_p;
  const T safe = safe_step(eta, ss, *Mg_p);
  double pri2[1] = {apply(x, d, hr, lb, ub, lam, ss, safe, reg, x_new, i0,
                          i1)};
  scso::cluster_reduce<1>(cl, pri2, red, inbox[1]);
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    stats[0] = static_cast<T>(sqrt(pri2[0]));
    stats[1] = safe;
    stats[2] = eta;
  }
}

// grid form: block b owns [b·chunk, min(n, (b+1)·chunk))
template <typename T>
__global__ void __launch_bounds__(kThreads)
score_eta_partials(const T* __restrict__ lgr, const T* __restrict__ hr,
                   double* __restrict__ eta_part, int64_t n, int64_t chunk) {
  __shared__ double red[32];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t i1 = scso::imin(n, i0 + chunk);
  double acc = 0.0;
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads)
    acc += eta_term(lgr[i], hr[i]);
  acc = scso::block_sum(acc, red);
  if (threadIdx.x == 0) eta_part[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_apply(const T* __restrict__ x, const T* __restrict__ d,
            const T* __restrict__ hr, const T* __restrict__ lb,
            const T* __restrict__ ub, const T* __restrict__ lam_p,
            const T* __restrict__ ss_p, const T* __restrict__ Mg_p,
            int64_t reg,
            const double* __restrict__ eta_part,
            double* __restrict__ pri_part, T* __restrict__ x_new,
            T* __restrict__ stats, int64_t n, int64_t chunk) {
  __shared__ double red[32];
  // every block adds the same partials in the same order
  double acc = 0.0;
  for (int64_t b = threadIdx.x; b < gridDim.x; b += kThreads)
    acc += eta_part[b];
  const T eta = static_cast<T>(sqrt(scso::block_sum(acc, red)));
  const T lam = *lam_p, ss = *ss_p;
  const T safe = safe_step(eta, ss, *Mg_p);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const double pri2 = scso::block_sum(
      apply(x, d, hr, lb, ub, lam, ss, safe, reg, x_new, i0,
            scso::imin(n, i0 + chunk)), red);
  if (threadIdx.x == 0) {
    pri_part[blockIdx.x] = pri2;
    if (blockIdx.x == 0) {
      stats[1] = safe;
      stats[2] = eta;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_pri(const double* __restrict__ pri_part, T* __restrict__ stats,
          int64_t nblk) {
  __shared__ double red[32];
  double acc = 0.0;
  for (int64_t b = threadIdx.x; b < nblk; b += kThreads) acc += pri_part[b];
  const double pri = sqrt(scso::block_sum(acc, red));
  if (threadIdx.x == 0) stats[0] = static_cast<T>(pri);
}

template <typename T>
int launch(const void* x_, const void* d_, const void* lgr_, const void* hr_,
           const void* lb_, const void* ub_, const void* lam_,
           const void* ss_, const void* Mg_, int64_t reg, void* x_new_,
           void* stats_, void* partials, int64_t n, int64_t blocks,
           int64_t chunk, int64_t grid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x_);
  const T* d = static_cast<const T*>(d_);
  const T* lgr = static_cast<const T*>(lgr_);
  const T* hr = static_cast<const T*>(hr_);
  const T* lb = static_cast<const T*>(lb_);
  const T* ub = static_cast<const T*>(ub_);
  const T* lam = static_cast<const T*>(lam_);
  const T* ss = static_cast<const T*>(ss_);
  const T* Mg = static_cast<const T*>(Mg_);
  T* x_new = static_cast<T*>(x_new_);
  T* stats = static_cast<T*>(stats_);
  // the wrapper's slices must cover n
  if (blocks < 1 || chunk < 1 || blocks * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!grid) {
    if (blocks > 16) return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t allowed =
        scso::allow_cluster(score_update_cluster<T>, 0);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    scso::ClusterLaunch l(static_cast<unsigned>(blocks), kThreads, 0, s);
    return static_cast<int>(cudaLaunchKernelEx(
        &l.cfg, score_update_cluster<T>, x, d, lgr, hr, lb, ub, lam, ss, Mg,
        reg, x_new, stats, n, chunk));
  }
  double* eta_part = static_cast<double*>(partials);
  double* pri_part = eta_part + blocks;
  const unsigned nblk = static_cast<unsigned>(blocks);
  score_eta_partials<T><<<nblk, kThreads, 0, s>>>(lgr, hr, eta_part, n,
                                                  chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_apply<T><<<nblk, kThreads, 0, s>>>(x, d, hr, lb, ub, lam, ss, Mg,
                                           reg, eta_part, pri_part, x_new,
                                           stats, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_pri<T><<<1, kThreads, 0, s>>>(pri_part, stats, blocks);
  return static_cast<int>(cudaGetLastError());
}

// clusters of ``blocks`` blocks of the cluster form the card holds at once
template <typename T>
int cluster_fit(int64_t blocks, void* count) {
  cudaError_t e = scso::allow_cluster(score_update_cluster<T>, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(scso::clusters_that_fit(
      score_update_cluster<T>, static_cast<unsigned>(blocks), kThreads, 0,
      static_cast<int*>(count)));
}

}  // namespace

#define SCSO_SCORE_UPDATE_ENTRY(NAME, FIT, T)                                \
  extern "C" int NAME(const void* x, const void* d, const void* lgr,        \
                      const void* hr, const void* lb, const void* ub,       \
                      const void* lam, const void* ss, const void* Mg,      \
                      int64_t reg, void* x_new, void* stats,                \
                      void* partials, int64_t n, int64_t blocks,            \
                      int64_t chunk, int64_t grid, void* stream) {          \
    return launch<T>(x, d, lgr, hr, lb, ub, lam, ss, Mg, reg, x_new, stats, \
                     partials, n, blocks, chunk, grid, stream);             \
  }                                                                          \
  extern "C" int FIT(int64_t blocks, void* count) {                          \
    return cluster_fit<T>(blocks, count);                                    \
  }

SCSO_SCORE_UPDATE_ENTRY(scso_score_update_f32,
                        scso_score_update_cluster_fit_f32, float)
SCSO_SCORE_UPDATE_ENTRY(scso_score_update_f64,
                        scso_score_update_cluster_fit_f64, double)

// Message for a CUDA error code returned by any entry point above.
extern "C" const char* scso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
