// K3: the SCORE damped-prox update, the tail of every solver epoch.
//
// Replaces the TPU kernel scso_tpu/ops/pallas/score_update.py:108
// (_fused_update):
//   η     = sqrt(Σ lgr²/hr), a term with lgr = 0 counted as 0
//   α     = ss / (1 + M_g·η);  safe = min(1, α)
//   x⁺    = prox(x + safe·d; t = ss·λ·hr)   for l1, l2, indbox or none
//   pri   = ‖x⁺ − x‖
// The elementwise phase needs the grid-wide η first. The vectors are
// short (n ≈ 10⁴ on the main path): the whole update is ~7 reads of n
// values, so it is bound by launch latency, not by bytes. One block of
// 1024 threads therefore loops over all of n — no grid-wide
// synchronisation, one launch — with two fixed-order block reductions
// (in double), so the result is bitwise the same from run to run.
// λ and ss are read from device memory and pri, safe, η are written
// there, so the caller never waits for the device.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

enum Reg : int64_t { kL1 = 0, kL2 = 1, kIndBox = 2, kNone = 3 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_update(const T* __restrict__ x, const T* __restrict__ d,
             const T* __restrict__ lgr, const T* __restrict__ hr,
             const T* __restrict__ lb, const T* __restrict__ ub,
             const T* __restrict__ lam_p, const T* __restrict__ ss_p,
             double Mg, int64_t reg, T* __restrict__ x_new,
             T* __restrict__ stats, int64_t n) {
  __shared__ double red[32];
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const T g = lgr[i];
    // lgr²/hr → 0 where lgr = 0, even at hr = 0
    acc += g == T(0) ? 0.0 : static_cast<double>(g * g / hr[i]);
  }
  const T eta = static_cast<T>(sqrt(scso::block_sum(acc, red)));
  const T lam = *lam_p, ss = *ss_p;
  const T alpha = ss / (T(1) + static_cast<T>(Mg) * eta);
  const T safe = alpha < T(1) ? alpha : T(1);

  double pri2 = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const T xi = x[i];
    const T xs = xi + safe * d[i];
    T xn;
    if (reg == kL1) {
      const T t = ss * lam * hr[i];
      const T mag = (xs < T(0) ? -xs : xs) - t;
      const T sgn = static_cast<T>((xs > T(0)) - (xs < T(0)));
      xn = sgn * (mag > T(0) ? mag : T(0));
    } else if (reg == kL2) {
      const T t = ss * lam * hr[i];
      const T xs2 = xs * xs;
      const T scale = xs2 == T(0) ? T(0) : T(1) - t / xs2;
      xn = xs * (scale > T(0) ? scale : T(0));
    } else if (reg == kIndBox) {
      const T lo = xs > lb[i] ? xs : lb[i];
      xn = lo < ub[i] ? lo : ub[i];
    } else {
      xn = xs;
    }
    x_new[i] = xn;
    const double dx = static_cast<double>(xn - xi);
    pri2 += dx * dx;
  }
  const double pri = sqrt(scso::block_sum(pri2, red));
  if (threadIdx.x == 0) {
    stats[0] = static_cast<T>(pri);
    stats[1] = safe;
    stats[2] = eta;
  }
}

template <typename T>
int launch(const void* x, const void* d, const void* lgr, const void* hr,
           const void* lb, const void* ub, const void* lam, const void* ss,
           double Mg, int64_t reg, void* x_new, void* stats, int64_t n,
           void* stream) {
  score_update<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(d),
      static_cast<const T*>(lgr), static_cast<const T*>(hr),
      static_cast<const T*>(lb), static_cast<const T*>(ub),
      static_cast<const T*>(lam), static_cast<const T*>(ss), Mg, reg,
      static_cast<T*>(x_new), static_cast<T*>(stats), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scso_score_update_f32(const void* x, const void* d,
                                     const void* lgr, const void* hr,
                                     const void* lb, const void* ub,
                                     const void* lam, const void* ss,
                                     double Mg, int64_t reg, void* x_new,
                                     void* stats, int64_t n, void* stream) {
  return launch<float>(x, d, lgr, hr, lb, ub, lam, ss, Mg, reg, x_new,
                       stats, n, stream);
}

extern "C" int scso_score_update_f64(const void* x, const void* d,
                                     const void* lgr, const void* hr,
                                     const void* lb, const void* ub,
                                     const void* lam, const void* ss,
                                     double Mg, int64_t reg, void* x_new,
                                     void* stats, int64_t n, void* stream) {
  return launch<double>(x, d, lgr, hr, lb, ub, lam, ss, Mg, reg, x_new,
                        stats, n, stream);
}

// Message for a CUDA error code returned by any entry point above.
extern "C" const char* scso_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
