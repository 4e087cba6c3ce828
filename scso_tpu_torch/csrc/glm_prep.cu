// K2 and K2s: GLM epoch prep for the logistic01 GLM (ggn flavour).
//
// Replaces two TPU kernels: scso_tpu/ops/pallas/glm_prep.py:239
// (_fused_glm_prep_pair, K2) and :84 (_fused_glm_prep, K2s). For NC
// candidate iterates x_c (K2: NC = 2, the greedy trial x_t and the
// SCORE-damped x_d; K2s: NC = 1, the current iterate) it gives, per
// candidate c:
//   z     = A x_c
//   w     = (y σ(−z)² + (1−y) σ(z)²) / m_norm   CG matvec weights (m,)
//   b     = Aᵀ ρ,  ρ = (σ(z) − y) / m_norm       RHS pullback      (n,)
//   hd    = Σ_i w_i A_ij²                        Jacobi diagonal   (n,)
//   loss  = Σ_{i<m} softplus(z_i) − y_i z_i      unnormalized, K2 only
// The TPU kernels trace arbitrary Python ρ/ω/ℓ into their bodies; CUDA
// cannot, so this source is specialised on the spec kind (logistic01,
// with the 1/m normalization folded in). m_norm is the normalizing
// count, apart from the m rows read: all rows of all ranks when A is
// one rank's row shard (the TPU kernels rescale from the tile's count
// to the true m instead, steps._glm_kernel_fns; dividing by m_norm
// directly keeps the unsharded bits). Rows are never padded: the
// kernels mask the ragged edges themselves, so the loss covers the true
// rows only. K2s has no loss output, as its TPU kernel has none.
//
// What bounds it on the H100: the bytes of A. The TPU kernels read A
// once; here the candidates and 2·NC (n,) accumulators would need up to
// 6·n·4 B = 243 KB of shared memory at n = 10112, more than a block
// has. So the work is split in two phases, each one pass over A, and
// both forms share them, templated on NC:
//   rows:    one warp per row (grid-stride), the NC dot products from one
//            read of the row; lane 0 writes w_c and ρ_c (and for K2
//            accumulates the losses in double; a fixed-order block
//            reduction writes one loss partial per candidate and block);
//   columns: a 2-D grid of (column tile) × (row chunk); each thread owns
//            one 16-byte chunk of columns (4 in f32, 2 in f64; one
//            column when rows are not 16-byte aligned) and sweeps the
//            chunk's rows, accumulating b_c and hd_c in double registers
//            (ρ and w staged in shared memory), and writes one partial
//            per row chunk.
// A third small kernel sums the chunk partials (and K2's loss partials)
// in a fixed order, in double: the deterministic stand-in for the TPU
// kernels' Kahan-compensated cross-tile sums. So no float atomics,
// bitwise-identical reruns, and the cross-block sums keep (more than)
// the TPU kernels' accuracy. Both passes load A as streaming
// (evict-first) data, so the candidates, ρ and w stay in L2.
// HBM traffic: two reads of A (a simple form; one read is later work),
// plus 2·NC·m·sizeof(T) for w and ρ, plus the partials.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // all three kernels; == kTile below
constexpr int kTile = 256;      // rows staged per step of the column sweep

// The candidates and the outputs of one call. ``loss`` is K2's only.
template <typename T, int NC>
struct Prep {
  const T* x[NC];
  T* w[NC];
  T* b[NC];
  T* hd[NC];
  T* loss[NC];
};

template <typename T>
__device__ __forceinline__ void logistic01(T z, T y, T m, T* rho, T* w,
                                           double* loss) {
  const T sp = T(1) / (T(1) + scso::dexp(-z));   // σ(z)
  const T sn = T(1) / (T(1) + scso::dexp(z));    // σ(−z)
  *rho = (sp - y) / m;
  *w = (y * (sn * sn) + (T(1) - y) * (sp * sp)) / m;
  // softplus(z) = max(z, 0) + log1p(exp(−|z|)), stable for every z
  const T softplus = (z > T(0) ? z : T(0)) +
                     scso::dlog1p(scso::dexp(z > T(0) ? -z : z));
  *loss += static_cast<double>(softplus - y * z);
}

template <typename T, bool VEC, int NC>
__global__ void __launch_bounds__(kThreads)
glm_rows(const T* __restrict__ A, const T* __restrict__ y, Prep<T, NC> p,
         T* __restrict__ rw, double* __restrict__ loss_partials, int64_t m,
         int64_t n, int64_t m_norm) {
  using C = scso::Chunk<T, VEC>;
  using V = typename C::type;
  constexpr bool kLoss = NC == 2;
  __shared__ double red[NC][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;
  const int64_t nc = n / C::E;
  const V* xc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) xc[c] = reinterpret_cast<const V*>(p.x[c]);
  const T mT = static_cast<T>(m_norm);
  double loss[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) loss[c] = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * nwarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * nwarps + warp; i < m;
       i += stride) {
    const V* a = reinterpret_cast<const V*>(A + i * n);
    T z[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) z[c] = T(0);
#pragma unroll 4
    for (int64_t q = lane; q < nc; q += 32) {
      const V aq = __ldcs(a + q);
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] += C::dot(aq, __ldg(xc[c] + q));
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) z[c] = scso::warp_sum(z[c]);
    if (lane == 0) {
      const T yi = y[i];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        logistic01(z[c], yi, mT, rw + c * m + i, p.w[c] + i, &loss[c]);
    }
  }
  if constexpr (kLoss) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) red[c][warp] = loss[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        double s = 0.0;
        for (int k = 0; k < nwarps; ++k) s += red[c][k];
        loss_partials[NC * blockIdx.x + c] = s;
      }
    }
  }
}

template <typename T, bool VEC, int NC>
__global__ void __launch_bounds__(kThreads)
glm_cols(const T* __restrict__ A, Prep<T, NC> p, const T* __restrict__ rw,
         double* __restrict__ col_partials, int64_t m, int64_t n,
         int64_t rows_per_chunk) {
  using C = scso::Chunk<T, VEC>;
  using V = typename C::type;
  constexpr int E = C::E;
  __shared__ double s_r[NC][kTile], s_w[NC][kTile];
  const int64_t nc = n / E;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c0 = blockIdx.y;
  const int64_t r_begin = c0 * rows_per_chunk;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_chunk);
  double b[NC][E], h[NC][E];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < E; ++e) b[c][e] = h[c][e] = 0.0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kTile) {
    const int nr = static_cast<int>(scso::imin(kTile, r_end - r0));
    __syncthreads();  // the previous step may still read the stage
    if (threadIdx.x < nr) {
      const int64_t i = r0 + threadIdx.x;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s_r[c][threadIdx.x] = static_cast<double>(rw[c * m + i]);
        s_w[c][threadIdx.x] = static_cast<double>(p.w[c][i]);
      }
    }
    __syncthreads();
    if (q < nc) {
      const V* a = reinterpret_cast<const V*>(A + r0 * n) + q;
#pragma unroll 4
      for (int k = 0; k < nr; ++k) {
        const V av = __ldcs(a + k * nc);
        const T* ae = reinterpret_cast<const T*>(&av);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const double r = s_r[c][k], g = s_w[c][k];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const double aij = static_cast<double>(ae[e]);
            b[c][e] += r * aij;
            h[c][e] += g * (aij * aij);
          }
        }
      }
    }
  }
  if (q < nc) {
    // partials are (chunks, 2·NC, n): b_0 … b_{NC−1}, hd_0 … hd_{NC−1}
    double* dst = col_partials + c0 * 2 * NC * n + q * E;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dst[c * n + e] = b[c][e];
        dst[(NC + c) * n + e] = h[c][e];
      }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
glm_finalize(const double* __restrict__ col_partials,
             const double* __restrict__ loss_partials, Prep<T, NC> p,
             int64_t n, int64_t chunks, int64_t row_blocks) {
  __shared__ double red[32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < n) {
    double s[2 * NC];
#pragma unroll
    for (int q = 0; q < 2 * NC; ++q) s[q] = 0.0;
    for (int64_t c = 0; c < chunks; ++c) {
      const double* src = col_partials + c * 2 * NC * n + j;
#pragma unroll
      for (int q = 0; q < 2 * NC; ++q) s[q] += src[q * n];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p.b[c][j] = static_cast<T>(s[c]);
      p.hd[c][j] = static_cast<T>(s[NC + c]);
    }
  }
  if constexpr (NC == 2) {
    if (blockIdx.x == 0) {  // the two loss sums, fixed order
      double s0 = 0.0, s1 = 0.0;
      for (int64_t b = threadIdx.x; b < row_blocks; b += kThreads) {
        s0 += loss_partials[2 * b];
        s1 += loss_partials[2 * b + 1];
      }
      s0 = scso::block_sum(s0, red);
      s1 = scso::block_sum(s1, red);
      if (threadIdx.x == 0) {
        *p.loss[0] = static_cast<T>(s0);
        *p.loss[1] = static_cast<T>(s1);
      }
    }
  }
}

template <typename T, bool VEC, int NC>
cudaError_t launch_passes(const T* A, const T* y, const Prep<T, NC>& p,
                          T* rw, double* col_partials, double* loss_partials,
                          int64_t m, int64_t n, int64_t m_norm,
                          int64_t row_blocks, int64_t chunks, cudaStream_t s) {
  glm_rows<T, VEC, NC><<<static_cast<unsigned>(row_blocks), kThreads, 0, s>>>(
      A, y, p, rw, loss_partials, m, n, m_norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t nc = n / scso::Chunk<T, VEC>::E;
  const int64_t col_tiles = (nc + kThreads - 1) / kThreads;
  glm_cols<T, VEC, NC><<<dim3(static_cast<unsigned>(col_tiles),
                              static_cast<unsigned>(chunks)), kThreads, 0, s>>>(
      A, p, rw, col_partials, m, n, (m + chunks - 1) / chunks);
  return cudaGetLastError();
}

template <typename T, int NC>
int launch(const void* A, const void* y, const Prep<T, NC>& p, void* rw,
           void* col_partials, void* loss_partials, int64_t m, int64_t n,
           int64_t m_norm, int64_t row_blocks, int64_t chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  // 16-byte chunks need every row of A, and every candidate, 16-byte
  // aligned
  bool vec = n % (16 / sizeof(T)) == 0 && aligned(A);
  for (int c = 0; c < NC; ++c) vec = vec && aligned(p.x[c]);
  auto pass = vec ? &launch_passes<T, true, NC> : &launch_passes<T, false, NC>;
  cudaError_t err = pass(
      static_cast<const T*>(A), static_cast<const T*>(y), p,
      static_cast<T*>(rw), static_cast<double*>(col_partials),
      static_cast<double*>(loss_partials), m, n, m_norm, row_blocks, chunks,
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_finalize<T, NC><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(
      static_cast<const double*>(col_partials),
      static_cast<const double*>(loss_partials), p, n, chunks, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: both candidates, with their loss sums.
#define SCSO_GLM_PAIR_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* A, const void* y, const void* xt,         \
                      const void* xd, void* wt, void* wd, void* rw,         \
                      void* bt, void* bd, void* ht, void* hd, void* lt,     \
                      void* ld, void* col_partials, void* loss_partials,    \
                      int64_t m, int64_t n, int64_t m_norm,                 \
                      int64_t row_blocks, int64_t chunks, void* stream) {   \
    const Prep<T, 2> p{                                                     \
        {static_cast<const T*>(xt), static_cast<const T*>(xd)},             \
        {static_cast<T*>(wt), static_cast<T*>(wd)},                         \
        {static_cast<T*>(bt), static_cast<T*>(bd)},                         \
        {static_cast<T*>(ht), static_cast<T*>(hd)},                         \
        {static_cast<T*>(lt), static_cast<T*>(ld)}};                        \
    return launch<T, 2>(A, y, p, rw, col_partials, loss_partials, m, n,     \
                        m_norm, row_blocks, chunks, stream);                \
  }

// K2s: one candidate, no loss.
#define SCSO_GLM_PREP_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* A, const void* y, const void* x, void* w, \
                      void* rw, void* b, void* hd, void* col_partials,      \
                      int64_t m, int64_t n, int64_t m_norm,                 \
                      int64_t row_blocks, int64_t chunks, void* stream) {   \
    const Prep<T, 1> p{{static_cast<const T*>(x)}, {static_cast<T*>(w)},    \
                       {static_cast<T*>(b)}, {static_cast<T*>(hd)},         \
                       {nullptr}};                                          \
    return launch<T, 1>(A, y, p, rw, col_partials, nullptr, m, n, m_norm,   \
                        row_blocks, chunks, stream);                        \
  }

SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f32, float)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f64, double)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_f32, float)
SCSO_GLM_PREP_ENTRY(scso_glm_prep_f64, double)
