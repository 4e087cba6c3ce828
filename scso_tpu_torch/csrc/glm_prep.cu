// K2: dual-candidate GLM epoch prep for the logistic01 GLM (ggn flavour).
//
// Replaces the TPU kernel scso_tpu/ops/pallas/glm_prep.py:239
// (_fused_glm_prep_pair). For two candidate iterates x_t and x_d it
// gives, per candidate c:
//   z     = A x_c
//   w     = (y σ(−z)² + (1−y) σ(z)²) / m        CG matvec weights (m,)
//   b     = Aᵀ ρ,  ρ = (σ(z) − y) / m            RHS pullback      (n,)
//   hd    = Σ_i w_i A_ij²                        Jacobi diagonal   (n,)
//   loss  = Σ_{i<m} softplus(z_i) − y_i z_i      unnormalized      ()
// The TPU kernel traces arbitrary Python ρ/ω/ℓ into its body; CUDA
// cannot, so this kernel is specialised on the spec kind (logistic01,
// with the 1/m normalization folded in). Rows are never padded: the
// kernel masks the ragged edges itself, so the loss covers the true
// rows only.
//
// What bounds it on the H100: the bytes of A. The TPU kernel reads A
// once; here x_t, x_d and four (n,) accumulators would need 6·n·4 B =
// 243 KB of shared memory at n = 10112, more than a block has. So the
// work is split in two phases, each one pass over A:
//   rows:    one warp per row (grid-stride), both dot products from one
//            read of the row; lane 0 writes w_t, w_d, ρ_t, ρ_d and
//            accumulates the two losses in double; a fixed-order block
//            reduction writes one loss partial pair per block;
//   columns: a 2-D grid of (column tile) × (row chunk); each thread owns
//            one 16-byte chunk of columns (4 in f32, 2 in f64; one
//            column when rows are not 16-byte aligned) and sweeps the
//            chunk's rows, accumulating b_t, b_d, hd_t, hd_d in double
//            registers (ρ and w staged in shared memory), and writes one
//            partial per row chunk.
// A third small kernel sums the chunk partials and the loss partials in
// a fixed order, in double. So no float atomics, bitwise-identical
// reruns, and the cross-block sums keep (more than) the accuracy of the
// TPU kernel's Kahan-compensated f32 sums. Both passes load A as
// streaming (evict-first) data, so x_t, x_d, ρ and w stay in L2.
// HBM traffic: two reads of A (a simple form; one read is later
// work), plus 4·m·sizeof(T) for w and ρ, plus the partials.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // all three kernels; == kTile below
constexpr int kTile = 256;      // rows staged per step of the column sweep

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
glm_pair_rows(const T* __restrict__ A, const T* __restrict__ y,
              const T* __restrict__ xt, const T* __restrict__ xd,
              T* __restrict__ wt, T* __restrict__ wd, T* __restrict__ rw,
              double* __restrict__ loss_partials, int64_t m, int64_t n) {
  using C = scso::Chunk<T, VEC>;
  using V = typename C::type;
  __shared__ double red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;
  const int64_t nc = n / C::E;
  const V* xt_c = reinterpret_cast<const V*>(xt);
  const V* xd_c = reinterpret_cast<const V*>(xd);
  const T mT = static_cast<T>(m);
  double lt = 0.0, ld = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * nwarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * nwarps + warp; i < m;
       i += stride) {
    const V* a = reinterpret_cast<const V*>(A + i * n);
    T zt = T(0), zd = T(0);
#pragma unroll 4
    for (int64_t q = lane; q < nc; q += 32) {
      const V aq = __ldcs(a + q);
      zt += C::dot(aq, __ldg(xt_c + q));
      zd += C::dot(aq, __ldg(xd_c + q));
    }
    zt = scso::warp_sum(zt);
    zd = scso::warp_sum(zd);
    if (lane == 0) {
      const T yi = y[i];
      logistic01(zt, yi, mT, rw + i, wt + i, &lt);
      logistic01(zd, yi, mT, rw + m + i, wd + i, &ld);
    }
  }
  if (lane == 0) {
    red[0][warp] = lt;
    red[1][warp] = ld;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s0 = 0.0, s1 = 0.0;
    for (int k = 0; k < nwarps; ++k) {
      s0 += red[0][k];
      s1 += red[1][k];
    }
    loss_partials[2 * blockIdx.x] = s0;
    loss_partials[2 * blockIdx.x + 1] = s1;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
glm_pair_cols(const T* __restrict__ A, const T* __restrict__ wt,
              const T* __restrict__ wd, const T* __restrict__ rw,
              double* __restrict__ col_partials, int64_t m, int64_t n,
              int64_t rows_per_chunk) {
  using C = scso::Chunk<T, VEC>;
  using V = typename C::type;
  constexpr int E = C::E;
  __shared__ double s_rt[kTile], s_rd[kTile], s_wt[kTile], s_wd[kTile];
  const int64_t nc = n / E;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c = blockIdx.y;
  const int64_t r_begin = c * rows_per_chunk;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_chunk);
  double bt[E], bd[E], ht[E], hd[E];
#pragma unroll
  for (int e = 0; e < E; ++e) bt[e] = bd[e] = ht[e] = hd[e] = 0.0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kTile) {
    const int nr = static_cast<int>(scso::imin(kTile, r_end - r0));
    __syncthreads();  // the previous step may still read the stage
    if (threadIdx.x < nr) {
      const int64_t i = r0 + threadIdx.x;
      s_rt[threadIdx.x] = static_cast<double>(rw[i]);
      s_rd[threadIdx.x] = static_cast<double>(rw[m + i]);
      s_wt[threadIdx.x] = static_cast<double>(wt[i]);
      s_wd[threadIdx.x] = static_cast<double>(wd[i]);
    }
    __syncthreads();
    if (q < nc) {
      const V* a = reinterpret_cast<const V*>(A + r0 * n) + q;
#pragma unroll 4
      for (int k = 0; k < nr; ++k) {
        const V av = __ldcs(a + k * nc);
        const T* ae = reinterpret_cast<const T*>(&av);
        const double rt = s_rt[k], rd = s_rd[k], gt = s_wt[k], gd = s_wd[k];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const double aij = static_cast<double>(ae[e]);
          const double aa = aij * aij;
          bt[e] += rt * aij;
          bd[e] += rd * aij;
          ht[e] += gt * aa;
          hd[e] += gd * aa;
        }
      }
    }
  }
  if (q < nc) {
    double* dst = col_partials + c * 4 * n + q * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[e] = bt[e];
      dst[n + e] = bd[e];
      dst[2 * n + e] = ht[e];
      dst[3 * n + e] = hd[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
glm_pair_finalize(const double* __restrict__ col_partials,
                  const double* __restrict__ loss_partials,
                  T* __restrict__ bt, T* __restrict__ bd,
                  T* __restrict__ ht, T* __restrict__ hd,
                  T* __restrict__ lt, T* __restrict__ ld, int64_t n,
                  int64_t chunks, int64_t row_blocks) {
  __shared__ double red[32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < n) {
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int64_t c = 0; c < chunks; ++c) {
      const double* src = col_partials + c * 4 * n + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += src[q * n];
    }
    bt[j] = static_cast<T>(s[0]);
    bd[j] = static_cast<T>(s[1]);
    ht[j] = static_cast<T>(s[2]);
    hd[j] = static_cast<T>(s[3]);
  }
  if (blockIdx.x == 0) {  // the two loss sums, fixed order
    double s0 = 0.0, s1 = 0.0;
    for (int64_t b = threadIdx.x; b < row_blocks; b += kThreads) {
      s0 += loss_partials[2 * b];
      s1 += loss_partials[2 * b + 1];
    }
    s0 = scso::block_sum(s0, red);
    s1 = scso::block_sum(s1, red);
    if (threadIdx.x == 0) {
      *lt = static_cast<T>(s0);
      *ld = static_cast<T>(s1);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch_passes(const T* A, const T* y, const T* xt, const T* xd,
                          T* wt, T* wd, T* rw, double* col_partials,
                          double* loss_partials, int64_t m, int64_t n,
                          int64_t row_blocks, int64_t chunks,
                          cudaStream_t s) {
  glm_pair_rows<T, VEC><<<static_cast<unsigned>(row_blocks), kThreads, 0, s>>>(
      A, y, xt, xd, wt, wd, rw, loss_partials, m, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t nc = n / scso::Chunk<T, VEC>::E;
  const int64_t col_tiles = (nc + kThreads - 1) / kThreads;
  glm_pair_cols<T, VEC><<<dim3(static_cast<unsigned>(col_tiles),
                               static_cast<unsigned>(chunks)), kThreads, 0, s>>>(
      A, wt, wd, rw, col_partials, m, n, (m + chunks - 1) / chunks);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* y, const void* xt, const void* xd,
           void* wt, void* wd, void* rw, void* bt, void* bd, void* ht,
           void* hd, void* lt, void* ld, void* col_partials,
           void* loss_partials, int64_t m, int64_t n, int64_t row_blocks,
           int64_t chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // 16-byte chunks need every row of A, and x_t and x_d, 16-byte aligned
  const bool vec = n % (16 / sizeof(T)) == 0 && aligned(A) && aligned(xt) &&
                   aligned(xd);
  auto pass = vec ? &launch_passes<T, true> : &launch_passes<T, false>;
  cudaError_t err = pass(
      static_cast<const T*>(A), static_cast<const T*>(y),
      static_cast<const T*>(xt), static_cast<const T*>(xd),
      static_cast<T*>(wt), static_cast<T*>(wd), static_cast<T*>(rw),
      static_cast<double*>(col_partials), static_cast<double*>(loss_partials),
      m, n, row_blocks, chunks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  glm_pair_finalize<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, s>>>(
      static_cast<const double*>(col_partials),
      static_cast<const double*>(loss_partials), static_cast<T*>(bt),
      static_cast<T*>(bd), static_cast<T*>(ht), static_cast<T*>(hd),
      static_cast<T*>(lt), static_cast<T*>(ld), n, chunks, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SCSO_GLM_PAIR_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* A, const void* y, const void* xt,         \
                      const void* xd, void* wt, void* wd, void* rw,         \
                      void* bt, void* bd, void* ht, void* hd, void* lt,     \
                      void* ld, void* col_partials, void* loss_partials,    \
                      int64_t m, int64_t n, int64_t row_blocks,             \
                      int64_t chunks, void* stream) {                       \
    return launch<T>(A, y, xt, xd, wt, wd, rw, bt, bd, ht, hd, lt, ld,      \
                     col_partials, loss_partials, m, n, row_blocks, chunks, \
                     stream);                                               \
  }

SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f32, float)
SCSO_GLM_PAIR_ENTRY(scso_glm_prep_pair_f64, double)
