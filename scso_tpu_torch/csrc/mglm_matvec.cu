// K5: fused multi-output GGN matvec  out = Aᵀ·quad(Z, A·V), multinomial.
//
// Replaces the TPU kernel scso_tpu/ops/pallas/mglm_matvec.py:152
// (_fused_mglm_matvec), which keeps a row tile of A in VMEM for both
// contractions and traces the spec's Python `quad` into its body. CUDA
// cannot trace Python, so this kernel is specialised on the multinomial
// spec (MOGLMSpec.kind == 'multinomial'), with 1/m folded in:
//   P_i  = softmax(Z_i)                      (max-subtracted, over k)
//   U_i  = A_i · V                           (k values)
//   QU_i = (P_i∘U_i − P_i·Σ_c P_ic U_ic) / m
//   out  = Σ_i A_iᵀ · QU_i                   (p × k)
// It runs once per CG iteration on the multinomial path.
//
// What bounds it on the H100: at 196608×1024×16 f32 a call reads 0.81 GB
// of A (0.24 ms at the data sheet's 3.35 TB/s) and does 4·m·p·k = 12.9
// GFLOP (0.19 ms at 67 TFLOP/s FP32): the two data-sheet floors are
// close, and the per-row reduction of U across the block adds its own
// instructions on top of the FMAs. Measured it takes ~0.82 ms: with ~168
// registers a thread only 8 warps fit on an SM, too few to hide the
// latency of the reduction's shuffle chains and the barrier (16 warps
// with fewer registers measured slower; PERF.md). FP32 FMAs on the CUDA
// cores — no TF32 tensor cores, which keep about three digits.
//
// Fused form (k <= 16, p <= 1024; one read of A). 256 threads a block,
// one block per SM (the accumulators take most of the registers); each
// block owns a contiguous row range. Thread t owns the columns
// j = t + q·256 (q < JPT): it keeps its JPT × KB accumulators in
// registers for the whole range, and V transposed in shared memory
// (KB × 256·JPT values: 64 KB at the bench shape in f32, 128 KB in f64)
// is read without bank conflicts. Rows go in batches of RB:
//   1. the batch's A values of the thread's columns go into registers
//      (the next batch's are loaded before this one is used, to hide
//      the latency of device memory) — A is read exactly once;
//   2. partial U over the thread's columns; a warp reduce-scatter writes
//      each warp's sums to a double-buffered shared array — one barrier
//      per batch;
//   3. every warp sums the 8 warps' partials in a fixed order and applies
//      the softmax curvature to the batch itself (groups of lanes per
//      row, k <= KB), so no warp waits on another for QU;
//   4. acc[j][c] += A_ij · QU_ic from the same registers as step 1.
// Two-pass form (any other k <= 128 and p; reads A twice): a row kernel
// (one warp per row, classes in chunks of 16, V given transposed by the
// wrapper) writes QU (m × k) to a scratch buffer, then a column kernel
// (thread per column, 16 classes, a row chunk per block) forms Aᵀ·QU.
// Both forms write per-block (p × k) partials that sum_partials adds in
// a fixed order in double: no float atomics, bitwise-equal reruns.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // fused form
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = 8;   // two-pass row kernel: warps per block
constexpr int kColThreads = 256;
constexpr int kKC = 16;        // two-pass: classes per chunk
constexpr int kMaxK = 128;

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -CUDART_INF_F;
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -CUDART_INF;
}

// ---------------------------------------------------------------------------
// fused form
// ---------------------------------------------------------------------------

template <typename T, int JPT, int RB>
__device__ __forceinline__ void load_rows(T (&a)[RB][JPT],
                                          const T* __restrict__ A,
                                          int64_t r0, int64_t r_end, int p,
                                          int tid) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int j = tid + q * kThreads;
      const int64_t i = r0 + r;
      a[r][q] = (i < r_end && j < p) ? __ldcs(A + i * p + j) : T(0);
    }
  }
}

template <typename T, int KB, int JPT, int RB>
__global__ void __launch_bounds__(kThreads, 1)
mglm_fused(const T* __restrict__ A, const T* __restrict__ Z,
           const T* __restrict__ V, T* __restrict__ partials, int64_t m,
           int p, int k, int64_t rows_per_block) {
  constexpr int PW = kThreads * JPT;  // columns covered by the block
  constexpr int N = RB * KB;          // U values per row batch
  constexpr int NL = N >= 32 ? N / 32 : 1;  // values per lane (quad)
  constexpr int G = KB / NL;          // lanes holding one row (quad)
  using VT = typename scso::Chunk<T, true>::type;
  constexpr int E = scso::Chunk<T, true>::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vt = reinterpret_cast<T*>(smem_raw);  // [KB][PW], zero-padded
  __shared__ T red[2][kWarps][N];          // double-buffered partial U
  __shared__ __align__(16) T qu_w[kWarps][N];  // each warp's copy of QU

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < KB * PW; e += kThreads) {
    const int c = e / PW, j = e - c * PW;
    vt[e] = (c < k && j < p) ? V[static_cast<int64_t>(j) * k + c] : T(0);
  }
  __syncthreads();

  T acc[JPT][KB];
#pragma unroll
  for (int q = 0; q < JPT; ++q)
#pragma unroll
    for (int c = 0; c < KB; ++c) acc[q][c] = T(0);

  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_block);
  T a[RB][JPT], an[RB][JPT];
  load_rows<T, JPT, RB>(a, A, r_begin, r_end, p, tid);
  int buf = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += RB, buf ^= 1) {
    load_rows<T, JPT, RB>(an, A, r0 + RB, r_end, p, tid);
    // partial U over this thread's columns, then the block sum
    T u[N];
#pragma unroll
    for (int e = 0; e < N; ++e) u[e] = T(0);
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        const T vv = vt[c * PW + tid + q * kThreads];
#pragma unroll
        for (int r = 0; r < RB; ++r) u[r * KB + c] += a[r][q] * vv;
      }
    }
    scso::warp_reduce_scatter<N>(u, lane);
    if (N >= 32 || (lane & (32 / N - 1)) == 0) {
#pragma unroll
      for (int e = 0; e < NL; ++e)
        red[buf][warp][scso::rs_index<N>(lane, e)] = u[e];
    }
    // one barrier per batch: red is double-buffered, and a warp writes
    // red[buf] again only after every warp passed the next barrier
    __syncthreads();
    // every warp applies the softmax curvature to the whole batch: lane
    // l holds values l·NL + e (row (l·NL) / KB), G lanes a row
    {
      T s[NL], z[NL];
      T zmax = neg_inf<T>();
      bool live[NL];
      const int r = (lane * NL) / KB;
      const int64_t i = r0 + r;
#pragma unroll
      for (int e = 0; e < NL; ++e) {
        const int idx = lane * NL + e, c = idx - r * KB;
        live[e] = idx < N && c < k && i < r_end;
        s[e] = T(0);
        if (idx < N) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s[e] += red[buf][w][idx];
        }
        z[e] = live[e] ? Z[i * k + c] : neg_inf<T>();
        zmax = fmax(zmax, z[e]);
      }
      zmax = scso::group_max<G>(zmax);
      T ez[NL], den = T(0);
#pragma unroll
      for (int e = 0; e < NL; ++e) {
        ez[e] = live[e] ? scso::dexp(z[e] - zmax) : T(0);
        den += ez[e];
      }
      den = scso::group_sum<G>(den);
      T P[NL], pu[NL], spu = T(0);
#pragma unroll
      for (int e = 0; e < NL; ++e) {
        P[e] = live[e] ? ez[e] / den : T(0);
        pu[e] = P[e] * s[e];
        spu += pu[e];
      }
      spu = scso::group_sum<G>(spu);
#pragma unroll
      for (int e = 0; e < NL; ++e) {
        const int idx = lane * NL + e;
        if (idx < N)
          qu_w[warp][idx] =
              live[e] ? (pu[e] - P[e] * spu) / static_cast<T>(m) : T(0);
      }
    }
    __syncwarp();
    // acc += A_iᵀ · QU_i from the registers of the first contraction
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c0 = 0; c0 < KB; c0 += E) {
        const VT qv = *reinterpret_cast<const VT*>(&qu_w[warp][r * KB + c0]);
        const T* qs = reinterpret_cast<const T*>(&qv);
#pragma unroll
        for (int ce = 0; ce < E; ++ce) {
#pragma unroll
          for (int q = 0; q < JPT; ++q) acc[q][c0 + ce] += a[r][q] * qs[ce];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < JPT; ++q) a[r][q] = an[r][q];
  }

  T* dst = partials + static_cast<int64_t>(blockIdx.x) * p * k;
#pragma unroll
  for (int q = 0; q < JPT; ++q) {
    const int j = tid + q * kThreads;
    if (j < p) {
#pragma unroll
      for (int c = 0; c < KB; ++c)
        if (c < k) dst[static_cast<int64_t>(j) * k + c] = acc[q][c];
    }
  }
}

template <typename T, int KB, int JPT>
cudaError_t launch_fused(const T* A, const T* Z, const T* V, T* partials,
                         int64_t m, int p, int k, int64_t nblk,
                         cudaStream_t s) {
  constexpr int RB = sizeof(T) == 4 ? 4 : 2;  // f64: registers
  const size_t smem = static_cast<size_t>(KB) * kThreads * JPT * sizeof(T);
  auto kernel = mglm_fused<T, KB, JPT, RB>;
  cudaError_t err = scso::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nblk), kThreads, smem, s>>>(
      A, Z, V, partials, m, p, k, (m + nblk - 1) / nblk);
  return cudaGetLastError();
}

template <typename T, int KB>
cudaError_t fused_by_width(const T* A, const T* Z, const T* V, T* partials,
                           int64_t m, int p, int k, int64_t nblk,
                           cudaStream_t s) {
  const int jpt = (p + kThreads - 1) / kThreads;
  if (jpt <= 1) return launch_fused<T, KB, 1>(A, Z, V, partials, m, p, k, nblk, s);
  if (jpt <= 2) return launch_fused<T, KB, 2>(A, Z, V, partials, m, p, k, nblk, s);
  return launch_fused<T, KB, 4>(A, Z, V, partials, m, p, k, nblk, s);
}

// ---------------------------------------------------------------------------
// two-pass form
// ---------------------------------------------------------------------------

// Vt is V transposed (k × p), so a warp's loads of it are coalesced.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
mglm_rows(const T* __restrict__ A, const T* __restrict__ Z,
          const T* __restrict__ Vt, T* __restrict__ qu, int64_t m, int p,
          int k) {
  __shared__ T u_s[kRowWarps][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp; i < m;
       i += static_cast<int64_t>(gridDim.x) * kRowWarps) {
    const T* a_row = A + i * p;
    for (int c0 = 0; c0 < k; c0 += kKC) {
      T u[kKC];
#pragma unroll
      for (int cc = 0; cc < kKC; ++cc) u[cc] = T(0);
      for (int j = lane; j < p; j += 32) {
        const T a = a_row[j];
        const T* vc = Vt + static_cast<int64_t>(c0) * p + j;
#pragma unroll
        for (int cc = 0; cc < kKC; ++cc)
          if (c0 + cc < k) u[cc] += a * __ldg(vc + static_cast<int64_t>(cc) * p);
      }
      scso::warp_reduce_scatter<kKC>(u, lane);
      const int c = c0 + scso::rs_index<kKC>(lane, 0);
      if ((lane & (32 / kKC - 1)) == 0 && c < k) u_s[warp][c] = u[0];
    }
    __syncwarp();
    // softmax curvature over the row: lane owns classes lane + 32·t
    constexpr int S = kMaxK / 32;
    T z[S];
    T zmax = neg_inf<T>();
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int c = lane + 32 * t;
      z[t] = c < k ? Z[i * k + c] : neg_inf<T>();
      zmax = fmax(zmax, z[t]);
    }
    zmax = scso::warp_max(zmax);
    T e[S], den = T(0);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      e[t] = lane + 32 * t < k ? scso::dexp(z[t] - zmax) : T(0);
      den += e[t];
    }
    den = scso::warp_sum(den);
    T P[S], pu[S], spu = T(0);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int c = lane + 32 * t;
      P[t] = e[t] / den;
      pu[t] = c < k ? P[t] * u_s[warp][c] : T(0);
      spu += pu[t];
    }
    spu = scso::warp_sum(spu);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int c = lane + 32 * t;
      if (c < k) qu[i * k + c] = (pu[t] - P[t] * spu) / static_cast<T>(m);
    }
    __syncwarp();  // u_s is rewritten for the warp's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kColThreads)
mglm_cols(const T* __restrict__ A, const T* __restrict__ qu,
          T* __restrict__ partials, int64_t m, int p, int k,
          int64_t rows_per_chunk) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c0 = blockIdx.y * kKC;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * rows_per_chunk;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_chunk);
  if (j >= p) return;
  T acc[kKC];
#pragma unroll
  for (int cc = 0; cc < kKC; ++cc) acc[cc] = T(0);
  for (int64_t i = r_begin; i < r_end; ++i) {
    const T a = A[i * p + j];
    const T* qr = qu + i * k + c0;
#pragma unroll
    for (int cc = 0; cc < kKC; ++cc)
      if (c0 + cc < k) acc[cc] += a * qr[cc];
  }
  T* dst = partials + static_cast<int64_t>(blockIdx.z) * p * k +
           static_cast<int64_t>(j) * k + c0;
#pragma unroll
  for (int cc = 0; cc < kKC; ++cc)
    if (c0 + cc < k) dst[cc] = acc[cc];
}

template <typename T>
cudaError_t launch_two_pass(const T* A, const T* Z, const T* Vt, T* qu,
                            T* partials, int64_t m, int p, int k,
                            int64_t nblk, cudaStream_t s) {
  const int64_t row_blocks =
      scso::imin((m + kRowWarps - 1) / kRowWarps, int64_t(1) << 16);
  mglm_rows<T><<<static_cast<unsigned>(row_blocks), kRowWarps * 32, 0, s>>>(
      A, Z, Vt, qu, m, p, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kColThreads - 1) / kColThreads, (k + kKC - 1) / kKC,
                  static_cast<unsigned>(nblk));
  mglm_cols<T><<<grid, kColThreads, 0, s>>>(A, qu, partials, m, p, k,
                                            (m + nblk - 1) / nblk);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* Z, const void* V, void* qu,
           void* partials, void* out, int64_t m, int64_t p, int64_t k,
           int64_t nblk, int64_t fused, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* z = static_cast<const T*>(Z);
  const T* v = static_cast<const T*>(V);
  T* part = static_cast<T*>(partials);
  const int pi = static_cast<int>(p), ki = static_cast<int>(k);
  cudaError_t err;
  if (fused) {
    err = k <= 8 ? fused_by_width<T, 8>(a, z, v, part, m, pi, ki, nblk, s)
                 : fused_by_width<T, 16>(a, z, v, part, m, pi, ki, nblk, s);
  } else {
    err = launch_two_pass<T>(a, z, v, static_cast<T*>(qu), part, m, pi, ki,
                             nblk, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = p * k;
  scso::sum_partials<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, static_cast<T*>(out), n, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scso_mglm_matvec_f32(const void* A, const void* Z,
                                    const void* V, void* qu, void* partials,
                                    void* out, int64_t m, int64_t p,
                                    int64_t k, int64_t nblk, int64_t fused,
                                    void* stream) {
  return launch<float>(A, Z, V, qu, partials, out, m, p, k, nblk, fused,
                       stream);
}

extern "C" int scso_mglm_matvec_f64(const void* A, const void* Z,
                                    const void* V, void* qu, void* partials,
                                    void* out, int64_t m, int64_t p,
                                    int64_t k, int64_t nblk, int64_t fused,
                                    void* stream) {
  return launch<double>(A, Z, V, qu, partials, out, m, p, k, nblk, fused,
                        stream);
}
