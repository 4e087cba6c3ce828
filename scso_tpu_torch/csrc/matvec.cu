// K1: fused normal-equation matvec  out = Aᵀ(w ∘ (A v)).
//
// Replaces the TPU kernel scso_tpu/ops/pallas/matvec.py:118
// (_fused_normal_matvec), which keeps a row tile of A in VMEM for both
// contractions and so reads A from HBM once per product. It runs once
// per CG iteration, so it is the solver's hot op.
//
// What bounds it on the H100: the bytes of A (m·n·sizeof(T)); it does
// ~4 flops per element of A, far below the card's compute roof.
//
// Design: blocks own contiguous row ranges and run in parallel. Each
// block keeps v and its own (n,) accumulator in shared memory
// (2·n·sizeof(T): 80 KB at n = 10112 in f32, 160 KB in f64, under the
// 227 KB a block may use — the wrapper enforces this limit on n). A
// block walks its rows kRows at a time:
//   phase A: each thread owns a fixed set of column chunks (16-byte
//            vectors when rows are 16-byte aligned, else single
//            values) and forms its share of t_r = A_r·v for the rows,
//            with coalesced loads across the warp; a fixed-order block
//            reduction gives t_r, then u_r = w_r·t_r;
//   phase B: the same thread adds u_r·A_r into acc for its chunks — the
//            same addresses it loaded in phase A. Two rows per step keep
//            the blocks' working set (2 rows × 40 KB × 264 blocks ≈ 21
//            MB) inside the 50 MB L2, so the second read comes from L2,
//            and it is a streaming load (evict-first): A's last use.
// Each block writes its accumulator as a row of ``partials``; a second
// kernel sums the rows in a fixed order (in double), so the result is
// bitwise the same from run to run — no float atomics.
//
// Wide form (WIDE, for n above the shared-memory limit the wrapper
// states): the same walk, with v read from global memory through the
// read-only path (it stays in L2) and each block accumulating straight
// into its own row of ``partials`` — every thread touches only its own
// chunks, so there is no race and the final sum is unchanged. It moves
// the accumulator through L2 on every row pair, so it is slower; it
// exists so that any n is solved on the card.
// HBM traffic: one read of A, plus partials (n_blocks·n·sizeof(T)
// written and read). Accumulation is in T (f32 for f32 A, f64 for f64
// A), as on the TPU.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 2;  // rows per phase-A/phase-B step

template <typename T, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
normal_matvec_partial(const T* __restrict__ A, const T* __restrict__ w,
                      const T* __restrict__ v, T* __restrict__ partials,
                      int64_t m, int64_t n, int64_t rows_per_block) {
  using C = scso::Chunk<T, VEC>;
  using V = typename C::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_s[kRows][kThreads / 32];
  __shared__ T u_s[kRows];
  T* dst = partials + static_cast<int64_t>(blockIdx.x) * n;
  // v and the accumulator: shared memory, or (WIDE) global memory
  T* v_s = reinterpret_cast<T*>(smem_raw);
  T* acc_s = WIDE ? dst : v_s + n;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int64_t j = tid; j < n; j += kThreads) {
    if (!WIDE) v_s[j] = v[j];
    acc_s[j] = T(0);
  }
  __syncthreads();
  const int64_t nc = n / C::E;  // chunks per row (VEC: n % E == 0)
  const V* v_c = reinterpret_cast<const V*>(WIDE ? v : v_s);
  V* acc_c = reinterpret_cast<V*>(acc_s);

  const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = scso::imin(m, row_begin + rows_per_block);
  for (int64_t r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int nr = static_cast<int>(scso::imin(kRows, row_end - r0));
    const V* a0 = reinterpret_cast<const V*>(A + r0 * n);
    // phase A: t_r = A_r · v
    T t[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) t[r] = T(0);
#pragma unroll 2
    for (int64_t q = tid; q < nc; q += kThreads) {
      const V vq = WIDE ? __ldg(v_c + q) : v_c[q];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) t[r] += C::dot(a0[r * nc + q], vq);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) t[r] = scso::warp_sum(t[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) red_s[r][warp] = t[r];
    }
    __syncthreads();
    if (tid < kRows) {
      T s = T(0);
      for (int k = 0; k < kThreads / 32; ++k) s += red_s[tid][k];
      u_s[tid] = tid < nr ? w[r0 + tid] * s : T(0);
    }
    __syncthreads();
    // phase B: acc += Σ_r u_r · A_r (each thread: its own chunks only)
    T u[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) u[r] = u_s[r];
#pragma unroll 2
    for (int64_t q = tid; q < nc; q += kThreads) {
      V acc = acc_c[q];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) C::axpy(acc, u[r], __ldcs(a0 + r * nc + q));
      acc_c[q] = acc;
    }
  }
  if (!WIDE) {
    __syncthreads();  // chunk ownership differs from the element loop below
    for (int64_t j = tid; j < n; j += kThreads) dst[j] = acc_s[j];
  }
}

template <typename T, bool VEC, bool WIDE>
cudaError_t launch_partial(const T* A, const T* w, const T* v, T* partials,
                           int64_t m, int64_t n, int64_t nblk,
                           cudaStream_t s) {
  const size_t smem = WIDE ? 0 : 2 * static_cast<size_t>(n) * sizeof(T);
  cudaError_t err =
      scso::allow_smem(normal_matvec_partial<T, VEC, WIDE>, smem);
  if (err != cudaSuccess) return err;
  normal_matvec_partial<T, VEC, WIDE>
      <<<static_cast<unsigned>(nblk), kThreads, smem, s>>>(
          A, w, v, partials, m, n, (m + nblk - 1) / nblk);
  return cudaGetLastError();
}

template <typename T, bool WIDE>
cudaError_t launch_form(const T* A, const T* w, const T* v, T* partials,
                        int64_t m, int64_t n, int64_t nblk, cudaStream_t s) {
  // 16-byte chunks need every row 16-byte aligned
  constexpr int E = 16 / sizeof(T);
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   (!WIDE || reinterpret_cast<uintptr_t>(v) % 16 == 0);
  return vec ? launch_partial<T, true, WIDE>(A, w, v, partials, m, n, nblk, s)
             : launch_partial<T, false, WIDE>(A, w, v, partials, m, n, nblk, s);
}

template <typename T>
int launch(const void* A, const void* w, const void* v, void* partials,
           void* out, int64_t m, int64_t n, int64_t nblk, int64_t wide,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* w_ = static_cast<const T*>(w);
  const T* v_ = static_cast<const T*>(v);
  T* p_ = static_cast<T*>(partials);
  cudaError_t err = wide ? launch_form<T, true>(a, w_, v_, p_, m, n, nblk, s)
                         : launch_form<T, false>(a, w_, v_, p_, m, n, nblk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scso::sum_partials<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      p_, static_cast<T*>(out), n, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scso_normal_matvec_f32(const void* A, const void* w,
                                      const void* v, void* partials,
                                      void* out, int64_t m, int64_t n,
                                      int64_t nblk, int64_t wide,
                                      void* stream) {
  return launch<float>(A, w, v, partials, out, m, n, nblk, wide, stream);
}

extern "C" int scso_normal_matvec_f64(const void* A, const void* w,
                                      const void* v, void* partials,
                                      void* out, int64_t m, int64_t n,
                                      int64_t nblk, int64_t wide,
                                      void* stream) {
  return launch<double>(A, w, v, partials, out, m, n, nblk, wide, stream);
}
