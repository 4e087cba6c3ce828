// K1: fused normal-equation matvec  out = Aᵀ(w ∘ (A v)).
//
// Replaces the TPU kernel scso_tpu/ops/pallas/matvec.py:118
// (_fused_normal_matvec), which keeps a row tile of A in VMEM for both
// contractions and so reads A from HBM once per product. It runs once
// per CG iteration, so it is the solver's hot op.
//
// What bounds it on the H100: the bytes of A (m·n·sizeof(S), S the type
// A is stored in); it does ~4 flops per element of A, far below the
// card's compute roof.
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
// Narrow n (GROUPED): when a row has fewer chunks than half the block's
// threads, the threads split into ``groups`` (a power of two, chosen by
// the wrapper) of kThreads/groups; each group walks its own kRows rows
// of a step into its own accumulator in shared memory, and the block
// sums its groups' accumulators in order at the end — every thread has
// a chunk at n = 1024 instead of a quarter or half of them. The launch
// takes no more blocks than fit on the SMs at once for the form's
// registers and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// so the blocks run in one wave.
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
//
// A stored in bfloat16 (the low-precision copy of precision-adaptive
// CG, S = __nv_bfloat16, T = float or double): the same walk, with
// A's bytes halved. A 16-byte chunk holds 8 values (n % 8 == 0, else
// one value a load), upcast in registers — bf16 → f32 puts the 16 bits
// above 16 zero bits, exact — and v, the accumulator and all sums stay
// in T. Four rows a step, so that a step streams as many bytes as the
// f32 form's two (the L2 working set stays ≈ 21 MB). In shared memory
// column 8q + e of v and the accumulator sits at e·(n/8) + q: a warp's
// lanes own consecutive chunks q, so each of their eight scalar
// accesses hits 32 consecutive words, without bank conflicts (in
// column order, 32-byte strides would conflict two ways; two 16-byte
// pieces a chunk, piece-major, ran slower on the H100 at 196608×10112).
// Bound: 3.98
// GB of A at 196608×10112, 1.19 ms at 3.35 TB/s. With T = double it
// accumulates in double, as the port's plain version (A upcast to w's
// dtype) and the JAX package's XLA route (bf16 @ f64 promotes) do; the
// TPU kernel accumulates a bf16 tile in f32 whatever w's type
// (matvec.py:131).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T, int E>
struct Vals {
  T e[E];
};

// How a thread meets one chunk of E columns: its load of A (Raw), the
// values of v and of the accumulator for those columns, and where
// column j sits in the shared v and accumulator (pos).
template <typename S, typename T, bool VEC, bool WIDE>
struct Cols;

// A stored in T: scso::Chunk — a float4 / double2, or one value — with
// v and the accumulator in column order. Two rows a step.
template <typename T, bool VEC, bool WIDE>
struct Cols<T, T, VEC, WIDE> {
  using Ch = scso::Chunk<T, VEC>;
  using Raw = typename Ch::type;
  using V = typename Ch::type;
  static constexpr int E = Ch::E;
  static constexpr int kRows = 2;
  static __device__ __forceinline__ int64_t pos(int64_t j, int64_t) {
    return j;
  }
  static __device__ __forceinline__ V load_v(const T* v, int64_t q,
                                             int64_t) {
    const V* p = reinterpret_cast<const V*>(v) + q;
    return WIDE ? __ldg(p) : *p;
  }
  static __device__ __forceinline__ V load_acc(const T* acc, int64_t q,
                                               int64_t) {
    return reinterpret_cast<const V*>(acc)[q];
  }
  static __device__ __forceinline__ void store_acc(T* acc, int64_t q,
                                                   int64_t, const V& a) {
    reinterpret_cast<V*>(acc)[q] = a;
  }
  static __device__ __forceinline__ T dot(Raw a, const V& v) {
    return Ch::dot(a, v);
  }
  static __device__ __forceinline__ void axpy(V& acc, T u, Raw a) {
    Ch::axpy(acc, u, a);
  }
};

using scso::bf16_hi;
using scso::bf16_lo;

// A stored in bfloat16, rows 16-byte aligned: a 16-byte load of A holds
// 8 values, upcast in registers; v and the accumulator hold them as 8
// values of T. In shared memory column 8q + e sits at e·nc + q, so a
// warp's lanes (consecutive chunks q) make each of their eight scalar
// accesses to 32 consecutive words, without bank conflicts; WIDE keeps
// column order in global memory. Four rows a step.
template <typename T, bool WIDE>
struct Cols<__nv_bfloat16, T, true, WIDE> {
  static constexpr int E = 8;
  static constexpr int kRows = 4;
  using Raw = uint4;
  using V = Vals<T, E>;
  static __device__ __forceinline__ int64_t at(int64_t q, int e,
                                               int64_t nc) {
    return WIDE ? q * E + e : e * nc + q;
  }
  static __device__ __forceinline__ int64_t pos(int64_t j, int64_t nc) {
    return at(j / E, static_cast<int>(j % E), nc);
  }
  static __device__ __forceinline__ V load_v(const T* v, int64_t q,
                                             int64_t nc) {
    V out;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out.e[e] = WIDE ? __ldg(v + at(q, e, nc)) : v[at(q, e, nc)];
    return out;
  }
  static __device__ __forceinline__ V load_acc(const T* acc, int64_t q,
                                               int64_t nc) {
    V out;
#pragma unroll
    for (int e = 0; e < E; ++e) out.e[e] = acc[at(q, e, nc)];
    return out;
  }
  static __device__ __forceinline__ void store_acc(T* acc, int64_t q,
                                                   int64_t nc, const V& a) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[at(q, e, nc)] = a.e[e];
  }
  static __device__ __forceinline__ void unpack(Raw a, T (&x)[E]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};  // two values a word
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = T(bf16_lo(w[i]));
      x[2 * i + 1] = T(bf16_hi(w[i]));
    }
  }
  static __device__ __forceinline__ T dot(Raw a, const V& v) {
    T x[E];
    unpack(a, x);
    T s = x[0] * v.e[0];
#pragma unroll
    for (int e = 1; e < E; ++e) s += x[e] * v.e[e];
    return s;
  }
  static __device__ __forceinline__ void axpy(V& acc, T u, Raw a) {
    T x[E];
    unpack(a, x);
#pragma unroll
    for (int e = 0; e < E; ++e) acc.e[e] += u * x[e];
  }
};

// A stored in bfloat16, rows not 16-byte aligned: one value a load, v
// and the accumulator in column order. Four rows a step.
template <typename T, bool WIDE>
struct Cols<__nv_bfloat16, T, false, WIDE> {
  static constexpr int E = 1;
  static constexpr int kRows = 4;
  using Raw = unsigned short;
  using V = T;
  static __device__ __forceinline__ int64_t pos(int64_t j, int64_t) {
    return j;
  }
  static __device__ __forceinline__ V load_v(const T* v, int64_t q,
                                             int64_t) {
    return WIDE ? __ldg(v + q) : v[q];
  }
  static __device__ __forceinline__ V load_acc(const T* acc, int64_t q,
                                               int64_t) {
    return acc[q];
  }
  static __device__ __forceinline__ void store_acc(T* acc, int64_t q,
                                                   int64_t, const V& a) {
    acc[q] = a;
  }
  static __device__ __forceinline__ T dot(Raw a, const V& v) {
    return T(bf16_lo(a)) * v;
  }
  static __device__ __forceinline__ void axpy(V& acc, T u, Raw a) {
    acc += u * T(bf16_lo(a));
  }
};

template <typename S, typename T, bool VEC, bool WIDE, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
normal_matvec_partial(const S* __restrict__ A, const T* __restrict__ w,
                      const T* __restrict__ v, T* __restrict__ partials,
                      int64_t m, int64_t n, int64_t rows_per_block,
                      int groups_arg) {
  using C = Cols<S, T, VEC, WIDE>;
  using Raw = typename C::Raw;
  using V = typename C::V;
  constexpr int kRows = C::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_s[kRows][kThreads / 32];
  __shared__ T u_s[kThreads / 32][kRows];  // [group][row]
  T* dst = partials + static_cast<int64_t>(blockIdx.x) * n;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // row groups (narrow n): group g of the block's threads walks its own
  // kRows rows of each step into its own accumulator. Ungrouped, the
  // stride over a row's chunks is the constant kThreads
  const int groups = GROUPED ? groups_arg : 1;
  const int gthreads = kThreads / groups;
  const int g = GROUPED ? tid / gthreads : 0;  // uniform when ungrouped
  const int gl = GROUPED ? tid % gthreads : tid;
  const int wpg = gthreads / 32;  // warps a group
  // v and the accumulators: shared memory, or (WIDE, one group) global
  T* v_s = reinterpret_cast<T*>(smem_raw);
  T* acc0 = WIDE ? dst : v_s + n;
  T* acc_s = acc0 + static_cast<int64_t>(g) * n;
  const T* v_src = WIDE ? v : v_s;
  const int64_t nc = n / C::E;  // chunks per row (VEC: n % E == 0)
  for (int64_t j = tid; j < n; j += kThreads)
    if (!WIDE) v_s[C::pos(j, nc)] = v[j];
  for (int64_t j = tid; j < groups * n; j += kThreads) acc0[j] = T(0);
  __syncthreads();

  const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = scso::imin(m, row_begin + rows_per_block);
  const int64_t step = static_cast<int64_t>(kRows) * groups;
  for (int64_t r0 = row_begin; r0 < row_end; r0 += step) {
    const int64_t rg = r0 + static_cast<int64_t>(g) * kRows;
    // rows of this group in the step (ungrouped: at least one)
    const int nr = static_cast<int>(
        GROUPED ? scso::imin(kRows, scso::imax(int64_t(0), row_end - rg))
                : scso::imin(kRows, row_end - r0));
    const Raw* a0 = reinterpret_cast<const Raw*>(A + rg * n);
    // the threads that form u load their row's weight now, so that the
    // load overlaps phase A instead of following its reduction
    const bool forms_u = tid < groups * kRows;
    const int64_t urow = r0 + tid;  // gg·kRows + r below
    const T w_row = forms_u && urow < row_end ? w[urow] : T(0);
    // phase A: t_r = A_r · v
    T t[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) t[r] = T(0);
#pragma unroll 2
    for (int64_t q = gl; q < nc; q += gthreads) {
      const V vq = C::load_v(v_src, q, nc);
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
    if (forms_u) {
      const int gg = tid / kRows, r = tid % kRows;
      T s = T(0);
      for (int k = 0; k < wpg; ++k) s += red_s[r][gg * wpg + k];
      u_s[gg][r] = urow < row_end ? w_row * s : T(0);
    }
    __syncthreads();
    // phase B: acc += Σ_r u_r · A_r (each thread: its own chunks only)
    T u[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) u[r] = u_s[g][r];
#pragma unroll 2
    for (int64_t q = gl; q < nc; q += gthreads) {
      V acc = C::load_acc(acc_s, q, nc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) C::axpy(acc, u[r], __ldcs(a0 + r * nc + q));
      C::store_acc(acc_s, q, nc, acc);
    }
  }
  if (!WIDE) {
    __syncthreads();  // chunk ownership differs from the element loop below
    for (int64_t j = tid; j < n; j += kThreads) {
      const int64_t p = C::pos(j, nc);
      T s = acc0[p];
      for (int k = 1; k < groups; ++k) s += acc0[k * n + p];  // in order
      dst[j] = s;
    }
  }
}

template <typename S, typename T, bool VEC, bool WIDE, bool GROUPED>
cudaError_t launch_partial(const S* A, const T* w, const T* v, T* partials,
                           int64_t m, int64_t n, int64_t* nblk, int groups,
                           cudaStream_t s) {
  const auto kernel = normal_matvec_partial<S, T, VEC, WIDE, GROUPED>;
  const size_t smem =
      WIDE ? 0 : (1 + groups) * static_cast<size_t>(n) * sizeof(T);
  cudaError_t err = scso::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // one wave: no more blocks than fit on the SMs at once for this form
  // (its registers and shared memory), asked of the runtime once for
  // each form, device and shared-memory size (the solver launches K1
  // once a CG iteration, always at the same n)
  static thread_local int last_dev = -1, last_cap = 0;
  static thread_local size_t last_smem = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != last_dev || smem != last_smem) {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    last_dev = dev, last_smem = smem, last_cap = per_sm * sms;
  }
  *nblk = scso::imax(int64_t(1), scso::imin(*nblk, last_cap));
  kernel<<<static_cast<unsigned>(*nblk), kThreads, smem, s>>>(
      A, w, v, partials, m, n, (m + *nblk - 1) / *nblk, groups);
  return cudaGetLastError();
}

template <typename S, typename T, bool WIDE>
cudaError_t launch_form(const S* A, const T* w, const T* v, T* partials,
                        int64_t m, int64_t n, int64_t* nblk, int groups,
                        cudaStream_t s) {
  // 16-byte chunks need every row 16-byte aligned
  constexpr int E = 16 / sizeof(S);
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   (!WIDE || reinterpret_cast<uintptr_t>(v) % 16 == 0);
  if constexpr (WIDE) {  // the wide form has one group
    return vec ? launch_partial<S, T, true, true, false>(
                     A, w, v, partials, m, n, nblk, 1, s)
               : launch_partial<S, T, false, true, false>(
                     A, w, v, partials, m, n, nblk, 1, s);
  } else if (groups > 1) {
    return vec ? launch_partial<S, T, true, false, true>(
                     A, w, v, partials, m, n, nblk, groups, s)
               : launch_partial<S, T, false, false, true>(
                     A, w, v, partials, m, n, nblk, groups, s);
  } else {
    return vec ? launch_partial<S, T, true, false, false>(
                     A, w, v, partials, m, n, nblk, 1, s)
               : launch_partial<S, T, false, false, false>(
                     A, w, v, partials, m, n, nblk, 1, s);
  }
}

// ``nblk``: the rows of ``partials``, the most blocks the launch may use
template <typename S, typename T>
int launch(const void* A, const void* w, const void* v, void* partials,
           void* out, int64_t m, int64_t n, int64_t nblk, int64_t wide,
           int64_t groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const S* a = static_cast<const S*>(A);
  const T* w_ = static_cast<const T*>(w);
  const T* v_ = static_cast<const T*>(v);
  T* p_ = static_cast<T*>(partials);
  if (groups < 1 || groups > kThreads / 32 || (kThreads / 32) % groups ||
      (wide && groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gr = static_cast<int>(groups);
  cudaError_t err =
      wide ? launch_form<S, T, true>(a, w_, v_, p_, m, n, &nblk, gr, s)
           : launch_form<S, T, false>(a, w_, v_, p_, m, n, &nblk, gr, s);
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
                                      int64_t groups, void* stream) {
  return launch<float, float>(A, w, v, partials, out, m, n, nblk, wide,
                              groups, stream);
}

extern "C" int scso_normal_matvec_f64(const void* A, const void* w,
                                      const void* v, void* partials,
                                      void* out, int64_t m, int64_t n,
                                      int64_t nblk, int64_t wide,
                                      int64_t groups, void* stream) {
  return launch<double, double>(A, w, v, partials, out, m, n, nblk, wide,
                                groups, stream);
}

// A in bfloat16; w, v, partials and out in float (float32 problems)
extern "C" int scso_normal_matvec_bf16_f32(const void* A, const void* w,
                                           const void* v, void* partials,
                                           void* out, int64_t m, int64_t n,
                                           int64_t nblk, int64_t wide,
                                           int64_t groups, void* stream) {
  return launch<__nv_bfloat16, float>(A, w, v, partials, out, m, n, nblk,
                                      wide, groups, stream);
}

// A in bfloat16; w, v, partials and out in double (float64 problems)
extern "C" int scso_normal_matvec_bf16_f64(const void* A, const void* w,
                                           const void* v, void* partials,
                                           void* out, int64_t m, int64_t n,
                                           int64_t nblk, int64_t wide,
                                           int64_t groups, void* stream) {
  return launch<__nv_bfloat16, double>(A, w, v, partials, out, m, n, nblk,
                                       wide, groups, stream);
}
