// K2 and K2s: GLM epoch prep for the logistic01, least-squares and
// Poisson GLMs.
//
// Replaces two TPU kernels: scso_tpu/ops/pallas/glm_prep.py:239
// (_fused_glm_prep_pair, K2) and :84 (_fused_glm_prep, K2s). For NC
// candidate iterates x_c (K2: NC = 2, the greedy trial x_t and the
// SCORE-damped x_d; K2s: NC = 1, the current iterate) it gives, per
// candidate c:
//   z     = A x_c
//   ρ, w  = the RHS pullback weights and CG matvec weights (m,), by kind
//           and flavour (below)
//   b     = Aᵀ ρ                                 RHS pullback      (n,)
//   hd    = Σ_i w_i A_ij²                        Jacobi diagonal   (n,)
//   loss  = Σ_{i<m} ℓ(z_i, y_i)                  unnormalized, K2 only
// The kind is the spec's family (scso_tpu/models/losses.py), a runtime
// argument, the same for every row, so every warp takes the same branch:
//   logistic01  ρ = (σ(z) − y)/m_norm            ℓ = softplus(z) − y z
//               ggn     w = (y σ(−z)² + (1−y) σ(z)²)/m_norm
//               newton  w = s (1 − s)/m_norm, s = σ(z)
//   lsq         ρ = (z − y)/m_norm, w = 1/m_norm  ℓ = ½ (z − y)²
//               (both flavours)
//   poisson     ρ = (e^z − y)/m_norm              ℓ = e^z − y z
//               ggn     w = y/m_norm
//               newton  w = e^z/m_norm
// The flavour picks w (scso_tpu/algorithms/steps.py:_glm_kernel_fns):
// ggn is ProxGGNSCORE's (the spec's ggn_rw/ggn_w), newton ProxNSCORE's
// (gres and the true Hessian weights hvp_w; gres equals the ggn ρ for
// all three kinds). K2 comes in both flavours, K2s in the ggn flavour
// alone (the JAX package calls its single-candidate kernel from GGN-CG
// only). The logistic01 newton w is s·(1 − s) with s rounded first, as
// the JAX spec's _sig_dlink computes it: exactly 0 once s rounds to 1
// (z ≳ 17 in f32). e^z is the full-precision exp (expf, not __expf),
// which overflows f32 at z ≈ 88.7 as the JAX spec does.
// The TPU kernels trace arbitrary Python ρ/ω/ℓ into their bodies; CUDA
// cannot, so the one-pass and wide forms compute these three kinds
// (with the 1/m normalization folded in), and any other spec runs the
// split form (below). The kind is a runtime argument rather than a
// template parameter: a third as many instances to build, and a branch
// that costs nothing next to the row's dot (the logistic01 one-pass
// time is held to its time before the kinds, PERF.md). m_norm is the
// normalizing count, apart from the m rows read: all rows of all ranks
// when A is one rank's row shard (the TPU kernels rescale from the
// tile's count to the true m instead, steps._glm_kernel_fns; dividing
// by m_norm directly keeps the unsharded bits). Rows are never padded:
// the kernels mask the ragged edges themselves, so the loss covers the
// true rows only. K2s has no loss output, as its TPU kernel has none.
//
// A is stored in S: T itself (float or double, the compute type T of x,
// y and every output) or bfloat16 (the coarse phase of iterate_mixed,
// where A itself is cast to bfloat16; the TPU kernels upcast each tile,
// glm_prep.py:60 and :198). A bfloat16 value is upcast to T in
// registers — exact — and everything else stays in T, so the function
// is the one of A upcast. glm_prep.cu instantiates the entries with A in
// T, glm_prep_bf16.cu those with A in bfloat16: two sources, built by
// two nvcc processes side by side.
//
// What bounds it on the H100: the bytes of A (m·n·sizeof(S)); it does
// 7·NC flops per element of A, far below the card's compute roof. Both
// flavours read A once and move the same bytes. The
// TPU kernels keep a row tile in VMEM for both contractions and read A
// once (scso_tpu/ops/pallas/glm_prep.py:181-234); so does the one-pass
// form here.
//
// One-pass form (glm_onepass; n up to the wrapper's ``max_n``: 14336
// f32 / 7168 f64 for K2, 28672 / 14336 for K2s, with A in T or in
// bfloat16 — where the 2·NC accumulators, in T, fill 224 KB). One wave
// of persistent blocks (one an SM at the main shape; at narrow n as
// many as fit at 128 registers a thread), each owning a contiguous row
// range, as K1 (matvec.cu) walks it. Each
// thread owns Q fixed 16-byte chunks of a row of A (E values: 4 in f32,
// 2 in f64, 8 in bfloat16; VEC false: E masked scalar loads, for rows
// that are not 16-byte aligned) for the whole walk: Q is a template
// bucket (the wrapper's _buckets: 1–7 for K2, up to 14 for K2s with A
// in T; with A in bfloat16 the fewest the limit needs, K2 1–4 f32 and
// 1–2 f64, K2s 1–7 and 1–4), the block 32·⌈chunks/(32·Q)⌉ ≤ 512
// threads. Its slice of every x_c is loaded once into registers
// (NC·Q·E values of T); the block's 2·NC (n,) accumulators b_c, hd_c
// live in dynamic shared memory in T (2·NC·n·sizeof(T): 161,792 B for
// K2 f32 at n = 10112), which leaves no room for the candidates there.
// A chunk's accumulators are its E/(16/sizeof(T)) 16-byte pieces of T
// (one with A in T; two, or four in f64, with A in bfloat16), laid out
// piece-major — piece h of chunk q at (s·P + h)·nc + q — so that a
// warp's lanes, owning consecutive chunks, touch consecutive 16-byte
// words. The block walks its rows kRows at a time (2; 4 at Q = 2 and 8
// at Q = 1, where rows are narrow), one barrier a step:
//   - prefetch the NEXT row group into L2 (prefetch.global.L2, no
//     registers), so HBM streams while this one is worked on;
//   - phase A: this group from L2 into registers (kRows·Q chunks, an
//     evict-first load: A's only read; a bfloat16 chunk stays packed,
//     four 32-bit words, and is upcast where it is used), its NC dots,
//     a warp sum, one partial per warp into a double-buffered shared
//     array; barrier;
//   - z, ρ and w: lane j of every warp sums pair j's warp partials in a
//     fixed order and evaluates the spec's kind (so every warp holds the
//     same bits), shuffles hand ρ and w to the other lanes; warp 0
//     writes w and adds the loss in double;
//   - phase B: each thread adds ρ·a and w·a² into its own accumulator
//     chunks from the same registers (a the upcast value, squared in
//     T): no second read of A.
// Registers (ptxas -v): K2 f32 at Q = 5 (the main shape) 40 for x, 40
// for the pair, 127 in all, K2s 111, no spills; past n ≈ 10240 f32 /
// 5120 f64 (K2) and 16384 / 6144 (K2s) the buckets spill, as do f64 K2
// at Q = 1 and 2 (a few bytes) and the scalar-load variants a bucket
// earlier. With A in bfloat16 the main shape takes Q = 3 (1,264 chunks
// of 8 values, 448 threads): 48 registers for x, 24 for the pair. So at
// the main shape one block fills an SM's register file. Each block
// writes its accumulators as one row of (blocks, 2·NC, n) partials in
// T, and its loss sums in double.
// Accuracy: a block adds ≈ m/blocks rows in T (≈ 1,500 at 196608×10112,
// ≈ 2,000 at 524288×1024), and the sum over blocks is in double, K1's
// scheme; the TPU kernels' f32 Kahan sums over tiles (glm_prep.py:
// 165-178) are no tighter.
//
// Cluster form (glm_cluster.cuh, its note gives the design): K2 and K2s
// with A in bfloat16 and float32 compute, n from 1025 to 14336, in place
// of the one-pass form there: the one-pass form reached 47% of its bound
// with A in bfloat16 (K2), as its cost a step did not halve with A's
// bytes. The one-pass form keeps the rest of those instances, every
// float64 instance and every instance with A in T, with their geometry
// and bits.
//
// Wide form (glm_rows + glm_cols, n above max_n, where the accumulators
// do not fit a block): two passes over A. rows: one warp per row
// (grid-stride), the NC dots from one read of the row, lane 0 writes w
// and ρ (and K2's loss partials); columns: a 2-D grid of (column tile) ×
// (row chunk), each thread one 16-byte chunk of columns over the
// chunk's rows, accumulating b and hd in double registers, one partial
// per row chunk. It reads A twice, and exists so that any n runs.
//
// Split form (a GLM spec of another kind, any n): the wide form
// in two calls, the spec's own ρ and w computed by the wrapper in
// PyTorch between them: phase 1 is glm_rows writing z_c = A·x_c alone
// (into the ρ scratch), phase 2 glm_cols and glm_finalize from the ρ and
// w the wrapper wrote (the loss sums are the wrapper's too). Like the
// wide form it reads A twice.
//
// glm_finalize sums the block or chunk partials (and K2's loss
// partials) in a fixed order, in double. No float atomics anywhere:
// reruns are bitwise equal.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // wide form
constexpr int kFinThreads = 128;   // finalize
constexpr int kTile = 256;         // rows staged per step of glm_cols
constexpr int kMaxThreads = 512;   // one-pass form: at most 16 warps
constexpr int kSmemBytes = 224 * 1024;  // the wrapper's _SMEM_BYTES
// one-pass form: rows a step, more where a thread owns fewer chunks, so
// the row group in registers (rows·Q chunks) stays about the same size
// and a narrow row costs fewer barriers
__host__ __device__ constexpr int rows_a_step(int q) {
  return q == 1 ? 8 : q == 2 ? 4 : 2;
}

// The one-pass form's chunks-a-thread buckets for A in S, compute type T
// and NC candidates (the wrapper's _buckets): with A in T, 1–7 (K2) and
// 1–8, 10, 12, 14 (K2s); with A in bfloat16, 1 up to the fewest that
// cover max_n's chunks at 512 threads, but 1 alone for K2 in float
// (n <= 1024; the cluster form, glm_cluster.cuh, takes it above).
template <typename S, typename T, int NC>
constexpr bool has_bucket(int q) {
  if constexpr (std::is_same_v<S, T>) {
    return q >= 1 && (q <= 7 || (NC == 1 && (q == 8 || q == 10 || q == 12 ||
                                             q == 14)));
  } else if constexpr (NC == 2 && std::is_same_v<T, float>) {
    return q == 1;  // n <= 1024: the cluster form takes K2 above
  } else {
    constexpr int max_chunks =
        kSmemBytes / (2 * NC * 8 * static_cast<int>(sizeof(T)));
    return q >= 1 && q <= (max_chunks + kMaxThreads - 1) / kMaxThreads;
  }
}

// The candidates and the outputs of one call. ``loss`` is K2's only.
template <typename T, int NC>
struct Prep {
  const T* x[NC];
  T* w[NC];
  T* b[NC];
  T* hd[NC];
  T* loss[NC];
};

// What a row's dot becomes: the spec's ρ and w (and loss) in the ggn or
// the newton flavour, or z alone (the split form's first pass)
enum RowOut { kGGN, kNewton, kZ };

// The spec kinds computed in the kernels, in the wrapper's KERNEL_KINDS
// order (a runtime argument: one value for the whole launch)
enum Kind : int { kLogistic01 = 0, kLsq = 1, kPoisson = 2 };

template <RowOut F, typename T>
__device__ __forceinline__ void row_spec(int kind, T z, T y, T m, T* rho,
                                         T* w) {
  static_assert(F == kGGN || F == kNewton, "a flavour of the spec");
  if (kind == kLsq) {
    *rho = (z - y) / m;
    *w = T(1) / m;
  } else if (kind == kPoisson) {
    const T ez = scso::dexp(z);
    *rho = (ez - y) / m;
    *w = (F == kNewton ? ez : y) / m;
  } else {
    const T sp = T(1) / (T(1) + scso::dexp(-z));  // σ(z)
    *rho = (sp - y) / m;
    if constexpr (F == kNewton) {
      *w = (sp * (T(1) - sp)) / m;
    } else {
      const T sn = T(1) / (T(1) + scso::dexp(z));  // σ(−z)
      *w = (y * (sn * sn) + (T(1) - y) * (sp * sp)) / m;
    }
  }
}

// The unnormalized per-sample loss ℓ(z, y) of the kind, in T, returned
// in double; logistic01's softplus(z) = max(z, 0) + log1p(exp(−|z|)) is
// stable for every z
template <typename T>
__device__ __forceinline__ double row_loss(int kind, T z, T y) {
  if (kind == kLsq) {
    const T r = z - y;
    return static_cast<double>(T(0.5) * (r * r));
  }
  if (kind == kPoisson) return static_cast<double>(scso::dexp(z) - y * z);
  const T softplus = (z > T(0) ? z : T(0)) +
                     scso::dlog1p(scso::dexp(z > T(0) ? -z : z));
  return static_cast<double>(softplus - y * z);
}

// ---------------------------------------------------------------------------
// one-pass form
// ---------------------------------------------------------------------------

// One 16-byte chunk of a row of A as a thread holds it, with A stored
// in S and computed in T: E values, value e upcast by at(). load: chunk
// q of a row (its columns [qE, qE + E)), one 16-byte load (VEC: rows
// 16-byte aligned), else E scalar loads masked at n; STREAM: an
// evict-first load (the data's last use).
template <typename S, typename T>
struct ARow;

// A in T: the chunk is E values of T
template <typename T>
struct ARow<T, T> {
  static constexpr int E = 16 / sizeof(T);
  struct Chunk {
    T v[E];
  };
  static __device__ __forceinline__ T at(const Chunk& c, int e) {
    return c.v[e];
  }
  template <bool VEC, bool STREAM>
  static __device__ __forceinline__ void load(const T* __restrict__ row,
                                              int64_t q, int64_t n,
                                              Chunk& c) {
    using V = typename scso::Chunk<T, true>::type;
    if constexpr (VEC) {
      const V* p = reinterpret_cast<const V*>(row) + q;
      const V v = STREAM ? __ldcs(p) : *p;
      const T* s = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int e = 0; e < E; ++e) c.v[e] = s[e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int64_t j = q * E + e;
        c.v[e] = j < n ? (STREAM ? __ldcs(row + j) : row[j]) : T(0);
      }
    }
  }
};

// A in bfloat16: the chunk is 8 values kept packed, two a 32-bit word
// (half the registers of 8 values of float), upcast to T by at()
template <typename T>
struct ARow<__nv_bfloat16, T> {
  static constexpr int E = 8;
  struct Chunk {
    uint32_t w[4];
  };
  static __device__ __forceinline__ T at(const Chunk& c, int e) {
    const uint32_t x = c.w[e >> 1];
    return static_cast<T>((e & 1) ? scso::bf16_hi(x) : scso::bf16_lo(x));
  }
  template <bool VEC, bool STREAM>
  static __device__ __forceinline__ void load(
      const __nv_bfloat16* __restrict__ row, int64_t q, int64_t n,
      Chunk& c) {
    if constexpr (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(row) + q;
      const uint4 v = STREAM ? __ldcs(p) : *p;
      c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
    } else {
      const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t j = q * E + 2 * i;
        const uint32_t lo = j < n ? (STREAM ? __ldcs(r + j) : r[j]) : 0u;
        const uint32_t hi =
            j + 1 < n ? (STREAM ? __ldcs(r + j + 1) : r[j + 1]) : 0u;
        c.w[i] = lo | (hi << 16);
      }
    }
  }
};

// Values [qE, qE + E) of a vector in T (the candidates): E/(16/sizeof(T))
// 16-byte loads (VEC: 16-byte aligned), else E scalar loads masked at n
template <bool VEC, typename T, int E>
__device__ __forceinline__ void load_vals(const T* __restrict__ x, int64_t q,
                                          int64_t n, T (&v)[E]) {
  using V = typename scso::Chunk<T, true>::type;
  constexpr int ET = 16 / sizeof(T);
  if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < E / ET; ++h) {
      const V p = reinterpret_cast<const V*>(x)[q * (E / ET) + h];
      const T* s = reinterpret_cast<const T*>(&p);
#pragma unroll
      for (int e = 0; e < ET; ++e) v[h * ET + e] = s[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t j = q * E + e;
      v[e] = j < n ? x[j] : T(0);
    }
  }
}

template <typename S, typename T, bool VEC, int NC, int Q, RowOut F>
__global__ void __launch_bounds__(kMaxThreads, 1)
glm_onepass(const S* __restrict__ A, const T* __restrict__ y, Prep<T, NC> p,
            T* __restrict__ partials, double* __restrict__ loss_partials,
            int64_t m, int64_t n, int64_t m_norm, int kind,
            int64_t rows_per_block) {
  using AR = ARow<S, T>;
  constexpr int E = AR::E;            // values of A a chunk
  constexpr int ET = 16 / sizeof(T);  // values of T a 16-byte piece
  constexpr int P = E / ET;           // accumulator pieces a chunk
  constexpr int kRows = rows_a_step(Q);
  constexpr int kPairs = kRows * NC;   // (row, candidate) pairs a step
  static_assert(kPairs <= 32, "one lane a (row, candidate) pair");
  using V = typename scso::Chunk<T, true>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per-warp partial dots of a row pair, double-buffered
  __shared__ T part[2][kPairs][kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int64_t nc = (n + E - 1) / E;   // chunks a row, the last masked
  // accumulators: piece h of chunk q of b_0 … b_{NC−1}, hd_0 … hd_{NC−1}
  // (s = 0 … 2·NC − 1) at (s·P + h)·nc + q
  V* acc = reinterpret_cast<V*>(smem_raw);
  const T mT = static_cast<T>(m_norm);

  T xr[NC][Q][E];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int64_t q = tid + static_cast<int64_t>(k) * nthr;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (q < nc) {
        load_vals<VEC>(p.x[c], q, n, xr[c][k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) xr[c][k][e] = T(0);
      }
    }
    if (q < nc) {
#pragma unroll
      for (int s = 0; s < 2 * NC * P; ++s) acc[s * nc + q] = V{};
    }
  }

  const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = scso::imin(m, row_begin + rows_per_block);
  const int64_t groups =
      row_end > row_begin ? (row_end - row_begin + kRows - 1) / kRows : 0;
  // lane j < kPairs of warp 0: the loss sum of pair j's rows (K2)
  double loss = 0.0;

  // the next row pair into L2 (a hint; no registers), while this one is
  // worked on
  auto prefetch_pair = [&](int64_t r0) {
    const char* base = reinterpret_cast<const char*>(A + r0 * n);
    const int64_t bytes = (scso::imin(row_end, r0 + kRows) - r0) * n *
                          static_cast<int64_t>(sizeof(S));
    for (int64_t off = static_cast<int64_t>(tid) * 128; off < bytes;
         off += static_cast<int64_t>(nthr) * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(base + off));
  };
  if (groups > 0) prefetch_pair(row_begin);
  for (int64_t g = 0; g < groups; ++g) {
    const int64_t r0 = row_begin + g * kRows;
    const int slot = static_cast<int>(g & 1);
    if (g + 1 < groups) prefetch_pair(r0 + kRows);
    // phase A: the pair into registers (A's only read: evict-first), its
    // dots, one partial per warp
    typename AR::Chunk ar[kRows][Q];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int64_t q = tid + static_cast<int64_t>(k) * nthr;
        if (r0 + r < row_end && q < nc) {
          AR::template load<VEC, true>(A + (r0 + r) * n, q, n, ar[r][k]);
        } else {
          ar[r][k] = typename AR::Chunk{};
        }
      }
    // each value of A upcast once for all candidates (each dot still
    // adds in (k, e) order)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      T s[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) s[c] = T(0);
#pragma unroll
      for (int k = 0; k < Q; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T a = AR::at(ar[r][k], e);
#pragma unroll
          for (int c = 0; c < NC; ++c) s[c] += a * xr[c][k][e];
        }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[c] = scso::warp_sum(s[c]);
        if (lane == 0) part[slot][r * NC + c][warp] = s[c];
      }
    }
    // this pair's partials are in; the slot written next step was last
    // read before this barrier
    __syncthreads();
    // z, ρ and w of pair j = r·NC + c: lane j of every warp sums the
    // warp partials in a fixed order (so every warp holds the same bits)
    // and evaluates the spec; shuffles hand ρ and w to the other lanes
    T rho_j = T(0), w_j = T(0);
    if (lane < kPairs) {
      const int r = lane / NC;
      T z = T(0);
      for (int k = 0; k < nwarps; ++k) z += part[slot][lane][k];
      if (r0 + r < row_end) {
        const T yi = y[r0 + r];
        row_spec<F>(kind, z, yi, mT, &rho_j, &w_j);
        if (warp == 0) {
          // (a constant index: a dynamic one would put p in local memory)
          (lane % NC == 0 ? p.w[0] : p.w[NC - 1])[r0 + r] = w_j;
          if constexpr (NC == 2) loss += row_loss(kind, z, yi);
        }
      }
    }
    T rho[kRows][NC], wt[kRows][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        rho[r][c] = __shfl_sync(0xffffffffu, rho_j, r * NC + c);
        wt[r][c] = __shfl_sync(0xffffffffu, w_j, r * NC + c);
      }
    // phase B: acc += ρ·a, w·a² from the same registers, own chunks
    // only; a piece of A at a time, for every candidate
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int64_t q = tid + static_cast<int64_t>(k) * nthr;
      if (q < nc) {
#pragma unroll
        for (int h = 0; h < P; ++h)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            V* bp = acc + (c * P + h) * nc + q;
            V* hp = acc + ((NC + c) * P + h) * nc + q;
            V bv = *bp, hv = *hp;
            T* bt = reinterpret_cast<T*>(&bv);
            T* ht = reinterpret_cast<T*>(&hv);
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int e = 0; e < ET; ++e) {
                const T a = AR::at(ar[r][k], h * ET + e);
                bt[e] += rho[r][c] * a;
                ht[e] += wt[r][c] * (a * a);
              }
            *bp = bv;
            *hp = hv;
          }
      }
    }
  }
  __syncthreads();  // chunk ownership differs from the element loop below
  const T* acc_t = reinterpret_cast<const T*>(smem_raw);
  T* dst = partials + static_cast<int64_t>(blockIdx.x) * 2 * NC * n;
  for (int64_t j = tid; j < n; j += nthr) {
    const int64_t q = j / E;
    const int rem = static_cast<int>(j - q * E), h = rem / ET;
    const int64_t off = q * ET + (rem - h * ET);
#pragma unroll
    for (int s = 0; s < 2 * NC; ++s)
      dst[s * n + j] = acc_t[(s * P + h) * nc * ET + off];
  }
  if constexpr (NC == 2) {
    if (warp == 0) {  // each candidate's loss: its lanes, r in order
      double s[NC] = {0.0, 0.0};
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          s[c] += __shfl_sync(0xffffffffu, loss, r * NC + c);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c) loss_partials[NC * blockIdx.x + c] = s[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wide form
// ---------------------------------------------------------------------------

// One load of a row of A in the wide form: a 16-byte chunk of E values
// (VEC) or one value (E = 1), value e upcast to T by at()
template <typename S, typename T, bool VEC>
struct Wide;

template <typename T, bool VEC>
struct Wide<T, T, VEC> {
  using Raw = typename scso::Chunk<T, VEC>::type;
  static constexpr int E = scso::Chunk<T, VEC>::E;
  static __device__ __forceinline__ T at(const Raw& a, int e) {
    return reinterpret_cast<const T*>(&a)[e];
  }
};

template <typename T>
struct Wide<__nv_bfloat16, T, true> {
  using Raw = uint4;
  static constexpr int E = 8;
  static __device__ __forceinline__ T at(const Raw& a, int e) {
    const uint32_t x = reinterpret_cast<const uint32_t*>(&a)[e >> 1];
    return static_cast<T>((e & 1) ? scso::bf16_hi(x) : scso::bf16_lo(x));
  }
};

template <typename T>
struct Wide<__nv_bfloat16, T, false> {
  using Raw = unsigned short;
  static constexpr int E = 1;
  static __device__ __forceinline__ T at(const Raw& a, int) {
    return static_cast<T>(scso::bf16_lo(a));
  }
};

// F: the kind's ρ, w and loss of each row in that flavour; kZ: z alone,
// into rw
template <typename S, typename T, bool VEC, int NC, RowOut F>
__global__ void __launch_bounds__(kThreads)
glm_rows(const S* __restrict__ A, const T* __restrict__ y, Prep<T, NC> p,
         T* __restrict__ rw, double* __restrict__ loss_partials, int64_t m,
         int64_t n, int64_t m_norm, int kind) {
  using W = Wide<S, T, VEC>;
  using Raw = typename W::Raw;
  constexpr int E = W::E;
  constexpr bool kSpec = F != kZ;
  constexpr bool kLoss = kSpec && NC == 2;
  __shared__ double red[NC][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;
  const int64_t nc = n / E;
  const T mT = static_cast<T>(m_norm);
  double loss[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) loss[c] = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * nwarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * nwarps + warp; i < m;
       i += stride) {
    const Raw* a = reinterpret_cast<const Raw*>(A + i * n);
    T z[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) z[c] = T(0);
#pragma unroll 4
    for (int64_t q = lane; q < nc; q += 32) {
      const Raw aq = __ldcs(a + q);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T xv[E];
        load_vals<(E > 1)>(p.x[c], q, n, xv);  // E == 1: one value
        T s = W::at(aq, 0) * xv[0];
#pragma unroll
        for (int e = 1; e < E; ++e) s += W::at(aq, e) * xv[e];
        z[c] += s;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) z[c] = scso::warp_sum(z[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (kSpec) {
          const T yi = y[i];
          row_spec<F>(kind, z[c], yi, mT, rw + c * m + i, p.w[c] + i);
          if constexpr (kLoss) loss[c] += row_loss(kind, z[c], yi);
        } else {
          rw[c * m + i] = z[c];
        }
      }
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

template <typename S, typename T, bool VEC, int NC>
__global__ void __launch_bounds__(kThreads)
glm_cols(const S* __restrict__ A, Prep<T, NC> p, const T* __restrict__ rw,
         double* __restrict__ col_partials, int64_t m, int64_t n,
         int64_t rows_per_chunk) {
  using W = Wide<S, T, VEC>;
  using Raw = typename W::Raw;
  constexpr int E = W::E;
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
      const Raw* a = reinterpret_cast<const Raw*>(A + r0 * n) + q;
#pragma unroll 4
      for (int k = 0; k < nr; ++k) {
        const Raw av = __ldcs(a + k * nc);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const double r = s_r[c][k], g = s_w[c][k];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const double aij = static_cast<double>(W::at(av, e));
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

// ---------------------------------------------------------------------------
// every form: the fixed-order sums over blocks (P = T one-pass, double wide)
// ---------------------------------------------------------------------------

// Output row s of the (2·NC, n) sums: b_0 … b_{NC−1}, hd_0 … hd_{NC−1}
// (constant indices only: a dynamic one would put p in local memory)
template <typename T, int NC>
__device__ __forceinline__ T* out_row(const Prep<T, NC>& p, int s) {
  T* r = p.hd[NC - 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (s == c) r = p.b[c];
    if (s == NC + c) r = p.hd[c];
  }
  return r;
}

// One thread per output value: the sum over the blocks' partials in
// block order, in double, kBatch loads in flight at a time.
template <typename T, typename P, int NC>
__global__ void __launch_bounds__(kFinThreads)
glm_finalize(const P* __restrict__ partials,
             const double* __restrict__ loss_partials, Prep<T, NC> p,
             int64_t n, int64_t blocks, int64_t loss_blocks) {
  constexpr int kBatch = 8;
  __shared__ double red[32];
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kFinThreads + threadIdx.x;
  if (i < 2 * NC * n) {
    const int s = static_cast<int>(i / n);
    const int64_t j = i - s * n, stride = 2 * NC * n;
    const P* src = partials + s * n + j;
    double acc = 0.0;
    int64_t c = 0;
    for (; c + kBatch <= blocks; c += kBatch) {
      P v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = src[(c + u) * stride];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc += static_cast<double>(v[u]);
    }
    for (; c < blocks; ++c) acc += static_cast<double>(src[c * stride]);
    out_row(p, s)[j] = static_cast<T>(acc);
  }
  if constexpr (NC == 2) {
    if (blockIdx.x == 0) {  // the two loss sums, fixed order
      double s0 = 0.0, s1 = 0.0;
      for (int64_t b = threadIdx.x; b < loss_blocks; b += kFinThreads) {
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

}  // namespace

#include "glm_cluster.cuh"

namespace {

// The launch geometry, chosen by the wrapper (ops/cuda/glm_prep.py,
// prep_grid). One-pass form: q > 0 chunks a thread, ``threads`` a
// block, ``blocks`` blocks of ``rows_per_block`` rows, ``smem`` bytes.
// Cluster form (glm_cluster.cuh; cluster > 0, A in bfloat16, float32):
// ``blocks`` clusters of ``cluster`` blocks, each cluster
// ``rows_per_block`` rows in groups of ``group_rows``, a ring of
// ``stages`` groups. Wide form: q == 0; ``blocks`` row chunks of
// ``rows_per_block`` rows for the columns pass, ``row_blocks`` blocks
// for the rows pass. ``kind`` is the spec's (Kind; the split form's
// calls do not read it).
struct Grid {
  int64_t blocks, rows_per_block, smem, threads, q, row_blocks, cluster,
      stages, group_rows;
  int kind;
};

template <typename S, typename T, int NC, RowOut F, int Q>
cudaError_t launch_onepass(const S* A, const T* y, const Prep<T, NC>& p,
                           T* partials, double* loss_partials, int64_t m,
                           int64_t n, int64_t m_norm, const Grid& g, bool vec,
                           cudaStream_t s) {
  auto kernel = vec ? &glm_onepass<S, T, true, NC, Q, F>
                    : &glm_onepass<S, T, false, NC, Q, F>;
  cudaError_t err = scso::allow_smem(kernel, static_cast<size_t>(g.smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(g.blocks), static_cast<unsigned>(g.threads),
           static_cast<size_t>(g.smem), s>>>(A, y, p, partials, loss_partials,
                                             m, n, m_norm, g.kind,
                                             g.rows_per_block);
  return cudaGetLastError();
}

// The buckets of has_bucket; any other q is refused.
template <typename S, typename T, int NC, RowOut F>
cudaError_t dispatch_onepass(const S* A, const T* y, const Prep<T, NC>& p,
                             T* partials, double* loss_partials, int64_t m,
                             int64_t n, int64_t m_norm, const Grid& g,
                             bool vec, cudaStream_t s) {
#define SCSO_Q(QV)                                                         \
  case QV:                                                                 \
    if constexpr (has_bucket<S, T, NC>(QV))                                \
      return launch_onepass<S, T, NC, F, QV>(A, y, p, partials,            \
                                             loss_partials, m, n, m_norm,  \
                                             g, vec, s);                   \
    break;
  switch (g.q) {
    SCSO_Q(1) SCSO_Q(2) SCSO_Q(3) SCSO_Q(4) SCSO_Q(5) SCSO_Q(6) SCSO_Q(7)
    SCSO_Q(8) SCSO_Q(10) SCSO_Q(12) SCSO_Q(14)
    default:
      break;
  }
#undef SCSO_Q
  return cudaErrorInvalidValue;
}

// The cluster form's instances: A in bfloat16, float32 compute, group_rows
// 8 or 16, one chunk a thread (q == 1), stages >= 3 (the ring holds a
// group from its dots to its sums, one group apart, and loads ahead)
template <typename S, typename T, int NC, RowOut F>
cudaError_t dispatch_cluster(const S* A, const T* y, const Prep<T, NC>& p,
                             T* partials, double* loss_partials, int64_t m,
                             int64_t n, int64_t m_norm, const Grid& g,
                             bool vec, cudaStream_t s) {
  if constexpr (std::is_same_v<S, __nv_bfloat16> && std::is_same_v<T, float>) {
    if (g.q != 1 || g.stages < 3) return cudaErrorInvalidValue;
    if (g.group_rows == 8)
      return cl_form::launch<T, NC, F, 8>(
          A, y, p, partials, loss_partials, m, n, m_norm, g.kind, g.blocks,
          g.cluster, g.rows_per_block, g.threads, g.smem, g.stages, vec, s);
    if (g.group_rows == 16)
      return cl_form::launch<T, NC, F, 16>(
          A, y, p, partials, loss_partials, m, n, m_norm, g.kind, g.blocks,
          g.cluster, g.rows_per_block, g.threads, g.smem, g.stages, vec, s);
  }
  return cudaErrorInvalidValue;
}

// phase 0: the whole wide form in flavour F; 1: its rows pass with z
// alone (split form); 2: its columns pass (split form)
template <typename S, typename T, bool VEC, int NC, RowOut F>
cudaError_t launch_wide(const S* A, const T* y, const Prep<T, NC>& p, T* rw,
                        double* col_partials, double* loss_partials,
                        int64_t m, int64_t n, int64_t m_norm, const Grid& g,
                        int64_t phase, cudaStream_t s) {
  const unsigned rb = static_cast<unsigned>(g.row_blocks);
  if (phase == 0)
    glm_rows<S, T, VEC, NC, F><<<rb, kThreads, 0, s>>>(A, y, p, rw,
                                                       loss_partials, m, n,
                                                       m_norm, g.kind);
  if (phase == 1)
    glm_rows<S, T, VEC, NC, kZ><<<rb, kThreads, 0, s>>>(A, y, p, rw, nullptr,
                                                        m, n, m_norm, g.kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || phase == 1) return err;
  const int64_t nc = n / Wide<S, T, VEC>::E;
  const int64_t col_tiles = (nc + kThreads - 1) / kThreads;
  glm_cols<S, T, VEC, NC><<<dim3(static_cast<unsigned>(col_tiles),
                                 static_cast<unsigned>(g.blocks)), kThreads, 0,
                            s>>>(A, p, rw, col_partials, m, n,
                                 g.rows_per_block);
  return cudaGetLastError();
}

// phase 0: the whole prep (g.kind in flavour F; one-pass form where
// g.q > 0, else wide); 1 and 2: the split form's two calls (g is a wide
// grid; F and g.kind do not enter them)
template <typename S, typename T, int NC, RowOut F>
int launch(const void* A, const void* y, const Prep<T, NC>& p, void* rw,
           void* partials, void* loss_partials, int64_t m, int64_t n,
           int64_t m_norm, const Grid& g, int64_t phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  // 16-byte chunks need every row of A, and every candidate, 16-byte
  // aligned
  bool vec = n % (16 / sizeof(S)) == 0 && aligned(A);
  for (int c = 0; c < NC; ++c) vec = vec && aligned(p.x[c]);
  const S* a = static_cast<const S*>(A);
  const T* y_ = static_cast<const T*>(y);
  double* lp = static_cast<double*>(loss_partials);
  cudaError_t err;
  if (phase < 0 || phase > 2 || (phase > 0 && (g.q > 0 || g.cluster > 0)) ||
      (phase == 0 && (g.kind < kLogistic01 || g.kind > kPoisson))) {
    err = cudaErrorInvalidValue;
  } else if (g.cluster > 0) {
    err = dispatch_cluster<S, T, NC, F>(a, y_, p, static_cast<T*>(partials),
                                        lp, m, n, m_norm, g, vec, s);
  } else if (g.q > 0) {
    err = dispatch_onepass<S, T, NC, F>(a, y_, p, static_cast<T*>(partials),
                                        lp, m, n, m_norm, g, vec, s);
  } else {
    auto wide = vec ? &launch_wide<S, T, true, NC, F>
                    : &launch_wide<S, T, false, NC, F>;
    err = wide(a, y_, p, static_cast<T*>(rw), static_cast<double*>(partials),
               lp, m, n, m_norm, g, phase, s);
  }
  if (err != cudaSuccess || phase == 1) return static_cast<int>(err);
  const unsigned fin =
      static_cast<unsigned>((2 * NC * n + kFinThreads - 1) / kFinThreads);
  if (g.q > 0 || g.cluster > 0) {
    glm_finalize<T, T, NC><<<fin, kFinThreads, 0, s>>>(
        static_cast<const T*>(partials), lp, p, n, g.blocks, g.row_blocks);
  } else {
    glm_finalize<T, double, NC><<<fin, kFinThreads, 0, s>>>(
        static_cast<const double*>(partials), lp, p, n, g.blocks,
        phase == 0 ? g.row_blocks : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: both candidates, with their loss sums, in flavour F (the _newton
// entries: ProxNSCORE's cache) for the spec ``kind`` (Kind), A in S and
// the rest in T. ``rw`` (2, m)
// is the wide form's scratch for ρ (unused by the one-pass form; the
// split form's z, then its ρ); ``partials`` are (blocks, 4, n) in T
// (one-pass) or double (wide, split); ``loss_partials`` (row_blocks, 2)
// double; ``phase`` 0 for the one-pass and wide forms, 1 and 2 for the
// split form's calls (its loss sums, written as 0 here, are the
// wrapper's).
#define SCSO_GLM_PAIR_ENTRY(NAME, S, T, F)                                  \
  extern "C" int NAME(const void* A, const void* y, const void* xt,         \
                      const void* xd, void* wt, void* wd, void* rw,         \
                      void* bt, void* bd, void* ht, void* hd, void* lt,     \
                      void* ld, void* partials, void* loss_partials,        \
                      int64_t m, int64_t n, int64_t m_norm, int64_t kind,   \
                      int64_t blocks, int64_t rows_per_block, int64_t smem, \
                      int64_t threads, int64_t q, int64_t row_blocks,       \
                      int64_t cluster, int64_t stages, int64_t group_rows,  \
                      int64_t phase, void* stream) {                        \
    const Prep<T, 2> p{                                                     \
        {static_cast<const T*>(xt), static_cast<const T*>(xd)},             \
        {static_cast<T*>(wt), static_cast<T*>(wd)},                         \
        {static_cast<T*>(bt), static_cast<T*>(bd)},                         \
        {static_cast<T*>(ht), static_cast<T*>(hd)},                         \
        {static_cast<T*>(lt), static_cast<T*>(ld)}};                        \
    return launch<S, T, 2, F>(A, y, p, rw, partials, loss_partials, m, n,   \
                              m_norm,                                       \
                              Grid{blocks, rows_per_block, smem, threads,   \
                                   q, row_blocks, cluster, stages,          \
                                   group_rows, static_cast<int>(kind)},     \
                              phase, stream);                               \
  }

// K2s: one candidate, no loss, for the spec ``kind``, A in S. ``rw``
// (m,) is the wide form's
// scratch (the split form's z, then its ρ); ``partials`` (blocks, 2, n)
// in T (one-pass) or double (wide, split); ``phase`` as K2's.
#define SCSO_GLM_PREP_ENTRY(NAME, S, T)                                     \
  extern "C" int NAME(const void* A, const void* y, const void* x, void* w, \
                      void* rw, void* b, void* hd, void* partials,          \
                      int64_t m, int64_t n, int64_t m_norm, int64_t kind,   \
                      int64_t blocks, int64_t rows_per_block, int64_t smem, \
                      int64_t threads, int64_t q, int64_t row_blocks,       \
                      int64_t cluster, int64_t stages, int64_t group_rows,  \
                      int64_t phase, void* stream) {                        \
    const Prep<T, 1> p{{static_cast<const T*>(x)}, {static_cast<T*>(w)},    \
                       {static_cast<T*>(b)}, {static_cast<T*>(hd)},         \
                       {nullptr}};                                          \
    return launch<S, T, 1, kGGN>(A, y, p, rw, partials, nullptr, m, n,      \
                                 m_norm,                                    \
                                 Grid{blocks, rows_per_block, smem,         \
                                      threads, q, row_blocks, cluster,      \
                                      stages, group_rows,                   \
                                      static_cast<int>(kind)},              \
                                 phase, stream);                            \
  }
