// K5: fused multi-output GGN matvec  out = Aᵀ·quad(Z, A·V).
//
// Replaces the TPU kernel scso_tpu/ops/pallas/mglm_matvec.py:152
// (_fused_mglm_matvec), which keeps a row tile of A in VMEM for both
// contractions and traces the spec's Python `quad` into its body. CUDA
// cannot trace Python, so the one-read forms below are specialised on
// the multinomial spec (MOGLMSpec.kind == 'multinomial'), with 1/m
// folded in:
//   P_i  = softmax(Z_i)                      (max-subtracted, over k)
//   U_i  = A_i · V                           (k values)
//   QU_i = (P_i∘U_i − P_i·Σ_c P_ic U_ic) / m
//   out  = Σ_i A_iᵀ · QU_i                   (p × k)
// and any other spec runs the split form: the two passes over A here,
// the spec's own quad in PyTorch between them (the wrapper). It runs
// once per CG iteration on the multinomial path.
//
// What bounds it on the H100: at 196608×1024×16 f32 a call reads 0.81 GB
// of A (0.24 ms at the data sheet's 3.35 TB/s) and does 4·m·p·k = 12.9
// GFLOP, 0.19 ms at 67 TFLOP/s on the CUDA cores: as FP32 FMAs the two
// floors are close, and a CUDA-core form, whose cross-warp reduction of
// U and softmax (repeated by every warp) sat on top of the FMAs at 8
// warps an SM, took ~0.86 ms (PERF.md).
//
// Tensor-core form (f32, k <= 16, p <= 1024; the wrapper's mglm_grid
// picks it). Both contractions run on the tensor cores as mma.sync
// m16n8k8 TF32 with f32 accumulators, in split TF32: each operand x =
// hi + lo with hi the TF32 part of x and lo = x − hi, and a product is
// hi·hi + hi·lo + lo·hi (the lo·lo term is below f32's last bit), so
// float32 accuracy holds where one TF32 product would keep about three
// digits. 3 × 12.9 GFLOP at 495 TFLOP/s is ~0.08 ms, so the form is
// bound by A's bytes. One block of 16 warps an SM (8 at p <= 128) owns a
// contiguous row range and walks it in tiles of 16 rows:
//   * warp w owns columns [w·16·MT, (w+1)·16·MT) of A in both
//     contractions, so it copies just those columns of each tile to
//     shared memory by cp.async (16-byte copies where A's rows are
//     16-byte aligned, else 4-byte ones), two stages (the next tile
//     loads while this one is used; 64 KB a stage at p = 1024), and
//     waits for and frees a stage by itself: no block barrier guards
//     the stages. Each 16-byte chunk sits at a swizzled slot, so the
//     fragment loads of both contractions are free of bank conflicts.
//     A is read from device memory once, and the tile serves both
//     contractions;
//   * V sits in shared memory in the warps' fragment order (64 KB). Its
//     split is redone at every tile: split V (hi and lo, 128 KB) and two
//     stages do not fit the 227 KB, nor its fragments the 128 registers
//     a thread of a 512-thread block may hold;
//   * U_b = A_b·V: each warp's partial over its columns goes to shared
//     memory, and after a barrier a group of k lanes a row adds the
//     warps' partials in a fixed order and evaluates the softmax
//     curvature once a row, writing QU in fragment order;
//   * after a second barrier, acc += A_bᵀ·QU_b from the same tile: the
//     (p × k) accumulators stay in registers, spread over the warps by
//     column, for the whole row range.
// Two-pass form (f64, which only serves the small float64 solves, and
// any k > 16 or p > 1024; reads A twice): a row kernel (one warp per
// row, classes in chunks of 16, V given transposed by the wrapper)
// writes U and then QU (m × k) to a scratch buffer, then a column kernel
// (thread per column, 16 classes, a row chunk per block) forms Aᵀ·QU.
// Split form (any spec other than the multinomial, any k, p and type):
// the row kernel writes U alone, the wrapper applies the spec's quad to
// it, and the column kernel forms Aᵀ·QU.
// Every form writes per-block (p × k) partials that sum_partials adds in
// a fixed order in double: no float atomics, bitwise-equal reruns.
//
// A stored in bfloat16 (S = __nv_bfloat16; y, Z, V, QU and the output in
// T, float or double): the coarse phase of iterate_mixed and the copy of
// precision-adaptive CG on the cached path (steps._mo_lp_matvec). The TPU
// kernel upcasts each tile (mglm_matvec.py:97 and :126); every form here
// takes A's values upcast exactly, so the function is the one of A
// upcast. The two-pass and split forms read A one value at a time and
// upcast it.
//
// Tensor-core form with A in bfloat16 (namespace tcb; f32, k <= 16,
// p <= 1024). It bounds by the same bytes, halved: 0.1277 ms at
// 196608×1024×16. Its earlier form, the f32 form with a bfloat16 stage
// (two TF32 mma.sync a product), reached 41% of that (0.3147 ms on an
// H100 80GB HBM3 at 700 W, PERF.md): what a tile costs beside its bytes
// did not halve — V split again at every tile, each value of A a 16-bit
// shared load and a shift, Z's load of the tile between the tile's two
// barriers, two stages a warp filled by cp.async. This form:
//   * takes A as stored, the bfloat16 operand of mma.sync.m16n8k16, its
//     fragments by ldmatrix (ldmatrix.trans for Aᵀ·QU); the f32 operand
//     is three bfloat16 pieces hi + mid + lo, each the rounding of what
//     the earlier leave (split3): 24 significant bits, f32's own, and
//     each product is exact in the f32 accumulators, so three mma a
//     product keep float32 accuracy at twice TF32's instruction rate;
//   * splits V once a call, into shared memory in fragment order (96 KB
//     at p = 1024, k = 16), and QU once a tile, in the softmax;
//   * streams A through a ring of 3 to 6 stages of 16 rows (as many as
//     fit beside V's pieces), a cp.async.bulk copy a row issued by one
//     thread on the stage's mbarrier; rows are padded by 16 bytes, so a
//     tile's 8 rows of one 16-byte column chunk fall on 8 distinct bank
//     quads and ldmatrix reads without conflicts (rows that are not
//     16-byte aligned, p % 8 != 0, are staged a value at a time by the
//     warp that reads them);
//   * loads Z a tile ahead, and runs 3 blocks an SM at p <= 128 and 2 at
//     p <= 256 (tc_blocks_per_sm), where the registers allow.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;   // two-pass row kernel: warps per block
constexpr int kColThreads = 256;
constexpr int kKC = 16;        // two-pass: classes per chunk

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -CUDART_INF_F;
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -CUDART_INF;
}

// ---------------------------------------------------------------------------
// tensor-core form (f32)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 16;  // rows of a tile (the m of one mma)

// x = hi + lo: hi is x with the 13 mantissa bits below TF32's cleared
// (a TF32 value), lo = x − hi exactly; the tensor core reads lo's top
// TF32 bits. Rounding both with cvt.rna.tf32 instead was slower at the
// bench shape, for the same error.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a·b on one m16n8k8 TF32 tile (f32 accumulators)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in split TF32, a from A, b = (b0, b1) of a float operand:
// the small terms first, then hi·hi (lo·lo is below f32's last bit)
template <typename S>
__device__ __forceinline__ void mma_a(float (&c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// A value of a stage as a TF32 operand, hi + lo
__device__ __forceinline__ void frag(float a, uint32_t& hi, uint32_t& lo) {
  split(a, hi, lo);
}

// The 16-byte chunk q of row r sits at chunk q ^ swz(r & 7). Both
// contractions' fragment loads then hit 32 distinct banks: the first
// reads rows g = 0..7 at one chunk pair (swz is a permutation of 0..7),
// the second rows t4 = 0..3 (or 4..7) at chunks {q, q+1}, q even
// (swz(r) >> 1 is a permutation of 0..3 on each half).
__device__ __forceinline__ int swz(int r) {
  return ((r & 3) << 1) | ((r >> 2) & 1);
}

// values of A a 16-byte chunk
template <typename S>
constexpr int kChunk = 16 / static_cast<int>(sizeof(S));

template <typename S, int PP>
__device__ __forceinline__ int a_off(int r, int j) {
  constexpr int C = kChunk<S>, L = C == 4 ? 2 : 3;
  return r * PP + (((j >> L) ^ swz(r & 7)) << L) + (j & (C - 1));
}

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: fill the chunk with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// one value, for rows that are not 16-byte aligned: a 4-byte cp.async,
// visible to the warp after its next __syncwarp
__device__ __forceinline__ void cp1(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows [r0, r0 + 16) of the warp's 16·MT columns from wc on, into a
// stage (zeros past r_end and past p): each warp copies the columns it
// alone reads, so a stage is waited for and reused warp by warp. ``vec``
// (A's rows 16-byte aligned, so p % kChunk == 0): 16-byte copies, else
// one value a copy, to the same slots.
template <typename S, int PP, int MT>
__device__ __forceinline__ void load_cols(S* stage, const S* __restrict__ A,
                                          int64_t r0, int64_t r_end, int p,
                                          int wc, int lane, bool vec) {
  constexpr int C = kChunk<S>;
  if (vec) {
    constexpr int QW = 16 * MT / C;  // 16-byte chunks of a row of the warp's
    for (int e = lane; e < kRows * QW; e += 32) {
      const int r = e / QW, q = wc / C + e - r * QW;
      const int64_t i = r0 + r;
      const bool pred = i < r_end && q * C < p;
      cp16(reinterpret_cast<float*>(stage + r * PP + (q ^ swz(r & 7)) * C),
           reinterpret_cast<const float*>(pred ? A + i * p + q * C : A),
           pred);
    }
  } else {
    constexpr int CW = 16 * MT;  // columns of the warp
    for (int e = lane; e < kRows * CW; e += 32) {
      const int r = e / CW, j = wc + e - r * CW;
      const int64_t i = r0 + r;
      const bool pred = i < r_end && j < p;
      cp1(stage + a_off<S, PP>(r, j), pred ? A + i * p + j : A, pred);
    }
  }
}

// W warps, each owning 16·MT columns; NT n8 tiles of classes. Shared
// memory: two stages of kRows × PP values of A (in S); then, in floats,
// V in fragment order [PP/8 k-steps][NT][32 lanes][2]; the warps'
// partial U [W][kRows][8·NT]; QU in fragment order [2][NT][32][2].
template <typename S, int W, int MT, int NT>
constexpr size_t smem_bytes() {
  constexpr int PP = W * MT * 16;
  return sizeof(S) * 2 * kRows * PP +
         sizeof(float) * (PP * NT * 8 + W * kRows * 8 * NT + 2 * NT * 32 * 2);
}

template <typename S, int W, int MT, int NT>
__global__ void __launch_bounds__(W * 32, 1)
mglm_tc(const S* __restrict__ A, const float* __restrict__ Z,
        const float* __restrict__ V, float* __restrict__ partials,
        int64_t m, int p, int k, int64_t rows_per_block, bool vec) {
  constexpr int PP = W * MT * 16;  // columns of a stage: p padded
  constexpr int KS = 2 * MT;       // k8 steps over a warp's columns
  constexpr int KB = 8 * NT;       // classes, padded
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* stages = reinterpret_cast<S*>(smem_raw);
  float* vf = reinterpret_cast<float*>(stages + 2 * kRows * PP);
  float* red = vf + PP * NT * 8;
  float* qf = red + W * kRows * KB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp * MT * 16;  // the warp's first column

  // V (p × k), the B operand of the first contraction (k-step rows j,
  // columns c), into the warp's fragment order once a call
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = wc + ks * 8 + t4 + 4 * h, c = nt * 8 + g;
        vf[(((warp * KS + ks) * NT + nt) * 32 + lane) * 2 + h] =
            (j < p && c < k) ? V[static_cast<int64_t>(j) * k + c] : 0.f;
      }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_block);
  const int64_t tiles = (r_end - r_begin + kRows - 1) / kRows;
  load_cols<S, PP, MT>(stages, A, r_begin, r_end, p, wc, lane, vec);
  cp_commit();
  if (tiles > 1)
    load_cols<S, PP, MT>(stages + kRows * PP, A, r_begin + kRows, r_end, p,
                         wc, lane, vec);
  cp_commit();

  // the softmax: thread (sr, sc) for row sr and class sc, KB lanes a row
  const int sr = tid / KB, sc = tid % KB;
  const bool soft = tid < kRows * KB;  // warp-uniform

  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t r0 = r_begin + t * kRows;
    const S* as = stages + (t & 1) * kRows * PP;
    const bool live = soft && sc < k && r0 + sr < r_end;
    const float z = live ? Z[(r0 + sr) * k + sc] : neg_inf<float>();
    cp_wait_all_but_one();  // this thread's copies of tile t
    __syncwarp();           // the warp's: all it reads of the tile

    // U_b = A_b·V over the warp's columns; two accumulator sets halve
    // the dependent chain
    float u[2][NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[h][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int jb = wc + ks * 8;
      uint32_t ah[4], al[4];
      frag(as[a_off<S, PP>(g, jb + t4)], ah[0], al[0]);
      frag(as[a_off<S, PP>(g + 8, jb + t4)], ah[1], al[1]);
      frag(as[a_off<S, PP>(g, jb + t4 + 4)], ah[2], al[2]);
      frag(as[a_off<S, PP>(g + 8, jb + t4 + 4)], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(
            &vf[(((warp * KS + ks) * NT + nt) * 32 + lane) * 2]);
        mma_a<S>(u[ks & 1][nt], ah, al, v.x, v.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRows + g + 8 * (e >> 1)) * KB + nt * 8 + 2 * t4 +
            (e & 1)] = u[0][nt][e] + u[1][nt][e];
    __syncthreads();

    // the softmax curvature, once a row, into QU's fragments
    if (soft) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s += red[(w * kRows + sr) * KB + sc];
      const float zmax = scso::group_max<KB>(z);
      const float ez = live ? scso::dexp(z - zmax) : 0.f;
      const float den = scso::group_sum<KB>(ez);
      const float P = live ? ez / den : 0.f;
      const float pu = P * s;
      const float spu = scso::group_sum<KB>(pu);
      const float q = live ? (pu - P * spu) / static_cast<float>(m) : 0.f;
      // B fragment of k-step sr / 8: b0 (row t4), b1 (row t4 + 4), col g
      const int rr = sr & 7;
      qf[(((sr >> 3) * NT + (sc >> 3)) * 32 + (sc & 7) * 4 + (rr & 3)) * 2 +
         (rr >> 2)] = q;
    }
    __syncthreads();

    // acc += A_bᵀ·QU_b: the warp's columns are the m of the mma
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      float2 qv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        qv[nt] = *reinterpret_cast<const float2*>(
            &qf[((k2 * NT + nt) * 32 + lane) * 2]);
      const int rr = k2 * 8 + t4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int j0 = wc + mt * 16;
        uint32_t ah[4], al[4];
        frag(as[a_off<S, PP>(rr, j0 + g)], ah[0], al[0]);
        frag(as[a_off<S, PP>(rr, j0 + g + 8)], ah[1], al[1]);
        frag(as[a_off<S, PP>(rr + 4, j0 + g)], ah[2], al[2]);
        frag(as[a_off<S, PP>(rr + 4, j0 + g + 8)], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_a<S>(acc[mt][nt], ah, al, qv[nt].x, qv[nt].y);
      }
    }
    __syncwarp();  // the warp's columns of the stage are free
    if (t + 2 < tiles)
      load_cols<S, PP, MT>(stages + (t & 1) * kRows * PP, A, r0 + 2 * kRows,
                           r_end, p, wc, lane, vec);
    cp_commit();  // possibly empty: keeps the wait's count
  }

  float* dst = partials + static_cast<int64_t>(blockIdx.x) * p * k;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = wc + mt * 16 + g + 8 * (e >> 1);
        const int c = nt * 8 + 2 * t4 + (e & 1);
        if (j < p && c < k)
          dst[static_cast<int64_t>(j) * k + c] = acc[mt][nt][e];
      }
}

template <typename S, int W, int MT, int NT>
cudaError_t launch_wmt(const S* A, const float* Z, const float* V,
                       float* partials, int64_t m, int p, int k,
                       int64_t nblk, int64_t rows_per_block, bool vec,
                       cudaStream_t s) {
  constexpr size_t smem = smem_bytes<S, W, MT, NT>();
  auto kernel = mglm_tc<S, W, MT, NT>;
  cudaError_t err = scso::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nblk), W * 32, smem, s>>>(
      A, Z, V, partials, m, p, k, rows_per_block, vec);
  return cudaGetLastError();
}

// p padded to 128 (8 warps of 16 columns), 256 (16 warps of 16), 512
// (16 of 32) or 1024 (16 of 64); the wrapper's tc_geometry
template <typename S, int NT>
cudaError_t launch_nt(const S* A, const float* Z, const float* V,
                      float* partials, int64_t m, int p, int k, int64_t nblk,
                      int64_t rows, bool vec, cudaStream_t s) {
  if (p <= 128)
    return launch_wmt<S, 8, 1, NT>(A, Z, V, partials, m, p, k, nblk, rows,
                                   vec, s);
  if (p <= 256)
    return launch_wmt<S, 16, 1, NT>(A, Z, V, partials, m, p, k, nblk, rows,
                                    vec, s);
  if (p <= 512)
    return launch_wmt<S, 16, 2, NT>(A, Z, V, partials, m, p, k, nblk, rows,
                                    vec, s);
  return launch_wmt<S, 16, 4, NT>(A, Z, V, partials, m, p, k, nblk, rows,
                                  vec, s);
}

// k <= 16, p <= 1024 (the wrapper's mglm_grid)
template <typename S>
cudaError_t launch(const S* A, const float* Z, const float* V,
                   float* partials, int64_t m, int p, int k, int64_t nblk,
                   int64_t rows_per_block, cudaStream_t s) {
  if (k > 16 || p > 1024) return cudaErrorInvalidValue;
  const bool vec =
      p % kChunk<S> == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  return k <= 8 ? launch_nt<S, 1>(A, Z, V, partials, m, p, k, nblk,
                                  rows_per_block, vec, s)
                : launch_nt<S, 2>(A, Z, V, partials, m, p, k, nblk,
                                  rows_per_block, vec, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// tensor-core form, A in bfloat16 (float32 compute)
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int kRows = 16;      // rows of a tile (the m, then the k, of an mma)
constexpr int kMaxStages = 6;  // the ring's most stages
constexpr int kSmemBudget = 232448;  // the most a block may take (H100)

// Shared memory, in order: the ring of S stages of kRows rows of A, each
// row PP + 8 values (the 16 bytes of padding put a tile's 8 rows of one
// 16-byte column chunk on 8 distinct bank quads, so ldmatrix is free of
// conflicts in both contractions); V's three bfloat16 pieces in the B
// fragment order of the first contraction [3][PP/16][NT][32 lanes][2
// words]; the warps' partial U [W][kRows][8·NT] floats; QU's three pieces
// in the B fragment order of the second [3][NT][32][2 words]; one
// mbarrier a stage.
template <int W, int MT, int NT>
__host__ __device__ constexpr int stage_bytes() {
  return kRows * (W * MT * 16 + 8) * 2;
}
template <int W, int MT, int NT>
__host__ __device__ constexpr int fixed_bytes() {
  constexpr int PP = W * MT * 16;
  return 3 * (PP / 16) * NT * 32 * 2 * 4 + W * kRows * 8 * NT * 4 +
         3 * NT * 32 * 2 * 4;
}
// the most stages (at most kMaxStages) that fit the budget
template <int W, int MT, int NT>
__host__ __device__ constexpr int stages() {
  constexpr int s = (kSmemBudget - fixed_bytes<W, MT, NT>() - 8 * kMaxStages) /
                    stage_bytes<W, MT, NT>();
  return s < kMaxStages ? s : kMaxStages;
}
template <int W, int MT, int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(stages<W, MT, NT>()) * stage_bytes<W, MT, NT>() +
         fixed_bytes<W, MT, NT>() + 8 * stages<W, MT, NT>();
}

// c += a·b on one m16n8k16 bfloat16 tile (f32 accumulators)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four 8×8 matrices of 16-bit values at the lanes' row addresses
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(s));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(s));
  }
}

// x = hi + mid + lo in bfloat16, each the rounding of what the earlier
// ones leave (exact differences): 24 significant bits, float32's own, so
// a product with a bfloat16 value of A, exact in the f32 accumulators,
// keeps float32 accuracy
__device__ __forceinline__ void split3(float x, unsigned short (&v)[3]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(h);
  const __nv_bfloat16 md = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l = __float2bfloat16_rn(r1 - __bfloat162float(md));
  v[0] = __bfloat16_as_ushort(h);
  v[1] = __bfloat16_as_ushort(md);
  v[2] = __bfloat16_as_ushort(l);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// W warps, each owning 16·MT columns of A in both contractions; NT n8
// tiles of classes. VEC: A's rows 16-byte aligned (p % 8 == 0), tiles
// through the ring by cp.async.bulk, one copy a row, issued by thread 0
// on the stage's mbarrier; else each warp stages its own columns a value
// at a time (plain loads), no barrier guarding them.
// blocks an SM the bfloat16 form is built for (its registers; the
// wrapper's tc_blocks_per_sm): 3 of 8 warps (p <= 128), 2 of 16 warps
// of 16 columns (p <= 256), else 1
__host__ __device__ constexpr int blocks_per_sm(int w, int mt) {
  return w == 8 ? 3 : mt == 1 ? 2 : 1;
}

template <int W, int MT, int NT, bool VEC>
__global__ void __launch_bounds__(W * 32, blocks_per_sm(W, MT))
mglm_tcb(const __nv_bfloat16* __restrict__ A, const float* __restrict__ Z,
         const float* __restrict__ V, float* __restrict__ partials, int64_t m,
         int p, int k, int64_t rows_per_block) {
  constexpr int PP = W * MT * 16;  // columns of a stage: p padded
  constexpr int RS = PP + 8;       // a stage row, in values
  constexpr int KB = 8 * NT;       // classes, padded
  constexpr int S = stages<W, MT, NT>();
  static_assert(S >= 3, "the refill lags a tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uint32_t* vf = reinterpret_cast<uint32_t*>(smem_raw +
                                             S * stage_bytes<W, MT, NT>());
  float* red = reinterpret_cast<float*>(vf + 3 * (PP / 16) * NT * 32 * 2);
  uint32_t* qf = reinterpret_cast<uint32_t*>(red + W * kRows * KB);
  uint64_t* full = reinterpret_cast<uint64_t*>(qf + 3 * NT * 32 * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = W * 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp * MT * 16;  // the warp's first column
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_block);
  const int64_t tiles = (r_end - r_begin + kRows - 1) / kRows;

  // tile t into stage t % S: one bulk copy a live row (VEC, lane 0 of
  // the last warp)
  auto issue = [&](int64_t t) {
    const int s = static_cast<int>(t % S);
    const int64_t r0 = r_begin + t * kRows;
    const int rows = static_cast<int>(scso::imin(kRows, r_end - r0));
    const unsigned bytes = static_cast<unsigned>(p) * 2;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            saddr(&full[s])),
        "r"(bytes * rows)
        : "memory");
    for (int r = 0; r < rows; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(
              saddr(ring + (static_cast<int64_t>(s) * kRows + r) * RS)),
          "l"(A + (r0 + r) * p), "r"(bytes), "r"(saddr(&full[s]))
          : "memory");
  };

  // the ring zeroed (its padding, and the rows past r_end, are never
  // copied: they must hold finite values), then the first S tiles
  {
    uint4* z4 = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < S * stage_bytes<W, MT, NT>() / 16; i += nthr)
      z4[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (VEC && tid == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       saddr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // V (p × k) in three pieces, the B operand of the first contraction:
  // word h of lane (g, t4) at k-step ks, n8 tile nt holds rows j = ks·16 +
  // 2·t4 + 8·h and j + 1 of column nt·8 + g
  {
    unsigned short* vs = reinterpret_cast<unsigned short*>(vf);
    constexpr int per_piece = (PP / 16) * NT * 32 * 4;  // 16-bit values
    for (int e = tid; e < per_piece; e += nthr) {
      const int half = e & 1, h = (e >> 1) & 1, ln = (e >> 2) & 31;
      const int nt = (e >> 7) % NT, ks = (e >> 7) / NT;
      const int j = ks * 16 + 2 * (ln & 3) + 8 * h + half;
      const int c = nt * 8 + (ln >> 2);
      unsigned short v3[3];
      split3((j < p && c < k) ? V[static_cast<int64_t>(j) * k + c] : 0.f, v3);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) vs[pc * per_piece + e] = v3[pc];
    }
  }
  __syncthreads();  // the ring zeroed, the barriers set, V's pieces in
  if (VEC && tid == nthr - 32)
    for (int64_t t = 0; t < scso::imin(S, tiles); ++t) issue(t);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the softmax: thread (sr, sc) for row sr and class sc, KB lanes a row
  const int sr = tid / KB, sc = tid % KB;
  const bool soft = tid < kRows * KB;  // warp-uniform
  // ldmatrix row addresses: matrix lane >> 3, its row lane & 7
  const int mi = lane >> 3, lr = lane & 7;

  // Z of the next tile loads while this one is worked on (its latency
  // would otherwise sit between the two barriers of every tile)
  auto z_of = [&](int64_t t) {
    const int64_t i = r_begin + t * kRows + sr;
    return soft && sc < k && t < tiles && i < r_end ? Z[i * k + sc]
                                                    : neg_inf<float>();
  };
  float z_next = z_of(0);
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t r0 = r_begin + t * kRows;
    const int s = static_cast<int>(t % S);
    const __nv_bfloat16* as = ring + static_cast<int64_t>(s) * kRows * RS;
    const bool live = soft && sc < k && r0 + sr < r_end;
    const float z = z_next;
    z_next = z_of(t + 1);
    if constexpr (VEC) {
      mbar_wait(&full[s], static_cast<unsigned>((t / S) & 1));
    } else {
      // the warp's columns of this tile, zeros past r_end and past p
      __nv_bfloat16* st = ring + static_cast<int64_t>(s) * kRows * RS;
      for (int e = lane; e < kRows * 16 * MT; e += 32) {
        const int r = e / (16 * MT), j = wc + e % (16 * MT);
        const bool pred = r0 + r < r_end && j < p;
        st[r * RS + j] = pred ? A[(r0 + r) * p + j] : __ushort_as_bfloat16(0);
      }
      __syncwarp();
    }

    // U_b = A_b·V over the warp's columns, the small pieces first; two
    // accumulator sets halve the dependent chain
    float u[2][NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[h][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      uint32_t a[4];
      ldsm4<false>(a, as + (lr + 8 * (mi & 1)) * RS + wc + ks * 16 +
                          8 * (mi >> 1));
      const int kg = warp * MT + ks;  // the k-step among all of V's
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int pc = 2; pc >= 0; --pc) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              &vf[(((pc * (PP / 16) + kg) * NT + nt) * 32 + lane) * 2]);
          mma(u[ks & 1][nt], a, b.x, b.y);
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRows + g + 8 * (e >> 1)) * KB + nt * 8 + 2 * t4 +
            (e & 1)] = u[0][nt][e] + u[1][nt][e];
    __syncthreads();
    // every warp is past the tile before: its stage may be refilled (by
    // the last warp, which takes no part in the softmax when W > 8)
    if (VEC && tid == nthr - 32 && t >= 1 && t - 1 + S < tiles)
      issue(t - 1 + S);

    // the softmax curvature, once a row, into QU's three pieces in the
    // B fragment order of the second contraction: word h of lane (g, t4)
    // holds rows 2·t4 + 8·h and + 1 of class nt·8 + g
    if (soft) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) sum += red[(w * kRows + sr) * KB + sc];
      const float zmax = scso::group_max<KB>(z);
      const float ez = live ? scso::dexp(z - zmax) : 0.f;
      const float den = scso::group_sum<KB>(ez);
      const float P = live ? ez / den : 0.f;
      const float pu = P * sum;
      const float spu = scso::group_sum<KB>(pu);
      const float q = live ? (pu - P * spu) / static_cast<float>(m) : 0.f;
      unsigned short q3[3];
      split3(q, q3);
      const int ln = (sc & 7) * 4 + ((sr & 7) >> 1);
      const int idx = ((sc >> 3) * 32 + ln) * 4 + (sr >> 3) * 2 + (sr & 1);
      unsigned short* qs = reinterpret_cast<unsigned short*>(qf);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) qs[pc * NT * 32 * 4 + idx] = q3[pc];
    }
    __syncthreads();

    // acc += A_bᵀ·QU_b: the warp's columns are the m of the mma, the
    // tile's 16 rows its k (ldmatrix.trans), the small pieces first
    uint2 qv[3][NT];
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        qv[pc][nt] = *reinterpret_cast<const uint2*>(
            &qf[((pc * NT + nt) * 32 + lane) * 2]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm4<true>(a, as + (lr + 8 * (mi >> 1)) * RS + wc + mt * 16 +
                         8 * (mi & 1));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int pc = 2; pc >= 0; --pc)
          mma(acc[mt][nt], a, qv[pc][nt].x, qv[pc][nt].y);
    }
    if constexpr (!VEC) __syncwarp();  // the warp's columns are free
  }

  float* dst = partials + static_cast<int64_t>(blockIdx.x) * p * k;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = wc + mt * 16 + g + 8 * (e >> 1);
        const int c = nt * 8 + 2 * t4 + (e & 1);
        if (j < p && c < k)
          dst[static_cast<int64_t>(j) * k + c] = acc[mt][nt][e];
      }
}

template <int W, int MT, int NT>
cudaError_t launch_wmt(const __nv_bfloat16* A, const float* Z, const float* V,
                       float* partials, int64_t m, int p, int k, int64_t nblk,
                       int64_t rows_per_block, bool vec, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<W, MT, NT>();
  auto kernel = vec ? mglm_tcb<W, MT, NT, true> : mglm_tcb<W, MT, NT, false>;
  cudaError_t err = scso::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nblk), W * 32, smem, s>>>(
      A, Z, V, partials, m, p, k, rows_per_block);
  return cudaGetLastError();
}

// the padded p of tc::launch_nt (the wrapper's tc_geometry)
template <int NT>
cudaError_t launch_nt(const __nv_bfloat16* A, const float* Z, const float* V,
                      float* partials, int64_t m, int p, int k, int64_t nblk,
                      int64_t rows, bool vec, cudaStream_t s) {
  if (p <= 128)
    return launch_wmt<8, 1, NT>(A, Z, V, partials, m, p, k, nblk, rows, vec,
                                s);
  if (p <= 256)
    return launch_wmt<16, 1, NT>(A, Z, V, partials, m, p, k, nblk, rows, vec,
                                 s);
  if (p <= 512)
    return launch_wmt<16, 2, NT>(A, Z, V, partials, m, p, k, nblk, rows, vec,
                                 s);
  return launch_wmt<16, 4, NT>(A, Z, V, partials, m, p, k, nblk, rows, vec, s);
}

cudaError_t launch(const __nv_bfloat16* A, const float* Z, const float* V,
                   float* partials, int64_t m, int p, int k, int64_t nblk,
                   int64_t rows_per_block, cudaStream_t s) {
  if (k > 16 || p > 1024) return cudaErrorInvalidValue;
  const bool vec = p % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  return k <= 8 ? launch_nt<1>(A, Z, V, partials, m, p, k, nblk,
                               rows_per_block, vec, s)
                : launch_nt<2>(A, Z, V, partials, m, p, k, nblk,
                               rows_per_block, vec, s);
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// two-pass form
// ---------------------------------------------------------------------------

// Vt is V transposed (k × p), so a warp's loads of it are coalesced. One
// warp a row, for any k: U_i goes to qu in chunks of kKC classes, then
// (SOFTMAX; the split form stops at U) the softmax curvature runs over
// the row's classes in passes that each hold one value a lane (a max,
// the denominator, Σ P∘U, then QU over U in place), so no array is sized
// by k.
template <typename S, typename T, bool SOFTMAX>
__global__ void __launch_bounds__(kRowWarps * 32)
mglm_rows(const S* __restrict__ A, const T* __restrict__ Z,
          const T* __restrict__ Vt, T* __restrict__ qu, int64_t m, int p,
          int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp; i < m;
       i += static_cast<int64_t>(gridDim.x) * kRowWarps) {
    const S* a_row = A + i * p;
    const T* z_row = Z + i * k;
    T* q_row = qu + i * k;
    for (int c0 = 0; c0 < k; c0 += kKC) {
      T u[kKC];
#pragma unroll
      for (int cc = 0; cc < kKC; ++cc) u[cc] = T(0);
      for (int j = lane; j < p; j += 32) {
        const T a = scso::upcast<T>(a_row[j]);
        const T* vc = Vt + static_cast<int64_t>(c0) * p + j;
#pragma unroll
        for (int cc = 0; cc < kKC; ++cc)
          if (c0 + cc < k) u[cc] += a * __ldg(vc + static_cast<int64_t>(cc) * p);
      }
      scso::warp_reduce_scatter<kKC>(u, lane);
      const int c = c0 + scso::rs_index<kKC>(lane, 0);
      if ((lane & (32 / kKC - 1)) == 0 && c < k) q_row[c] = u[0];
    }
    if constexpr (!SOFTMAX) continue;
    __syncwarp();  // U_i in qu, visible to the whole warp
    // softmax curvature over the row: lane takes classes lane + 32·t
    T zmax = neg_inf<T>();
    for (int c = lane; c < k; c += 32) zmax = fmax(zmax, z_row[c]);
    zmax = scso::warp_max(zmax);
    T den = T(0);
    for (int c = lane; c < k; c += 32) den += scso::dexp(z_row[c] - zmax);
    den = scso::warp_sum(den);
    T spu = T(0);
    for (int c = lane; c < k; c += 32)
      spu += scso::dexp(z_row[c] - zmax) / den * q_row[c];
    spu = scso::warp_sum(spu);
    for (int c = lane; c < k; c += 32) {
      const T P = scso::dexp(z_row[c] - zmax) / den;
      q_row[c] = (P * q_row[c] - P * spu) / static_cast<T>(m);
    }
    __syncwarp();
  }
}

template <typename S, typename T>
__global__ void __launch_bounds__(kColThreads)
mglm_cols(const S* __restrict__ A, const T* __restrict__ qu,
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
    const T a = scso::upcast<T>(A[i * p + j]);
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

template <typename S, typename T, bool SOFTMAX>
cudaError_t launch_rows(const S* A, const T* Z, const T* Vt, T* qu, int64_t m,
                        int p, int k, cudaStream_t s) {
  const int64_t row_blocks =
      scso::imin((m + kRowWarps - 1) / kRowWarps, int64_t(1) << 16);
  mglm_rows<S, T, SOFTMAX><<<static_cast<unsigned>(row_blocks), kRowWarps * 32,
                          0, s>>>(A, Z, Vt, qu, m, p, k);
  return cudaGetLastError();
}

template <typename S, typename T>
cudaError_t launch_cols(const S* A, const T* qu, T* partials, int64_t m,
                        int p, int k, int64_t nblk, int64_t rows_per_chunk,
                        cudaStream_t s) {
  const dim3 grid((p + kColThreads - 1) / kColThreads, (k + kKC - 1) / kKC,
                  static_cast<unsigned>(nblk));
  mglm_cols<S, T><<<grid, kColThreads, 0, s>>>(A, qu, partials, m, p, k,
                                               rows_per_chunk);
  return cudaGetLastError();
}

// form: 0 two-pass, 1 tensor-core (T = float only); the split form's
// passes: 2 U = A·V into qu (no sum), 3 out = Aᵀ·qu. A in S, the rest
// in T.
template <typename S, typename T>
int launch(const void* A, const void* Z, const void* V, void* qu,
           void* partials, void* out, int64_t m, int64_t p, int64_t k,
           int64_t nblk, int64_t rows_per_block, int64_t form,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const S* a = static_cast<const S*>(A);
  const T* z = static_cast<const T*>(Z);
  const T* v = static_cast<const T*>(V);
  T* q = static_cast<T*>(qu);
  T* part = static_cast<T*>(partials);
  const int pi = static_cast<int>(p), ki = static_cast<int>(k);
  cudaError_t err = cudaErrorInvalidValue;
  if (form == 1) {
    if constexpr (std::is_same_v<S, __nv_bfloat16> && sizeof(T) == 4)
      err = tcb::launch(a, z, v, part, m, pi, ki, nblk, rows_per_block, s);
    else if constexpr (sizeof(T) == 4)
      err = tc::launch(a, z, v, part, m, pi, ki, nblk, rows_per_block, s);
  } else if (form == 2) {
    return static_cast<int>(
        launch_rows<S, T, false>(a, z, v, q, m, pi, ki, s));
  } else if (form == 3) {
    err = launch_cols<S, T>(a, q, part, m, pi, ki, nblk, rows_per_block, s);
  } else if (form == 0) {
    err = launch_rows<S, T, true>(a, z, v, q, m, pi, ki, s);
    if (err == cudaSuccess)
      err = launch_cols<S, T>(a, q, part, m, pi, ki, nblk, rows_per_block,
                              s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = p * k;
  scso::sum_partials<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, static_cast<T*>(out), n, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A in S, Z, V, qu, partials and out in T: A in T, or (the _bf16
// entries) A in bfloat16
#define SCSO_MGLM_ENTRY(NAME, S, T)                                        \
  extern "C" int NAME(const void* A, const void* Z, const void* V,        \
                      void* qu, void* partials, void* out, int64_t m,     \
                      int64_t p, int64_t k, int64_t nblk,                 \
                      int64_t rows_per_block, int64_t form,               \
                      void* stream) {                                     \
    return launch<S, T>(A, Z, V, qu, partials, out, m, p, k, nblk,        \
                        rows_per_block, form, stream);                    \
  }

SCSO_MGLM_ENTRY(scso_mglm_matvec_f32, float, float)
SCSO_MGLM_ENTRY(scso_mglm_matvec_f64, double, double)
SCSO_MGLM_ENTRY(scso_mglm_matvec_bf16_f32, __nv_bfloat16, float)
SCSO_MGLM_ENTRY(scso_mglm_matvec_bf16_f64, __nv_bfloat16, double)
