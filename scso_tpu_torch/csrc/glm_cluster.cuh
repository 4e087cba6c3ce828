// K2 and K2s with A stored in bfloat16 and float32 compute: the cluster
// form (glm_prep.cuh includes it; the wrapper's prep_grid picks it from
// n = 1025 up to ``cluster_max_n``, 14336, K2's one-pass limit; up to
// n = 1024 the two forms are within 2% and the one-pass form stays, as
// it does for K2s above 14336).
//
// What bounds it: A's bytes, half of float32's (1.19 ms at 196608×10112).
// The one-pass form (glm_prep.cuh) reached 47% of that bound with A in
// bfloat16 (2.52 ms on an H100 80GB HBM3 at 700 W, PERF.md): its cost a
// step did not halve with the bytes. Its 2·NC (n,) accumulators sit in
// shared memory and are read and written whole every two rows (≈ 320 KB
// of shared-memory traffic per 40 KB of A), the row group lives in
// registers beside the x slice, so no more rows fit a step, and A comes
// in only as far ahead as an L2 prefetch hint. A bfloat16 value costs as
// many instructions as a float32 one (an upcast, 2·NC FMAs for the dots,
// 4·NC for the sums), so at half the bytes the instructions a byte
// double: what the block does between two reads of A must be cut to the
// arithmetic itself.
//
// This form:
//   * a cluster of C blocks (1 to 4: the fewest whose slices fit a
//     block) walks one contiguous row range; block rank r owns the r-th
//     of C column slices, a thread a 16-byte chunk of 8 values, so its
//     slice of every x_c and its 2·NC accumulators stay in registers for
//     the whole walk (at the
//     main shape 39 clusters of 3 blocks of 422 pieces, as many as the
//     H100 holds at once: 117 of its 132 SMs);
//   * a producer warp streams A through a ring of ``stages`` groups of R
//     rows (8, or 16 where three stages fit) in shared memory: one
//     cp.async.bulk copy of the block's bytes of each row, completing on
//     the stage's full mbarrier, issued once the stage's empty mbarrier
//     says every compute warp is done with its last group (rows that are
//     not 16-byte aligned, n % 8 != 0, are copied a value at a time by
//     the thread that owns the chunk, into its own slot);
//   * compute warps: phase A, a group's NC·R dots over the thread's
//     chunk, a warp reduce-scatter, then lane j stores pair j's sum into
//     every block's inbox by st.async, completing transactions on that
//     block's inbox mbarrier (distributed shared memory; no cluster
//     barrier anywhere in the loop: a first design with one a group, which
//     stopped every warp of the cluster at every group, was slower than
//     the one-pass form); phase B, the group's column sums ρ·a and w·a²
//     from the same stage. Phase A runs kAhead groups ahead of phase B;
//   * a spec warp: once a group's C·W·NC·R partials are in, it adds them
//     in (rank, warp) order, hands the inbox slot back to every block
//     (remote mbarrier arrives), evaluates the spec's ρ and w (with y
//     loaded while it waited), writes w and adds the loss (rank 0), and
//     puts ρ and w in shared memory for phase B. Every block adds the
//     same partials in the same order, so every block holds the same z,
//     ρ and w bits, and the spec is evaluated once a row a block, not
//     once a row a warp.
// Sums are in a fixed order: a block's columns add the rows of its range
// in order, the clusters' partials go to glm_finalize (double, cluster
// order), the loss in double. No float atomics: reruns are bitwise equal.
#pragma once

namespace {
namespace cl_form {

constexpr int kMaxCluster = 4;  // the wrapper's CLUSTER_SIZES
constexpr int kMaxThreads = 512;  // the producer and spec warps included
constexpr int V = 8;              // values of A a thread: one 16-byte chunk
constexpr int kSlots = 4;  // inbox slots (and ρ, w slots) in flight
constexpr int kAhead = 1;  // groups a compute warp's dots run ahead of its
                           // column sums (the ring needs kAhead + 1 stages)

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

// arrive on ``bar`` and expect ``bytes`` more of transactions
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar))
               : "memory");
}

// wait for the phase of ``parity`` to complete; CLUSTER: acquire at
// cluster scope (arrivals released by other blocks)
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  while (!done) {
    if constexpr (CLUSTER) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    }
  }
}

// the shared::cluster address of ``p`` (this block's) in block ``rank``
__device__ __forceinline__ uint32_t remote(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(saddr(p)), "r"(rank));
  return r;
}

// v into another block's shared memory, completing 4 bytes of
// transactions on that block's mbarrier ``bar`` (both from remote())
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// arrive, releasing at cluster scope, on another block's mbarrier
__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global to this block's shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Chunks of each block's slice of a row of ``nc`` chunks, over a
// cluster of C
__host__ __device__ constexpr int64_t slice_chunks(int64_t nc, int64_t c) {
  return (nc + c - 1) / c;
}

// Shared memory of a block: the ring (stages·R·cb chunks of 16 bytes),
// the inbox slots (kSlots·C·W·R·NC floats; W the compute warps), 16-byte
// rounded. The wrapper's cluster_smem_bytes computes the same.
__host__ __device__ constexpr int64_t ring_bytes(int64_t stages, int64_t r,
                                                 int64_t cb) {
  return stages * r * cb * 16;
}
__host__ __device__ constexpr int64_t inbox_bytes(int64_t c, int64_t warps,
                                                  int64_t pairs) {
  return (kSlots * c * warps * pairs * 4 + 15) / 16 * 16;
}
// then ρ and w of kSlots groups (kSlots·2·R·NC floats, 16-byte multiple)
// and the mbarriers: full and empty a stage; in_full, in_free, rw_full
// and rw_free a slot

// A chunk of a row of A as a thread holds it: 8 bfloat16 values packed
// two a 32-bit word
struct Chunk8 {
  uint32_t w[V / 2];
  __device__ __forceinline__ void from(const uint4& u) {
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  }
  __device__ __forceinline__ uint4 raw() const {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ float at(int e) const {
    return (e & 1) ? scso::bf16_hi(w[e >> 1]) : scso::bf16_lo(w[e >> 1]);
  }
  // values [qV, qV + V) of a row, one at a time, zeros past n
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ row,
                                       int64_t q, int64_t n) {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const int64_t j = q * V + 2 * i;
      const uint32_t lo = j < n ? __ldcs(r + j) : 0u;
      const uint32_t hi = j + 1 < n ? __ldcs(r + j + 1) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
};

template <typename T, bool VEC, int NC, int R, RowOut F>
__global__ void __launch_bounds__(kMaxThreads, 1)
glm_cluster(const __nv_bfloat16* __restrict__ A, const T* __restrict__ y,
            Prep<T, NC> p, T* __restrict__ partials,
            double* __restrict__ loss_partials, int64_t m, int64_t n,
            int64_t m_norm, int kind, int64_t rows_per_cluster, int stages) {
  static_assert(std::is_same_v<T, float>, "float32 compute (the inbox)");
  constexpr int N = R * NC;   // (row, candidate) pairs of a group
  constexpr int L = 32 / N;   // lanes of the spec warp a pair
  static_assert(N <= 32 && (N & (N - 1)) == 0, "one lane a pair");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // compute warps 0 … W − 1, then the producer warp W (A into the ring)
  // and the spec warp W + 1 (z, ρ, w of each group)
  const int W = (blockDim.x >> 5) - 2;
  const int64_t nc = (n + V - 1) / V;     // chunks of a row
  const int64_t cb = slice_chunks(nc, C);  // chunks of a block's slice
  const int64_t q0 = rank * cb;
  const int64_t mine = scso::imax(0, scso::imin(cb, nc - q0));
  const int64_t q = q0 + tid;             // this thread's chunk
  const bool own = warp < W && tid < mine;

  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  float* inbox =
      reinterpret_cast<float*>(smem_raw + ring_bytes(stages, R, cb));
  // ρ and w of a group's rows: [kSlots][R][ρ_0 … ρ_{NC−1}, w_0 … w_{NC−1}]
  float* rw = inbox + inbox_bytes(C, W, N) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(rw + kSlots * R * 2 * NC);
  uint64_t* empty = full + stages;       // a stage's W compute warps are done
  uint64_t* in_full = empty + stages;    // a slot's C·W·N partials are in
  uint64_t* in_free = in_full + kSlots;  // every block's spec warp read a slot
  uint64_t* rw_full = in_free + kSlots;  // a group's ρ and w are in
  uint64_t* rw_free = rw_full + kSlots;  // the W compute warps read them
  const int64_t slot_size = static_cast<int64_t>(C) * W * N;
  const unsigned slot_bytes = static_cast<unsigned>(slot_size * 4);

  const int64_t clus = blockIdx.x / C;
  const int64_t r_begin = clus * rows_per_cluster;
  const int64_t r_end = scso::imin(m, r_begin + rows_per_cluster);
  const int64_t groups =
      r_end > r_begin ? (r_end - r_begin + R - 1) / R : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&in_full[s], 1);
      mbar_init(&in_free[s], C);
      mbar_init(&rw_full[s], 1);
      mbar_init(&rw_free[s], W);
      mbar_expect(&in_full[s], slot_bytes);  // armed for its first group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block has started and set its barriers before any block
  // writes into it
  cluster_sync();

  if (warp == W) {
    // the producer warp: group gi into stage gi % stages once its last
    // group's W warps are done with it, one bulk copy a row (VEC)
    if (VEC && lane == 0) {
      const unsigned bytes = static_cast<unsigned>(mine * 16);
      for (int64_t gi = 0; gi < groups; ++gi) {
        const int s = static_cast<int>(gi % stages);
        if (gi >= stages)
          mbar_wait(&empty[s], static_cast<unsigned>((gi / stages - 1) & 1));
        const int64_t r0 = r_begin + gi * R;
        const int rows = static_cast<int>(scso::imin(R, r_end - r0));
        mbar_expect(&full[s], rows * bytes);
        if (bytes == 0) continue;
        for (int r = 0; r < rows; ++r)
          bulk_load(ring + (static_cast<int64_t>(s) * R + r) * cb,
                    A + (r0 + r) * n + q0 * V, bytes, &full[s]);
      }
    }
    cluster_sync();  // no block leaves while another may write into it
    return;
  }

  if (warp == W + 1) {
    // the spec warp: group gi's z, ρ and w of pair j = lane / L (r = j /
    // NC, c = j % NC). The L lanes of a pair each add every L-th of the
    // slot's C·W partials in (rank, warp) order, then a butterfly over
    // the L lanes (every block adds the same partials in the same order:
    // the same bits); the slot goes back to every block; then the spec,
    // into rw; rank 0 writes w and adds the loss
    const int j = lane / L, h = lane & (L - 1);
    const T mT = static_cast<T>(m_norm);
    double loss = 0.0;  // rank 0, lane j·L: pair j's loss sum
    for (int64_t gi = 0; gi < groups; ++gi) {
      const int slot = static_cast<int>(gi % kSlots);
      const int64_t row = r_begin + gi * R + j / NC;
      const T yi = row < r_end ? y[row] : T(0);  // in flight while waiting
      mbar_wait(&in_full[slot], static_cast<unsigned>((gi / kSlots) & 1));
      const float* src = inbox + slot * slot_size + j;
      T z = T(0);
      int k = h;
      for (; k + 7 * L < C * W; k += 8 * L) {  // eight loads in flight
        T t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = src[(k + u * L) * N];
#pragma unroll
        for (int u = 0; u < 8; ++u) z += t[u];
      }
      for (; k < C * W; k += L) z += src[k * N];
      z = scso::group_sum<L>(z);
      __syncwarp();
      if (gi + kSlots < groups) {
        if (lane < C) remote_arrive(remote(&in_free[slot], lane));
        if (lane == 0) mbar_expect(&in_full[slot], slot_bytes);
      }
      T rho = T(0), w = T(0);
      if (row < r_end) {
        row_spec<F>(kind, z, yi, mT, &rho, &w);
        if (rank == 0 && h == 0) {
          (j % NC == 0 ? p.w[0] : p.w[NC - 1])[row] = w;
          if constexpr (NC == 2) loss += row_loss(kind, z, yi);
        }
      }
      if (gi >= kSlots)
        mbar_wait(&rw_free[slot], static_cast<unsigned>((gi / kSlots - 1) & 1));
      if (h == 0) {
        float* dst = rw + (slot * R + j / NC) * 2 * NC + j % NC;
        dst[0] = rho;
        dst[NC] = w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&rw_full[slot]);
    }
    if constexpr (NC == 2) {
      if (rank == 0) {  // each candidate's loss: rows in order
        double s[NC] = {0.0, 0.0};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            s[c] += __shfl_sync(0xffffffffu, loss, (r * NC + c) * L);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < NC; ++c) loss_partials[NC * clus + c] = s[c];
        }
      }
    }
    cluster_sync();
    return;
  }

  T xr[NC][V];
  T bacc[NC][V], hacc[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t j = q * V + e;
      xr[c][e] = own && j < n ? p.x[c][j] : T(0);
      bacc[c][e] = hacc[c][e] = T(0);
    }
  }

  // phase A of group gi: its rows' dots over this thread's chunk (from
  // the stage; !VEC: from A, and into this thread's own slot of the
  // stage), reduce-scattered over the warp, stored into every block's
  // inbox slot gi % kSlots at [rank][warp][pair] once every block's spec
  // warp has read that slot's last group
  auto phase_a = [&](int64_t gi) {
    const int s = static_cast<int>(gi % stages);
    const int64_t r0 = r_begin + gi * R;
    uint4* st = ring + static_cast<int64_t>(s) * R * cb + tid;
    if constexpr (VEC) mbar_wait(&full[s], static_cast<unsigned>(
                                               (gi / stages) & 1));
    T v[N];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Chunk8 a{};
      if (own && r0 + r < r_end) {
        if constexpr (VEC) {
          a.from(st[r * cb]);
        } else {
          a.load(A + (r0 + r) * n, q, n);
          st[r * cb] = a.raw();
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T d = T(0);
#pragma unroll
        for (int e = 0; e < V; ++e) d += a.at(e) * xr[c][e];
        v[r * NC + c] = d;
      }
    }
    scso::warp_reduce_scatter<N>(v, lane);
    const int slot = static_cast<int>(gi % kSlots);
    if (gi >= kSlots)
      mbar_wait<true>(&in_free[slot],
                      static_cast<unsigned>((gi / kSlots - 1) & 1));
    if ((lane & (32 / N - 1)) == 0) {
      const int j = scso::rs_index<N>(lane, 0);
      const float* dst = inbox + slot * slot_size +
                         (static_cast<int64_t>(rank) * W + warp) * N + j;
      for (int d = 0; d < C; ++d)
        st_async(remote(dst, d), v[0], remote(&in_full[slot], d));
    }
  };

  // phase B of group gi: acc += ρ·a, w·a² over this thread's chunk, from
  // the stage, rows in order, ρ and w from the spec warp; then the stage
  // and the group's ρ and w are released
  auto phase_b = [&](int64_t gi) {
    const int s = static_cast<int>(gi % stages);
    const int slot = static_cast<int>(gi % kSlots);
    const int64_t r0 = r_begin + gi * R;
    const uint4* st = ring + static_cast<int64_t>(s) * R * cb + tid;
    mbar_wait(&rw_full[slot], static_cast<unsigned>((gi / kSlots) & 1));
    const float* rws = rw + slot * R * 2 * NC;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T rr[NC], ww[NC];
      if constexpr (NC == 2) {
        const float4 f = *reinterpret_cast<const float4*>(rws + r * 4);
        rr[0] = f.x, rr[NC - 1] = f.y, ww[0] = f.z, ww[NC - 1] = f.w;
      } else {
        const float2 f = *reinterpret_cast<const float2*>(rws + r * 2);
        rr[0] = f.x, ww[0] = f.y;
      }
      if (own && r0 + r < r_end) {
        Chunk8 a;
        a.from(st[r * cb]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const T av = a.at(e);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            bacc[c][e] += rr[c] * av;
            hacc[c][e] += ww[c] * (av * av);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      if (VEC) mbar_arrive(&empty[s]);
      mbar_arrive(&rw_free[slot]);
    }
  };

  // kAhead groups ahead: group g + kAhead's partials leave before group
  // g's column sums, so the exchange and the spec warp's work overlap
  for (int64_t g = 0; g < scso::imin(kAhead, groups); ++g) phase_a(g);
  for (int64_t g = 0; g < groups; ++g) {
    if (g + kAhead < groups) phase_a(g + kAhead);
    phase_b(g);
  }

  // the cluster's row of (clusters, 2·NC, n) partials, this block's columns
  if (own) {
    T* dst = partials + clus * 2 * NC * n + q * V;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (q * V + e < n) {
          dst[c * n + e] = bacc[c][e];
          dst[(NC + c) * n + e] = hacc[c][e];
        }
      }
  }
  cluster_sync();  // no block leaves while another may write into it
}

// rows a group R (8 or 16): the wrapper's cluster_grid
template <typename T, int NC, RowOut F, int R>
cudaError_t launch(const __nv_bfloat16* A, const T* y, const Prep<T, NC>& p,
                   T* partials, double* loss_partials, int64_t m, int64_t n,
                   int64_t m_norm, int kind, int64_t clusters, int64_t cluster,
                   int64_t rows_per_cluster, int64_t threads, int64_t smem,
                   int64_t stages, bool vec, cudaStream_t s) {
  if (cluster > kMaxCluster || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  auto kernel = vec ? &glm_cluster<T, true, NC, R, F>
                    : &glm_cluster<T, false, NC, R, F>;
  cudaError_t err = scso::allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, A, y, p, partials, loss_partials, m,
                            n, m_norm, kind, rows_per_cluster,
                            static_cast<int>(stages));
}

// How many clusters of ``cluster`` blocks of ``threads`` threads and
// ``smem`` bytes the card holds at once (the ggn instance with 16-byte
// rows stands for every instance: the same threads and shared memory)
template <int NC, int R>
int fit(int64_t cluster, int64_t threads, int64_t smem, int* count) {
  auto kernel = &glm_cluster<float, true, NC, R, kGGN>;
  cudaError_t e = scso::allow_smem(kernel, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, kernel, &cfg));
}

}  // namespace cl_form
}  // namespace
