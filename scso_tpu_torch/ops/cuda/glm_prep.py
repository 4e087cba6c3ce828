"""K2 and K2s: the GLM epoch prep.

Port of `scso_tpu/ops/pallas/glm_prep.py`:
  * K2 (`_fused_glm_prep_pair`, :func:`glm_prep_pair`): for two
    candidate iterates (the greedy trial x_t and the SCORE-damped x_d)
    each candidate's CG matvec weights, RHS pullback, Jacobi diagonal
    and loss sum — the greedy accept test, the next epoch's CG prep and
    the stats objective in one call (the epoch-cache path);
  * K2s (`_fused_glm_prep`, :func:`glm_prep`): the same at one x, with
    no loss — the prep of the uncached GGN-CG path.
Both kernels are ``csrc/glm_prep.cuh``; :func:`glm_prep_torch` and
:func:`glm_prep_pair_torch` are the plain versions. The ``flavour``
picks the weights (the JAX package's `steps._glm_kernel_fns`): 'ggn'
(ProxGGNSCORE: the spec's GGN forms, :func:`ggn_weights`) or, for K2
alone, 'newton' (ProxNSCORE's epoch cache: ρ = gres and w = hvp_w, the
true Hessian weights, :func:`newton_weights`); K2 counts its newton
launches apart (``glm_prep_pair_newton``). The TPU kernels trace a
spec's Python callables into their bodies, which CUDA cannot: the
one-pass and wide forms below compute the spec kinds of
:data:`KERNEL_KINDS` in the kernel — the logistic01, least-squares and
Poisson GLMs, chosen by a runtime argument (:func:`covers`) — and any
other GLM spec runs the split form: the wide form's two passes over A
as two calls, the spec's own ρ, w and loss computed in PyTorch on the
(m,) vector z between them. A launch of a kind other than logistic01
also counts under its kind (``glm_prep_pair_lsq``,
``glm_prep_pair_newton_poisson``, …); the split form counts under the
base name alone.

What bounds both on the H100 is the bytes of A. Up to :func:`max_n`
(K2: n = 14336 in float32, 7168 in float64; K2s: 28672 and 14336) the
kernel's one-pass form reads A once, as the TPU kernels do: each block
(one an SM at the main shape) walks its rows a few at a time (two at
the main shape, eight at narrow n), each thread owning fixed 16-byte
column chunks, its slice of the candidates in registers, the 2·NC (n,)
accumulators in shared memory; the next row group is prefetched into L2
while the current one, held in registers, feeds both the row dots and
the column sums. Blocks sum in T, the sum over blocks is in double and
in a fixed order. Above max_n the accumulators do not fit a block, and
the wide form takes two passes over A (a rows pass and a columns pass).
:func:`prep_grid` picks the form and its geometry from the shapes
and the spec's kind alone; ``csrc/glm_prep.cuh``'s head note gives the
design and its register and shared-memory budget.

Every entry takes ``m_norm``, the count of the 1/m normalization,
apart from the rows of A it reads: on a row shard it is the row count
of all ranks (`Problem.m_total`), and the shard's sums add up over the
ranks to the unsharded ones. The kernels divide by it directly; the
plain versions rescale the spec's own 1/len(z) forms by len(z)/m_norm,
the JAX package's rule (`steps._glm_kernel_fns`). None means A's rows.

A may be stored in bfloat16 (the coarse phase of
`algorithms.mixed.iterate_mixed`, where A itself is cast) with y and
the candidates in float32 or float64: the kernels load A narrow and
upcast it in registers, as the TPU kernels do, and every output comes
out in x's dtype. K2 and K2s with A in bfloat16 and float32 candidates,
from n = 1025 to 14336, run the cluster form (:func:`cluster_grid`,
``csrc/glm_cluster.cuh``): a thread-block cluster splits a row's
columns, A streams through a ring in shared memory, the partial dots go
between the blocks by asynchronous stores into each other's shared
memory, and one warp a block evaluates the spec. Such a launch counts
as ``glm_prep_pair_bf16`` (or ``glm_prep_bf16``) as well as its base
name. The plain versions upcast A to x's dtype first (exact).

The TPU's n ≥ 8192 gates (`steps._use_pair_kernel`, the AUTO
`use_fused_prep`) are not carried over: the kernels take any m, n and
spec.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from scso_tpu_torch.ops.cuda import build, counters, launch
from scso_tpu_torch.ops.dense import amul, atmul, is_colshard, sq_atmul, widen

#: the spec kinds the one-pass and wide forms compute, in the order of
#: their codes (``Kind`` in csrc/glm_prep.cuh)
KERNEL_KINDS = ("logistic01", "lsq", "poisson")
FLAVOURS = ("ggn", "newton")

# dynamic shared memory a block may use: Hopper's 227 KB less headroom
# for the kernel's static buffers (as K1's, ops/cuda/matvec.py)
_SMEM_BYTES = 224 * 1024
_SM_SMEM_BYTES = 228 * 1024     # shared memory of one SM
_SM_BLOCK_OVERHEAD = 2 * 1024   # per block: reserved + static buffers
_SM_REGS = 65536                # registers of one SM
_MAX_REGS = 128           # a thread's most under __launch_bounds__(512, 1)
_MAX_THREADS = 512        # kMaxThreads in csrc/glm_prep.cuh
_WIDE_THREADS = 256       # kThreads in csrc/glm_prep.cuh
# the one-pass kernel's instantiated chunks-a-thread buckets with A in
# the compute type, by candidate count (has_bucket in
# csrc/glm_prep.cuh), and its rows a step for a bucket (rows_a_step)
_CHUNKS_PER_THREAD = {2: (1, 2, 3, 4, 5, 6, 7),
                      1: (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14)}


def _rows_a_step(q):
    return 8 if q == 1 else 4 if q == 2 else 2


def _chunk(dtype, a_dtype):
    """(values of A in a 16-byte chunk, bytes of its accumulators in the
    compute type ``dtype``) for A stored in ``a_dtype``."""
    e = 16 // a_dtype.itemsize
    return e, e * dtype.itemsize


def _buckets(candidates, dtype, a_dtype):
    """The one-pass kernel's chunks-a-thread buckets: with A in the
    compute type, :data:`_CHUNKS_PER_THREAD`; with A in bfloat16, 1 up
    to the fewest that cover :func:`max_n`'s chunks at 512 threads (K2:
    2 in float64; K2s: 7 and 4), but 1 alone for K2 in float32 (the
    cluster form takes n from 1025 to its limit), the instances
    csrc/glm_prep_bf16.cu builds."""
    if a_dtype == dtype:
        return _CHUNKS_PER_THREAD[candidates]
    if takes_cluster(max_n(dtype, candidates, a_dtype), dtype, candidates,
                     True, a_dtype):
        return (1,)  # n <= CLUSTER_MIN_N: 128 chunks at most
    e, _ = _chunk(dtype, a_dtype)
    chunks = max_n(dtype, candidates, a_dtype) // e
    return tuple(range(1, -(-chunks // _MAX_THREADS) + 1))


class PairPrep(NamedTuple):
    """Per-candidate epoch prep (t = greedy trial, d = SCORE-damped).
    ``loss_*`` are RAW per-sample loss SUMS over the rows — the caller
    rescales by 1/m for sample-normalized specs."""

    w_t: torch.Tensor     # (m,)  CG matvec weights at x_t
    w_d: torch.Tensor     # (m,)
    b_t: torch.Tensor     # (n,)  Aᵀ·ρ(y, A·x_t)
    b_d: torch.Tensor     # (n,)
    hd_t: torch.Tensor    # (n,)  Σᵢ wᵢ·Aᵢⱼ²
    hd_d: torch.Tensor    # (n,)
    loss_t: torch.Tensor  # ()    Σᵢ ℓ(yᵢ, zᵢ)
    loss_d: torch.Tensor  # ()


def _norm_fix(glm, m, m_norm):
    """Rescale a sample-normalized spec's 1/len(z) form to 1/m_norm
    (the JAX package's `_norm_fix`); the identity when m_norm is m."""
    if m_norm is None or m_norm == m or not glm.sample_normalized:
        return lambda v: v
    return lambda v: v * (m / m_norm)


def ggn_weights(glm, y, z):
    """(ρ, w) of the GGN system at z: the spec's stable ggn_rw/ggn_w when
    given, else σ'·res and σ'²·qdiag (the JAX package's
    `steps._glm_kernel_fns`, ggn flavour)."""
    if glm.ggn_rw is not None:
        rw = glm.ggn_rw(y, z)
    else:
        rw = glm.dlink(z) * glm.res(y, glm.link(z))
    if glm.ggn_w is not None:
        w = glm.ggn_w(y, z)
    else:
        sp = glm.dlink(z)
        w = sp * sp * glm.qdiag(y, glm.link(z))
    return rw, w


def newton_weights(glm, y, z):
    """(ρ, w) of the Newton system at z: the gradient residual gres and
    the Hessian weights hvp_w (the JAX package's `steps._glm_kernel_fns`,
    newton flavour)."""
    return glm.gres(y, z), glm.hvp_w(y, z)


def _check_flavour(flavour):
    if flavour not in FLAVOURS:
        raise ValueError(f"unknown GLM prep flavour {flavour!r}; known: "
                         f"{FLAVOURS}")


def _weights(glm, y, z, m_norm, flavour="ggn"):
    """(ρ, w) at z in ``flavour``, normalized by ``m_norm``: the plain
    versions' and the split form's."""
    fix = _norm_fix(glm, z.shape[0], m_norm)
    _check_flavour(flavour)
    weights = newton_weights if flavour == "newton" else ggn_weights
    rw, w = weights(glm, y, z)
    return fix(rw), fix(w)


def glm_prep_torch(A, y, x, glm, m_norm=None, flavour="ggn"):
    """Plain single-candidate prep: (w, Aᵀρ, Σᵢ wᵢAᵢⱼ², Σᵢ ℓᵢ) at x, with
    ρ, w from :func:`ggn_weights` (or :func:`newton_weights`) and ℓ the
    spec's loss_sample, normalized by ``m_norm``.

    ``Σᵢ wᵢAᵢⱼ²`` materialises an A-sized temporary (w·A, then the
    contraction with A): about 8 GB at the full 196608×10112 float32
    width. The CUDA kernel needs none. A bfloat16 A is first upcast to
    x's dtype (exact): another A-sized temporary. On a column shard
    (`ops.dense.ColShard`) the products of `ops.dense`."""
    if is_colshard(A):
        z = amul(A, x)
        rw, w = _weights(glm, y, z, m_norm, flavour)
        return (w, atmul(A, rw), sq_atmul(A, w),
                torch.sum(glm.loss_sample(y, z)))
    A = widen(A, x.dtype)
    z = A @ x
    rw, w = _weights(glm, y, z, m_norm, flavour)
    return (w, A.T @ rw, sq_atmul(A, w), torch.sum(glm.loss_sample(y, z)))


def glm_prep_pair_torch(A, y, x_t, x_d, glm, m_norm=None,
                        flavour="ggn") -> PairPrep:
    """Plain dual-candidate prep: :func:`glm_prep_torch` at each
    candidate (same A-sized temporary, twice)."""
    wt, bt, ht, lt = glm_prep_torch(A, y, x_t, glm, m_norm, flavour)
    wd, bd, hd, ld = glm_prep_torch(A, y, x_d, glm, m_norm, flavour)
    return PairPrep(wt, wd, bt, bd, ht, hd, lt, ld)


def covers(glm) -> bool:
    """True for a GLM spec whose forms the kernels compute themselves,
    in both flavours (the one-pass and wide forms): a kind in
    :data:`KERNEL_KINDS` (logistic01, lsq, poisson), normalized by 1/m.
    Any other spec takes the split form."""
    return glm.kind in KERNEL_KINDS and glm.sample_normalized


def _kind_code(glm) -> int:
    """The kernels' code of a covered spec's kind; -1 (unread) for the
    split form."""
    return KERNEL_KINDS.index(glm.kind) if covers(glm) else -1


class PrepGrid(NamedTuple):
    """Launch geometry of one K2/K2s call (see :func:`prep_grid`); the
    fields after ``form`` are the C entries' arguments, in order."""

    form: str               # "one_pass", "cluster" (A read once), "wide"
    #                         or "split"
    blocks: int             # one-pass: blocks; cluster: clusters; else
    #                         row chunks (a row of partials each)
    rows_per_block: int     # rows of each block, cluster or chunk
    smem_bytes: int         # dynamic shared memory a block (else 0)
    threads: int            # threads a block
    chunks_per_thread: int  # 16-byte column chunks a thread (wide: 0)
    row_blocks: int         # blocks with a loss partial (wide: rows pass)
    cluster: int = 0        # cluster form: blocks of a cluster (else 0)
    stages: int = 0         # cluster form: row groups in the ring
    group_rows: int = 0     # cluster form: rows a group


def max_n(dtype, candidates, a_dtype=None) -> int:
    """Largest n of the one-pass form: 2·candidates (n,) accumulators in
    the compute type ``dtype`` in one block's shared memory, for whole
    16-byte chunks of A stored in ``a_dtype`` (default ``dtype``): K2
    14336 in float32, 7168 in float64; K2s 28672 and 14336 — with A in
    bfloat16 too, as the accumulators stay in ``dtype``."""
    e, chunk_bytes = _chunk(dtype, a_dtype or dtype)
    return e * (_SMEM_BYTES // (2 * candidates * chunk_bytes))


#: the cluster form (csrc/glm_cluster.cuh): A in bfloat16, float32
#: compute, a row's 16-byte chunks split over a cluster of CLUSTER_SIZES
#: blocks, one chunk a compute thread, a producer and a spec warp beside
#: them; its candidate counts (K2 and K2s), rows a group, and the ring's
#: stages
CLUSTER_SIZES = (1, 2, 3, 4)
CLUSTER_CANDIDATES = (1, 2)
CLUSTER_GROUP_ROWS = (8, 16)
CLUSTER_STAGES = (3, 6)         # fewest, most
#: up to this n K2 and K2s keep the one-pass form: at 524288×1024 the
#: two forms were within 2% of each other on the H100 (chip_ab.py;
#: PERF.md)
CLUSTER_MIN_N = 1024
_CLUSTER_SLOTS = 4              # kSlots in csrc/glm_cluster.cuh
_HELPER_THREADS = 64            # the producer and the spec warp


def cluster_max_n() -> int:
    """Largest n of the cluster form: a cluster of 4 blocks of 448
    compute threads of 8 values (14336)."""
    return CLUSTER_SIZES[-1] * 8 * (_MAX_THREADS - _HELPER_THREADS)


def takes_cluster(n, dtype, candidates, covered=True, a_dtype=None) -> bool:
    """True where :func:`prep_grid` picks the cluster form: a covered
    spec, A in bfloat16, float32 compute, K2 or K2s
    (:data:`CLUSTER_CANDIDATES`) and n above :data:`CLUSTER_MIN_N` up to
    :func:`cluster_max_n` (K2s keeps the one-pass form above it, to
    28672)."""
    return (covered and a_dtype == torch.bfloat16 and dtype == torch.float32
            and candidates in CLUSTER_CANDIDATES
            and CLUSTER_MIN_N < n <= cluster_max_n())


def _slice_chunks(n, cluster):
    """Chunks of a block's slice of a row (slice_chunks in
    csrc/glm_cluster.cuh)."""
    return -(-(-(-n // 8)) // cluster)


def cluster_smem_bytes(n, cluster, threads, group_rows, stages,
                       candidates) -> int:
    """Shared memory of a cluster-form block (csrc/glm_cluster.cuh): the
    ring of ``stages`` groups of the block's chunks of ``group_rows``
    rows, the inbox's slots of the cluster's compute warps' partial dots
    (float32, 16-byte rounded), the slots' ρ and w, then the mbarriers:
    two a stage, four a slot."""
    ring = stages * group_rows * _slice_chunks(n, cluster) * 16
    inbox = (_CLUSTER_SLOTS * cluster * (threads - _HELPER_THREADS) // 32
             * group_rows * candidates * 4)
    rw = _CLUSTER_SLOTS * group_rows * 2 * candidates * 4
    return (ring + -(-inbox // 16) * 16 + rw
            + 8 * (2 * stages + 4 * _CLUSTER_SLOTS))


def cluster_grid(m, n, candidates, sms, cluster=None, group_rows=None,
                 stages=None, fit=None) -> PrepGrid:
    """The cluster form's geometry for A (m, n) in bfloat16: a compute
    thread a 16-byte chunk of the block's slice, and a producer and a
    spec warp; ``cluster`` blocks a cluster (default the fewest of
    :data:`CLUSTER_SIZES` whose slices fit a block), ``group_rows`` rows
    a group (default 16 where three stages of them fit, else 8),
    ``stages`` (default: the most of :data:`CLUSTER_STAGES` at which as
    many blocks share an SM as its threads and registers allow, else
    fewer blocks). As many clusters as the card holds at once
    (``fit(cluster, threads, smem, group_rows)``; default: the blocks an
    SM times ``sms`` over the cluster), at most one a group of rows; each
    owns a contiguous range of whole groups (the last one ragged), every
    row in exactly one cluster."""
    top = _MAX_THREADS - _HELPER_THREADS
    c = cluster or next((c for c in CLUSTER_SIZES
                         if _slice_chunks(n, c) <= top), CLUSTER_SIZES[-1])
    threads = 32 * -(-_slice_chunks(n, c) // 32) + _HELPER_THREADS
    r = group_rows or next(r for r in CLUSTER_GROUP_ROWS[::-1] if r == 8 or
                           cluster_smem_bytes(n, c, threads, r,
                                              CLUSTER_STAGES[0],
                                              candidates) <= _SMEM_BYTES)
    regs = min(2048 // threads, _SM_REGS // (_MAX_REGS * threads))

    def smem_of(s):
        return cluster_smem_bytes(n, c, threads, r, s, candidates)

    def fits(s, b):
        return (smem_of(s) <= _SMEM_BYTES
                and b * (smem_of(s) + _SM_BLOCK_OVERHEAD) <= _SM_SMEM_BYTES)

    lo, hi = CLUSTER_STAGES
    if stages is None:
        b, stages = next(((b, s) for b in range(max(1, regs), 0, -1)
                          for s in range(hi, lo - 1, -1) if fits(s, b)),
                         (1, lo))
    else:
        b = next((b for b in range(max(1, regs), 0, -1) if fits(stages, b)),
                 1)
    smem = smem_of(stages)
    fitted = b * sms // c if fit is None else fit(c, threads, smem, r)
    clusters = max(1, min(fitted, -(-m // r)))
    rows = r * -(-(-(-m // clusters)) // r)
    clusters = -(-m // rows)
    return PrepGrid("cluster", clusters, rows, smem, threads, 1, clusters,
                    c, stages, r)


def one_pass_grid(m, n, dtype, candidates, sms, a_dtype=None) -> PrepGrid:
    """The one-pass form's geometry (see :func:`prep_grid`) for n up to
    :func:`max_n`."""
    a_dtype = a_dtype or dtype
    e, chunk_bytes = _chunk(dtype, a_dtype)
    nc = -(-n // e)
    q = next(q for q in _buckets(candidates, dtype, a_dtype)
             if -(-nc // q) <= _MAX_THREADS)
    threads = max(32, 32 * -(-nc // (32 * q)))
    smem = 2 * candidates * nc * chunk_bytes
    per_sm = max(1, min(2048 // threads,
                        _SM_REGS // (_MAX_REGS * threads),
                        _SM_SMEM_BYTES // (smem + _SM_BLOCK_OVERHEAD)))
    blocks = max(1, min(per_sm * sms, -(-m // _rows_a_step(q))))
    rows = -(-m // blocks)
    blocks = -(-m // rows)
    return PrepGrid("one_pass", blocks, rows, smem, threads, q, blocks)


def prep_grid(m, n, dtype, candidates, sms, covered=True,
              a_dtype=None, fit=None) -> PrepGrid:
    """The form and launch geometry for A (m, n) stored in ``a_dtype``
    (default ``dtype``; else bfloat16), computed in ``dtype``, and
    ``candidates`` (2: K2, 1: K2s) on a card with ``sms`` SMs, from the
    shapes and ``covered`` (:func:`covers` of the spec) alone.

    One-pass form (n <= :func:`max_n`): one wave of blocks, each owning
    a contiguous row range, every row in exactly one block (m = 1 gives
    one block). A thread owns ``chunks_per_thread`` 16-byte column
    chunks, the fewest of the kernel's buckets that need at most 512
    threads; its slice of the candidates and the current row group sit
    in registers. As many blocks share an SM as its registers (at the
    128 a thread the kernel may use), threads and shared memory hold:
    one at 512 threads, so at the main shape. A chunk holds 16 bytes of
    A (8 values in bfloat16) and its accumulators are in ``dtype``.
    Cluster form (:func:`takes_cluster`: K2 and K2s with A in bfloat16,
    float32, 1024 < n <= :func:`cluster_max_n`; ahead of the one-pass
    form):
    :func:`cluster_grid`, ``fit`` the count of clusters the card holds
    (the wrapper asks the card). Wide form (n above both): the
    two-pass geometry — a rows pass of up to 8 blocks an SM, one warp a
    row, and enough row chunks for the columns pass to give about 8
    blocks an SM. Split form (a spec not covered, any n): the wide
    geometry."""
    a_dtype = a_dtype or dtype
    if takes_cluster(n, dtype, candidates, covered, a_dtype):
        return cluster_grid(m, n, candidates, sms, fit=fit)
    if covered and n <= max_n(dtype, candidates, a_dtype):
        return one_pass_grid(m, n, dtype, candidates, sms, a_dtype)
    e, _ = _chunk(dtype, a_dtype)
    row_blocks = max(1, min(8 * sms, -(-m // 8)))
    col_tiles = -(-(n // e if n % e == 0 else n) // _WIDE_THREADS)
    chunks = max(1, min(-(-8 * sms // col_tiles), -(-m // 256)))
    return PrepGrid("wide" if covered else "split", chunks, -(-m // chunks), 0,
                    _WIDE_THREADS, 0, row_blocks)


def _scratch(grid, candidates, m, n, dtype, device):
    """One allocation for a call's scratch (the host's cost of a call is
    part of each epoch's): the buffer, then the pointers to its partials
    and loss partials, then ρ. Partials are (blocks, 2·candidates, n), in
    ``dtype`` one-pass and in double otherwise; loss partials
    (row_blocks, 2) double; ρ (candidates, m) in ``dtype``, a view of the
    buffer, wide and split only (None otherwise)."""
    two_pass = grid.form in ("wide", "split")
    part_item = 8 if two_pass else dtype.itemsize
    sizes = [grid.blocks * 2 * candidates * n * part_item,
             grid.row_blocks * 2 * 8]
    sizes = [-(-b // 256) * 256 for b in sizes]   # each part 256-B aligned
    rw_at = sum(sizes)
    base = torch.empty(rw_at + (candidates * m * dtype.itemsize if two_pass
                                else 0), dtype=torch.uint8, device=device)
    ptr = base.data_ptr()
    rw = (base[rw_at:].view(dtype).view(candidates, m) if two_pass
          else None)
    return base, ptr, ptr + sizes[0], rw


def _check_shapes(name, A, y, m_norm, *xs):
    """Raises on mismatched shapes; returns m_norm (A's rows for
    None)."""
    m, n = A.shape
    if y.shape != (m,) or any(x.shape != (n,) for x in xs):
        raise ValueError(
            f"{name}: shapes A {tuple(A.shape)}, y {tuple(y.shape)}, x "
            f"{[tuple(x.shape) for x in xs]}")
    if m == 0:
        raise ValueError(f"{name}: A has no rows")
    m_norm = m if m_norm is None else int(m_norm)
    if m_norm <= 0:
        raise ValueError(f"{name}: m_norm must be positive, got {m_norm}")
    return m_norm


def _launcher(name, dev, dt, *args):
    """Launch entry ``name`` on ``args`` with a phase (0: the one-pass
    or wide form; 1, 2: the split form's two calls)."""
    def run(phase):
        with torch.cuda.device(dev):
            rc = launch.entry(name, dt)(*args, phase, launch.stream(dev))
        build.check(rc, name[len("scso_"):])
    return run


@functools.lru_cache(maxsize=None)
def _clusters_fit(device_index, candidates, group_rows, cluster, threads,
                  smem) -> int:
    """How many clusters of the cluster form the card holds at once
    (cudaOccupancyMaxActiveClusters; at least 1, so a launch that cannot
    run raises there)."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(build.load().scso_glm_prep_cluster_fit(
            candidates, group_rows, cluster, threads, smem,
            ctypes.addressof(count)), "glm_prep cluster fit")
    return max(1, count.value)


def _grid(A, n_dtype, candidates, glm) -> PrepGrid:
    """:func:`prep_grid` for CUDA operands, the cluster form sized by
    what the card holds."""
    m, n = A.shape
    dev = A.device.index or 0

    def fit(cluster, threads, smem, group_rows):
        return _clusters_fit(dev, candidates, group_rows, cluster, threads,
                             smem)

    return prep_grid(m, n, n_dtype, candidates, launch.sm_count(dev),
                     covers(glm), A.dtype, fit)


def _base(name, A, glm):
    """The C entry's base name and the counters of a launch on A for
    ``glm``: a bfloat16 A adds ``_bf16`` to both (and counts under
    ``name`` too); a covered kind other than logistic01 counts under
    ``name_kind`` (and ``name_kind_bf16``) as well."""
    bf16 = A.dtype == torch.bfloat16
    counts = [name] + ([f"{name}_bf16"] if bf16 else [])
    if covers(glm) and glm.kind != "logistic01":
        counts += [f"{name}_{glm.kind}"] + (
            [f"{name}_{glm.kind}_bf16"] if bf16 else [])
    return f"scso_{name}_bf16" if bf16 else f"scso_{name}", tuple(counts)


def glm_prep(A, y, x, glm, m_norm=None):
    """Single-candidate prep (w, Aᵀρ, Σᵢ wᵢAᵢⱼ²) at x — the K2s kernel
    for CUDA tensors (its split form for a spec that :func:`covers`
    refuses), the plain version for CPU tensors. A is in x's dtype
    (float32 or float64) or in bfloat16; the outputs are in x's."""
    if launch.on_cpu(A, "glm_prep"):
        return glm_prep_torch(A, y, x, glm, m_norm)[:3]
    launch.check_operands("glm_prep", x.dtype, A.device, narrow=("A",), A=A,
                          y=y, x=x)
    m_norm = _check_shapes("glm_prep", A, y, m_norm, x)
    return _single(A, y, x, glm, m_norm, _grid(A, x.dtype, 1, glm))


def _single(A, y, x, glm, m_norm, grid):
    """K2s on checked CUDA operands in ``grid``'s form and geometry."""
    m, n = A.shape
    dev, dt = A.device, x.dtype
    base, counts = _base("glm_prep", A, glm)
    w, b, hd = torch.empty(m + 2 * n, dtype=dt, device=dev).split([m, n, n])
    # ``buf`` holds the scratch the pointers address until the launches
    buf, partials, _, rw = _scratch(grid, 1, m, n, dt, dev)
    run = _launcher(base, dev, dt, A.data_ptr(), y.data_ptr(),
                    x.data_ptr(), w.data_ptr(),
                    None if rw is None else rw.data_ptr(), b.data_ptr(),
                    hd.data_ptr(), partials, m, n, m_norm, _kind_code(glm),
                    *grid[1:])
    if grid.form == "split":
        run(1)  # z into rw
        rho, w_ = _weights(glm, y, rw[0], m_norm)
        rw[0].copy_(rho)
        w.copy_(w_)
        run(2)
    else:
        run(0)
    del buf
    for c in counts:
        counters.bump(c)
    return w, b, hd


def glm_prep_pair(A, y, x_t, x_d, glm, m_norm=None,
                  flavour="ggn") -> PairPrep:
    """Dual-candidate prep in ``flavour`` ('ggn' or 'newton') — the K2
    kernel for CUDA tensors (its split form for a spec that
    :func:`covers` refuses), the plain version for CPU tensors. A is in
    the candidates' dtype (float32 or float64) or in bfloat16; the
    outputs are in the candidates'."""
    _check_flavour(flavour)
    if launch.on_cpu(A, "glm_prep_pair"):
        return glm_prep_pair_torch(A, y, x_t, x_d, glm, m_norm, flavour)
    launch.check_operands("glm_prep_pair", x_t.dtype, A.device,
                          narrow=("A",), A=A, y=y, x_t=x_t, x_d=x_d)
    m_norm = _check_shapes("glm_prep_pair", A, y, m_norm, x_t, x_d)
    return _pair(A, y, x_t, x_d, glm, m_norm, flavour,
                 _grid(A, x_t.dtype, 2, glm))


def _pair(A, y, x_t, x_d, glm, m_norm, flavour, grid) -> PairPrep:
    """K2 on checked CUDA operands in ``grid``'s form and geometry (any
    :func:`cluster_grid` of A's shape runs; chip_ab.py's sweep)."""
    m, n = A.shape
    dev, dt = A.device, x_t.dtype
    out = torch.empty(2 * m + 4 * n + 2, dtype=dt, device=dev)
    w_t, w_d, b_t, b_d, hd_t, hd_d = out[:-2].split([m, m, n, n, n, n])
    loss_t, loss_d = out[-2], out[-1]
    # ``buf`` holds the scratch the pointers address until the launches
    buf, partials, loss_partials, rw = _scratch(grid, 2, m, n, dt, dev)
    name, counts = _base("glm_prep_pair_newton" if flavour == "newton"
                         else "glm_prep_pair", A, glm)
    run = _launcher(name, dev, dt, A.data_ptr(), y.data_ptr(),
                    x_t.data_ptr(), x_d.data_ptr(), w_t.data_ptr(),
                    w_d.data_ptr(), None if rw is None else rw.data_ptr(),
                    b_t.data_ptr(), b_d.data_ptr(), hd_t.data_ptr(),
                    hd_d.data_ptr(), loss_t.data_ptr(), loss_d.data_ptr(),
                    partials, loss_partials, m, n, m_norm, _kind_code(glm),
                    *grid[1:])
    if grid.form == "split":
        run(1)  # z_t, z_d into rw
        loss_t, loss_d = (torch.sum(glm.loss_sample(y, z)) for z in rw)
        for z, w in zip(rw, (w_t, w_d)):
            rho, w_ = _weights(glm, y, z, m_norm, flavour)
            z.copy_(rho)
            w.copy_(w_)
        run(2)
    else:
        run(0)
    del buf
    for c in counts:
        counters.bump(c)
    return PairPrep(w_t, w_d, b_t, b_d, hd_t, hd_d, loss_t, loss_d)
