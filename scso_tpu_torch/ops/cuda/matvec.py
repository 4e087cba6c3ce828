"""K1 and K1s: the fused normal-equation matvec v ↦ Aᵀ(w ∘ (A v)).

Port of `scso_tpu/ops/pallas/matvec.py`: `_fused_normal_matvec` (K1),
the op of every CG iteration, and `fused_normal_matvec_sharded` (K1s),
its row-sharded form. The CUDA kernel is ``csrc/matvec.cu`` (its source
note gives the design); :func:`normal_matvec_torch` is the plain
PyTorch version of the same function.

K1s has no kernel body of its own on the TPU either: there it is K1 in
a `shard_map` plus XLA's `psum`. Here :func:`normal_matvec_sharded` is
K1 on this rank's rows plus one ``torch.distributed.all_reduce`` of the
(n,) result over the mesh's group (NCCL on the card): what bounds it is
K1's read of the shard, plus one all-reduce of n values. With one rank
that all-reduce is a copy, so K1s is K1 bit for bit.

The TPU shape gates (`supports_fused_normal_matvec`, `_MIN_N_BYTES`)
came from VMEM and T(8,128) tiling and are not carried over: the kernel
takes any m ≥ 0 and any n. Up to :func:`max_n` v and the per-block
accumulator live in shared memory; above it the kernel's wide form keeps
them in global memory (where the JAX package takes its XLA form
instead).

A may be stored in bfloat16 (the low-precision copy of
precision-adaptive CG, `Problem.A_lp`) with w and v in float32 or
float64: the kernel loads A narrow and upcasts it in registers, as the
TPU kernel does, and the result comes out in v's dtype. Such a launch
counts as ``normal_matvec_bf16`` as well as ``normal_matvec``.
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.cuda import build, counters, launch
from scso_tpu_torch.ops.collective import group_sum, sum_in_place
from scso_tpu_torch.ops.dense import amul, atmul, is_colshard, widen

# dynamic shared memory a block may use: Hopper's 227 KB less headroom
# for the kernel's static buffers
_SMEM_BYTES = 224 * 1024
_SM_SMEM_BYTES = 228 * 1024     # shared memory of one SM
_SM_BLOCK_OVERHEAD = 2 * 1024   # per block: reserved + static buffers
_THREADS = 512                  # kThreads in csrc/matvec.cu
# kRows in csrc/matvec.cu: rows a step for A in w's dtype / in bfloat16
_ROWS_PER_STEP = {False: 2, True: 4}
_MAX_GROUPS = _THREADS // 32    # a row group is at least one warp


def normal_matvec_torch(A, w, v):
    """Plain PyTorch Aᵀ(w ∘ (A v)): two matrix-vector products, A read
    twice. A bfloat16 A is first upcast to w's dtype (exact; PyTorch
    multiplies no bfloat16 matrix by a float32 or float64 vector): an
    A-sized temporary in w's dtype. On a column shard (`ops.dense.
    ColShard`) the two products of `ops.dense`, each with its collective
    over the model axis."""
    if is_colshard(A):
        return atmul(A, w * amul(A, v))
    A = widen(A, w.dtype)
    return A.T @ (w * (A @ v))


def max_n(dtype) -> int:
    """Largest n of the shared-memory form: v plus one accumulator in
    shared memory (28672 in float32, 14336 in float64). ``dtype`` is
    v's, whatever A is stored in."""
    return _SMEM_BYTES // (2 * torch.empty((), dtype=dtype).element_size())


def row_groups(n, itemsize, narrow=False) -> int:
    """Row groups of K1's shared-memory form at width n (``itemsize``:
    v's; ``narrow``: A in bfloat16): the block's threads split into
    groups that each walk their own rows into their own accumulator in
    shared memory, so that at narrow n every thread has a chunk. The
    most groups (a power of two) that each still hold a thread for
    every 16-byte chunk of a row and whose accumulators fit in shared
    memory: more than one only for rows of at most 256 chunks (n <=
    1024 in float32, 512 in float64, 2048 with A in bfloat16)."""
    chunk = 8 if narrow else 16 // itemsize
    nc = n // chunk if n % chunk == 0 else n  # else one value a load
    g = 1
    while (2 * g <= _MAX_GROUPS and _THREADS // (2 * g) >= nc
           and (1 + 2 * g) * n * itemsize <= _SMEM_BYTES):
        g *= 2
    return g


def normal_matvec(A, w, v):
    """Aᵀ(w ∘ (A v)) — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. A is in w's and v's dtype (float32 or
    float64) or in bfloat16; the result is in v's dtype. Never falls
    back for a CUDA tensor: an operand the kernel does not take
    raises."""
    if launch.on_cpu(A, "normal_matvec"):
        return normal_matvec_torch(A, w, v)
    m, n = A.shape
    dt = v.dtype
    launch.check_operands("normal_matvec", dt, A.device, narrow=("A",),
                          A=A, w=w, v=v)
    if w.shape != (m,) or v.shape != (n,):
        raise ValueError(f"normal_matvec: shapes A {tuple(A.shape)}, "
                         f"w {tuple(w.shape)}, v {tuple(v.shape)}")
    out = torch.empty((n,), dtype=dt, device=A.device)
    if m == 0 or n == 0:
        return out.zero_()
    narrow = A.dtype == torch.bfloat16
    wide = n > max_n(dt)
    size = v.element_size()
    groups = 1 if wide else row_groups(n, size, narrow)
    # as many resident blocks as fit on each SM: one wave, each block
    # owning a contiguous row range (measured on the H100: a second,
    # partial wave of blocks costs more than the extra occupancy buys).
    # This caps them by threads and shared memory; the launch caps them
    # again by the form's registers
    smem = 0 if wide else (1 + groups) * n * size
    per_sm = max(1, min(2048 // _THREADS,
                        _SM_SMEM_BYTES // (smem + _SM_BLOCK_OVERHEAD)))
    sms = launch.sm_count(A.device.index or 0)
    rows = _ROWS_PER_STEP[narrow] * groups
    nblk = max(1, min(sms * per_sm, -(-m // rows)))
    if launch.use_ops():
        return torch.ops.scso.normal_matvec(A, w, v, nblk, int(wide), groups)
    partials = torch.empty((nblk, n), dtype=dt, device=A.device)
    base = "scso_normal_matvec_bf16" if narrow else "scso_normal_matvec"
    with torch.cuda.device(A.device):
        rc = launch.entry(base, dt)(
            A.data_ptr(), w.data_ptr(), v.data_ptr(), partials.data_ptr(),
            out.data_ptr(), m, n, nblk, int(wide), groups,
            launch.stream(A.device))
    build.check(rc, "normal_matvec")
    counters.bump("normal_matvec")
    if narrow:
        counters.bump("normal_matvec_bf16")
    nancheck.check("normal_matvec", out, (A, w, v))
    return out


def _sharded(matvec, A, w, v, mesh, overlap_chunks, data_axis="data"):
    """The K1s schedule over the group of ``mesh``'s axis ``data_axis``.
    ``overlap_chunks <= 1``: ``matvec`` on the local rows, then one
    all_reduce (under ``torch.func.vmap``, the batched solve, one
    all_reduce of every instance's result: `ops.collective.group_sum`).
    Otherwise the JAX package's overlapped form: u = w∘(A·v) once (a
    matrix product, as there), then Aᵀu in c = min(overlap_chunks,
    max(1, n // 128)) column chunks, each chunk's sum issued as soon as
    its product is done, in order, on the current stream
    (`ops.collective.sum_in_place`: so the same program runs timed,
    uncaptured, captured into a fused solve's graph over NCCL ranks, and
    exported). The chunking alone sets the bits. The local shard is read
    twice: it pays only where the collective dominates. A bfloat16 A is
    upcast to w's dtype for its products (a temporary of the shard's
    size): the overlapped form never runs K1."""
    group = mesh.axis_group(data_axis)
    if overlap_chunks <= 1 or is_colshard(A):
        return group_sum(matvec(A, w, v), group, inplace=True)
    A = widen(A, w.dtype)
    n = A.shape[1]
    c = min(overlap_chunks, max(1, n // 128))
    h = -(-n // c)
    u = w * (A @ v)
    outs = []
    for i in range(c):
        part = A[:, i * h:(i + 1) * h].T @ u
        sum_in_place(part, group)
        outs.append(part)
    return torch.cat(outs)


def _check_axis(mesh, data_axis):
    if data_axis not in mesh.axis_names:
        raise ValueError(f"normal_matvec_sharded: axis {data_axis!r} is not "
                         f"in the mesh's {mesh.axis_names}")


def normal_matvec_sharded_torch(A, w, v, mesh, data_axis="data",
                                overlap_chunks=1):
    """Plain K1s: the same schedule with :func:`normal_matvec_torch`,
    on any device (the solver's 'torch' path)."""
    _check_axis(mesh, data_axis)
    return _sharded(normal_matvec_torch, A, w, v, mesh, overlap_chunks,
                    data_axis)


def normal_matvec_sharded(A, w, v, mesh, data_axis="data",
                          overlap_chunks=1):
    """Row-sharded Aᵀ(w∘(Av)) summed over ``mesh[data_axis]``: A (m/S,
    n) and w (m/S,) this rank's rows, v (n,) and the result replicated;
    A may be bfloat16, as for K1. K1 (counted as ``normal_matvec``)
    plus the all_reduce for CUDA
    tensors, counted once a call as ``normal_matvec_sharded``; the plain
    version for CPU tensors. Never falls back for a CUDA tensor. The
    overlapped form (``overlap_chunks > 1``) launches no K1: its
    contractions are matrix products, as in the JAX package, and it
    counts nothing."""
    if launch.on_cpu(A, "normal_matvec_sharded"):
        return normal_matvec_sharded_torch(A, w, v, mesh, data_axis,
                                           overlap_chunks)
    _check_axis(mesh, data_axis)
    out = _sharded(normal_matvec, A, w, v, mesh, overlap_chunks, data_axis)
    if overlap_chunks <= 1:
        counters.bump("normal_matvec_sharded")
    nancheck.check("normal_matvec_sharded", out, (A, w, v))
    return out
