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
instead). The bfloat16-A variant is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from scso_tpu_torch.ops.cuda import build, counters, launch

# dynamic shared memory a block may use: Hopper's 227 KB less headroom
# for the kernel's static buffers
_SMEM_BYTES = 224 * 1024
_SM_SMEM_BYTES = 228 * 1024     # shared memory of one SM
_SM_BLOCK_OVERHEAD = 2 * 1024   # per block: reserved + static buffers
_THREADS = 512                  # kThreads in csrc/matvec.cu
_ROWS_PER_STEP = 2              # kRows in csrc/matvec.cu


def normal_matvec_torch(A, w, v):
    """Plain PyTorch Aᵀ(w ∘ (A v)): two matrix-vector products, A read
    twice."""
    return A.T @ (w * (A @ v))


def max_n(dtype) -> int:
    """Largest n of the shared-memory form: v plus one accumulator in
    shared memory (28672 in float32, 14336 in float64)."""
    return _SMEM_BYTES // (2 * torch.empty((), dtype=dtype).element_size())


def normal_matvec(A, w, v):
    """Aᵀ(w ∘ (A v)) — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Never falls back for a CUDA tensor: an
    operand the kernel does not take raises."""
    if launch.on_cpu(A, "normal_matvec"):
        return normal_matvec_torch(A, w, v)
    m, n = A.shape
    launch.check_operands("normal_matvec", A.dtype, A.device, A=A, w=w, v=v)
    if w.shape != (m,) or v.shape != (n,):
        raise ValueError(f"normal_matvec: shapes A {tuple(A.shape)}, "
                         f"w {tuple(w.shape)}, v {tuple(v.shape)}")
    out = torch.empty((n,), dtype=A.dtype, device=A.device)
    if m == 0 or n == 0:
        return out.zero_()
    wide = n > max_n(A.dtype)
    # as many resident blocks as fit on each SM: one wave, each block
    # owning a contiguous row range (measured on the H100: a second,
    # partial wave of blocks costs more than the extra occupancy buys)
    smem = 0 if wide else 2 * n * A.element_size()
    per_sm = max(1, min(2048 // _THREADS,
                        _SM_SMEM_BYTES // (smem + _SM_BLOCK_OVERHEAD)))
    sms = launch.sm_count(A.device.index or 0)
    nblk = max(1, min(sms * per_sm, -(-m // _ROWS_PER_STEP)))
    partials = torch.empty((nblk, n), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        rc = launch.entry("scso_normal_matvec", A.dtype)(
            A.data_ptr(), w.data_ptr(), v.data_ptr(), partials.data_ptr(),
            out.data_ptr(), m, n, nblk, int(wide), launch.stream(A.device))
    build.check(rc, "normal_matvec")
    counters.bump("normal_matvec")
    return out


def _sharded(matvec, A, w, v, mesh, overlap_chunks):
    """The K1s schedule over ``mesh.group``. ``overlap_chunks <= 1``:
    ``matvec`` on the local rows, then one all_reduce. Otherwise the
    JAX package's overlapped form: u = w∘(A·v) once (a matrix product,
    as there), then Aᵀu in c = min(overlap_chunks, max(1, n // 128))
    column chunks, each chunk's all_reduce issued as soon as its product
    is done (async), so chunk i's collective overlaps chunk i+1's
    product; every handle is waited on before the concatenation, which
    orders the reads after the collectives on the compute stream. The
    local shard is then read twice: it pays only where the collective
    dominates."""
    if overlap_chunks <= 1:
        out = matvec(A, w, v)
        dist.all_reduce(out, group=mesh.group)
        return out
    n = A.shape[1]
    c = min(overlap_chunks, max(1, n // 128))
    h = -(-n // c)
    u = w * (A @ v)
    outs, works = [], []
    for i in range(c):
        part = A[:, i * h:(i + 1) * h].T @ u
        works.append(dist.all_reduce(part, group=mesh.group, async_op=True))
        outs.append(part)
    for work in works:
        work.wait()
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
    return _sharded(normal_matvec_torch, A, w, v, mesh, overlap_chunks)


def normal_matvec_sharded(A, w, v, mesh, data_axis="data",
                          overlap_chunks=1):
    """Row-sharded Aᵀ(w∘(Av)) summed over ``mesh[data_axis]``: A (m/S,
    n) and w (m/S,) this rank's rows, v (n,) and the result replicated.
    K1 (counted as ``normal_matvec``) plus the all_reduce for CUDA
    tensors, counted once a call as ``normal_matvec_sharded``; the plain
    version for CPU tensors. Never falls back for a CUDA tensor. The
    overlapped form (``overlap_chunks > 1``) launches no K1: its
    contractions are matrix products, as in the JAX package, and it
    counts nothing."""
    if launch.on_cpu(A, "normal_matvec_sharded"):
        return normal_matvec_sharded_torch(A, w, v, mesh, data_axis,
                                           overlap_chunks)
    _check_axis(mesh, data_axis)
    out = _sharded(normal_matvec, A, w, v, mesh, overlap_chunks)
    if overlap_chunks <= 1:
        counters.bump("normal_matvec_sharded")
    return out
