"""K1: the fused normal-equation matvec v ↦ Aᵀ(w ∘ (A v)).

Port of `scso_tpu/ops/pallas/matvec.py` (`_fused_normal_matvec`), the op
of every CG iteration. The CUDA kernel is ``csrc/matvec.cu`` (its
source note gives the design); :func:`normal_matvec_torch` is the plain
PyTorch version of the same function.

The TPU shape gates (`supports_fused_normal_matvec`, `_MIN_N_BYTES`)
came from VMEM and T(8,128) tiling and are not carried over: the kernel
takes any m ≥ 0 and any n. Up to :func:`max_n` v and the per-block
accumulator live in shared memory; above it the kernel's wide form keeps
them in global memory (where the JAX package takes its XLA form
instead). The sharded form (K1s) and the bfloat16-A variant are not
ported yet (ROADMAP B4, A10).
"""

from __future__ import annotations

import torch

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
