"""K5: the fused multi-output GGN matvec V ↦ Aᵀ·quad(y, Z, A·V).

Port of `scso_tpu/ops/pallas/mglm_matvec.py` (`_fused_mglm_matvec`), the
op of every CG iteration on the multi-output (mglm) path. The CUDA
kernel is ``csrc/mglm_matvec.cu`` (its source note gives the design),
specialised on the multinomial spec (``MOGLMSpec.kind ==
'multinomial'``), since CUDA cannot trace the spec's Python ``quad`` as
the TPU kernel does; :func:`mglm_matvec_torch` is the plain PyTorch
version of the same function.

The TPU layout gates (`supports_fused_mglm_matvec`,
`_pick_block_rows_mglm`, the lane/sublane split, `_KP`) came from VMEM
and T(8,128) tiling and are not carried over: the kernel takes any m and
p and 1 ≤ k ≤ 128. It reads A once for k ≤ 16 and p ≤ 1024 (the fused
form) and twice otherwise (the two-pass form).
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.cuda import build, counters, launch

KERNEL_KINDS = ("multinomial",)
MAX_K = 128
_FUSED_MAX_K = 16
_FUSED_MAX_P = 1024     # 256 threads × 4 columns each (csrc)
_COL_THREADS = 256      # kColThreads in csrc/mglm_matvec.cu
_KC = 16                # kKC in csrc/mglm_matvec.cu


def mglm_matvec_torch(A, y, Z, V, spec):
    """Plain PyTorch Aᵀ·quad(y, Z, A·V): two matrix products, A read
    twice."""
    return A.T @ spec.quad(y, Z, A @ V)


def mglm_matvec(A, y, Z, V, spec):
    """Aᵀ·quad(y, Z, A·V) as (p, k) — the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. For a CUDA tensor a spec kind the
    kernel does not cover, or k > 128, raises."""
    if launch.on_cpu(A, "mglm_matvec"):
        return mglm_matvec_torch(A, y, Z, V, spec)
    if (spec is None or spec.kind not in KERNEL_KINDS
            or not spec.sample_normalized):
        raise ValueError(
            f"mglm_matvec: the CUDA kernel covers MOGLM kinds "
            f"{KERNEL_KINDS}; got {getattr(spec, 'kind', None)!r} "
            "(ROADMAP A9)")
    m, p = A.shape
    launch.check_operands("mglm_matvec", A.dtype, A.device, A=A, y=y, Z=Z,
                          V=V)
    k = V.shape[-1] if V.ndim == 2 else -1
    if V.shape != (p, k) or Z.shape != (m, k) or y.shape != (m, k):
        raise ValueError(
            f"mglm_matvec: shapes A {tuple(A.shape)}, y {tuple(y.shape)}, "
            f"Z {tuple(Z.shape)}, V {tuple(V.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"mglm_matvec: k = {k}; the kernel takes 1 to "
                         f"{MAX_K} outputs")
    if m == 0 or p == 0:
        raise ValueError("mglm_matvec: A has no rows or no columns")
    fused = k <= _FUSED_MAX_K and p <= _FUSED_MAX_P
    dev, dt = A.device, A.dtype
    sms = launch.sm_count(dev.index or 0)
    if fused:
        # one block per SM (the accumulators fill the registers), each
        # owning a contiguous row range
        nblk = max(1, min(sms, -(-m // 4)))
        qu = None
        vk = V
    else:
        # row chunks for the column pass: ~8 blocks per SM in all
        tiles = -(-p // _COL_THREADS) * -(-k // _KC)
        nblk = max(1, min(-(-8 * sms // tiles), -(-m // 256), 65535))
        qu = torch.empty((m, k), dtype=dt, device=dev)
        vk = V.t().contiguous()  # the row pass reads V transposed
    partials = torch.empty((nblk, p * k), dtype=dt, device=dev)
    out = torch.empty((p, k), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = launch.entry("scso_mglm_matvec", dt)(
            A.data_ptr(), Z.data_ptr(), vk.data_ptr(),
            None if qu is None else qu.data_ptr(), partials.data_ptr(),
            out.data_ptr(), m, p, k, nblk, int(fused), launch.stream(dev))
    build.check(rc, "mglm_matvec")
    counters.bump("mglm_matvec")
    return out
