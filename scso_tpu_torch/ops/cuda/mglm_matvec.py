"""K5: the fused multi-output GGN matvec V ↦ Aᵀ·quad(y, Z, A·V).

Port of `scso_tpu/ops/pallas/mglm_matvec.py` (`_fused_mglm_matvec`), the
op of every CG iteration on the multi-output (mglm) path. The CUDA
kernel is ``csrc/mglm_matvec.cu`` (its source note gives the design);
:func:`mglm_matvec_torch` is the plain PyTorch version of the same
function. The TPU kernel traces the spec's Python ``quad`` into its
body, which CUDA cannot: the tensor-core and two-pass forms compute the
multinomial curvature in the kernel (:func:`covers`), and any other
spec runs the split form: U = A·V and Aᵀ·QU as the kernel's two passes
over A, the spec's own ``quad`` in PyTorch between them.

The TPU layout gates (`supports_fused_mglm_matvec`,
`_pick_block_rows_mglm`, the lane/sublane split, `_KP`) came from VMEM
and T(8,128) tiling and are not carried over: the kernel takes any m, p
and k. :func:`mglm_grid` picks its form from the shapes and the spec:
the tensor-core form (float32, k ≤ :data:`TC_MAX_K`, p ≤
:data:`TC_MAX_P`) reads A once, the two-pass form (float64 and larger k
or p) and the split form read it twice.

A may be stored in bfloat16 (the coarse phase of
`algorithms.mixed.iterate_mixed`, and the copy of precision-adaptive CG
on the cached path, `steps._mo_lp_matvec`) with y, Z and V in float32
or float64: every form takes A's values upcast exactly, as the TPU
kernel does, and the result comes out in V's dtype. The tensor-core
form takes a bfloat16 A as the bfloat16 operand of the tensor cores and
V and QU as three bfloat16 pieces each, whose sum is the float32 value
(``csrc/mglm_matvec.cu``, namespace ``tcb``). Such a launch counts as
``mglm_matvec_bf16`` as well as ``mglm_matvec``. The plain version
upcasts A to V's dtype first (exact).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.cuda import build, counters, launch
from scso_tpu_torch.ops.dense import amul, atmul, is_colshard, widen

KERNEL_KINDS = ("multinomial",)
#: the tensor-core form's limits: its (p × k) accumulators in the
#: registers of 16 warps, two 16-row stages of A and V in shared memory
#: (csrc/mglm_matvec.cu, namespace tc)
TC_MAX_K = 16
TC_MAX_P = 1024
TC_BF16_STAGES = 6      # kMaxStages in csrc/mglm_matvec.cu (tcb)
_SM_SMEM_BYTES = 228 * 1024     # shared memory of one SM
_SM_BLOCK_OVERHEAD = 2 * 1024   # per block: reserved + static buffers
_TC_SMEM_BUDGET = 232448  # the shared memory a block may take (H100)
_THREADS = 256          # the two-pass and split forms' column kernel
_TC_ROWS = 16           # rows of a tensor-core tile
_KC = 16                # kKC in csrc/mglm_matvec.cu
# the C entry's form codes; "split" is its passes "split_rows" (U = A·V,
# no sum) and "split_cols" (Aᵀ·QU)
FORM_CODES = {"two_pass": 0, "tensor": 1, "split_rows": 2, "split_cols": 3}


class MglmGrid(NamedTuple):
    """Launch geometry of one K5 call (see :func:`mglm_grid`)."""

    form: str            # "tensor" (A read once), "two_pass" or "split"
    blocks: int          # blocks (two-pass, split: row chunks), a partial each
    rows_per_block: int  # rows of each block (two-pass, split: of each chunk)
    smem_bytes: int      # dynamic shared memory a block
    threads: int         # threads a block


def tc_geometry(p, k):
    """(warps, padded p, n8 tiles of classes) of the tensor-core form:
    p padded to 128 (8 warps of 16 columns), 256, 512 or 1024 (16 warps
    of 16, 32 or 64 columns); k to 8 or 16."""
    pp = next(c for c in (128, 256, 512, 1024) if p <= c)
    return (8 if pp == 128 else 16), pp, (1 if k <= 8 else 2)


def tc_stages(p, k, a_dtype=torch.float32) -> int:
    """Stages of A the tensor-core form keeps: two with A in float32;
    with A in bfloat16 the ring's, the most up to :data:`TC_BF16_STAGES`
    that fit 232,448 bytes beside V's three pieces (csrc/mglm_matvec.cu,
    namespace tcb)."""
    if a_dtype != torch.bfloat16:
        return 2
    w, pp, nt = tc_geometry(p, k)
    fixed = _bf16_fixed_bytes(w, pp, nt)
    return min(TC_BF16_STAGES,
               (_TC_SMEM_BUDGET - fixed - 8 * TC_BF16_STAGES)
               // _bf16_stage_bytes(pp))


def tc_blocks_per_sm(p, k) -> int:
    """Blocks an SM of the tensor-core form with A in bfloat16, as its
    registers are bounded (blocks_per_sm in csrc/mglm_matvec.cu): 3 at
    p <= 128, 2 at p <= 256, else 1."""
    w, pp, _ = tc_geometry(p, k)
    return 3 if w == 8 else 2 if pp == 256 else 1


def _bf16_stage_bytes(pp):
    """A 16-row stage of a bfloat16 A, rows padded by 16 bytes."""
    return _TC_ROWS * (pp + 8) * 2


def _bf16_fixed_bytes(w, pp, nt):
    """V's three bfloat16 pieces in fragment order, the warps' partial U
    and QU's three pieces (bfloat16 tensor-core form)."""
    return 3 * pp * nt * 16 + 4 * w * _TC_ROWS * 8 * nt + 3 * nt * 32 * 8


def tc_smem_bytes(p, k, a_dtype=torch.float32) -> int:
    """Shared memory of the tensor-core form. A in float32: two 16-row
    stages of A, then, in float32, V in fragment order, the warps'
    partial U and QU's fragments. A in bfloat16: :func:`tc_stages`
    16-row stages of A (rows padded by 16 bytes), V's and QU's three
    bfloat16 pieces in fragment order, the partial U, one mbarrier a
    stage."""
    w, pp, nt = tc_geometry(p, k)
    if a_dtype == torch.bfloat16:
        s = tc_stages(p, k, a_dtype)
        return s * _bf16_stage_bytes(pp) + _bf16_fixed_bytes(w, pp, nt) + 8 * s
    return (a_dtype.itemsize * 2 * _TC_ROWS * pp
            + 4 * (pp * nt * 8 + w * _TC_ROWS * 8 * nt + 2 * nt * 32 * 2))


def _two_pass_grid(m, p, k, sms, form) -> MglmGrid:
    """The two-pass (or split) geometry: enough row chunks for the column
    pass to give about 8 blocks an SM."""
    tiles = -(-p // _THREADS) * -(-k // _KC)
    rows = -(-m // max(1, min(-(-8 * sms // tiles), -(-m // 256), 65535)))
    return MglmGrid(form, -(-m // rows), rows, 0, _THREADS)


def mglm_grid(m, p, k, dtype, sms, covered=True, a_dtype=None) -> MglmGrid:
    """The form and launch geometry for A (m, p) stored in ``a_dtype``
    (default ``dtype``; else bfloat16), k classes, computed in
    ``dtype``, on a card with ``sms`` SMs, from the shapes and
    ``covered`` (:func:`covers` of the spec) alone.

    Tensor-core form (covered, float32, k <= 16, p <= 1024, A in float32
    or bfloat16): one block an SM (A's two stages and V fill its shared
    memory, and its 512 threads its registers), each owning a
    contiguous row range, every row in exactly one block; with A in
    bfloat16 :func:`tc_blocks_per_sm` blocks an SM where shared memory
    allows, each a range of whole 16-row tiles. Two-pass form
    (covered, any other k, p or type) and split form (not covered): the
    two-pass geometry."""
    if not covered:
        return _two_pass_grid(m, p, k, sms, "split")
    if dtype == torch.float32 and k <= TC_MAX_K and p <= TC_MAX_P:
        smem = tc_smem_bytes(p, k, a_dtype or dtype)
        threads = 32 * tc_geometry(p, k)[0]
        if a_dtype == torch.bfloat16:
            per_sm = min(tc_blocks_per_sm(p, k),
                         _SM_SMEM_BYTES // (smem + _SM_BLOCK_OVERHEAD))
            rows = _TC_ROWS * -(-m // (_TC_ROWS * max(
                1, min(per_sm * sms, -(-m // _TC_ROWS)))))
        else:
            rows = -(-m // max(1, min(sms, -(-m // _TC_ROWS))))
        return MglmGrid("tensor", -(-m // rows), rows, smem, threads)
    return _two_pass_grid(m, p, k, sms, "two_pass")


def covers(spec) -> bool:
    """True for an MOGLM spec whose curvature the kernel computes itself
    (the tensor-core and two-pass forms): a kind in
    :data:`KERNEL_KINDS`, normalized by 1/m. Any other spec takes the
    split form."""
    return spec.kind in KERNEL_KINDS and spec.sample_normalized


def _norm_fix(spec, m, m_norm):
    """A sample-normalized spec's 1/m (the rows handed over) rescaled to
    1/m_norm: the JAX kernel's ``m_total`` (a row shard's rows of all
    ranks, `Problem.m_total`). The identity where m_norm is m."""
    if m_norm is None or int(m_norm) == m or not spec.sample_normalized:
        return lambda out: out
    return lambda out: out * (m / int(m_norm))


def mglm_matvec_torch(A, y, Z, V, spec, m_norm=None):
    """Plain PyTorch Aᵀ·quad(y, Z, A·V): two matrix products, A read
    twice, normalized by ``m_norm`` rows (default A's). A bfloat16 A is
    first upcast to V's dtype (exact): an A-sized temporary. On a column
    shard (`ops.dense.ColShard`) the products of `ops.dense`."""
    fix = _norm_fix(spec, A.shape[0], m_norm)
    if is_colshard(A):
        return fix(atmul(A, spec.quad(y, Z, amul(A, V))))
    A = widen(A, V.dtype)
    return fix(A.T @ spec.quad(y, Z, A @ V))


def mglm_matvec(A, y, Z, V, spec, m_norm=None):
    """Aᵀ·quad(y, Z, A·V) as (p, k) — the CUDA kernel for CUDA tensors,
    in the form :func:`mglm_grid` picks, the plain version for CPU
    tensors. A is in V's dtype (float32 or float64) or in bfloat16; the
    result is in V's. The kernel divides the spec's curvature by the m
    rows it reads; ``m_norm`` (a row shard's rows of all ranks) rescales
    its (p, k) result by m/m_norm, as the plain version does."""
    if launch.on_cpu(A, "mglm_matvec"):
        return mglm_matvec_torch(A, y, Z, V, spec, m_norm)
    m, p = A.shape
    launch.check_operands("mglm_matvec", V.dtype, A.device, narrow=("A",),
                          A=A, y=y, Z=Z, V=V)
    k = V.shape[-1] if V.ndim == 2 else -1
    if V.shape != (p, k) or Z.shape != (m, k) or y.shape != (m, k):
        raise ValueError(
            f"mglm_matvec: shapes A {tuple(A.shape)}, y {tuple(y.shape)}, "
            f"Z {tuple(Z.shape)}, V {tuple(V.shape)}")
    if m == 0 or p == 0 or k == 0:
        raise ValueError("mglm_matvec: A has no rows or no columns, or "
                         "there are no classes")
    grid = mglm_grid(m, p, k, V.dtype, launch.sm_count(A.device.index or 0),
                     covers(spec), A.dtype)
    return _norm_fix(spec, m, m_norm)(_launch(A, y, Z, V, spec, grid))


def _launch(A, y, Z, V, spec, grid):
    """K5 on checked CUDA operands in ``grid``'s form and geometry (the
    split form applies ``spec.quad`` between its passes); one count."""
    (m, p), k = A.shape, V.shape[1]
    dev, dt = A.device, V.dtype
    narrow = A.dtype == torch.bfloat16
    if launch.use_ops():
        return _op(A, y, Z, V, spec, grid)
    partials = torch.empty((grid.blocks, p * k), dtype=dt, device=dev)
    out = torch.empty((p, k), dtype=dt, device=dev)

    def run(form, v, qu):
        with torch.cuda.device(dev):
            rc = launch.entry("scso_mglm_matvec_bf16" if narrow
                              else "scso_mglm_matvec", dt)(
                A.data_ptr(), Z.data_ptr(), v.data_ptr(),
                None if qu is None else qu.data_ptr(), partials.data_ptr(),
                out.data_ptr(), m, p, k, grid.blocks, grid.rows_per_block,
                FORM_CODES[form], launch.stream(dev))
        build.check(rc, "mglm_matvec")

    if grid.form == "tensor":
        run("tensor", V, None)
    else:
        qu = torch.empty((m, k), dtype=dt, device=dev)
        vt = V.t().contiguous()  # the row pass reads V transposed
        if grid.form == "two_pass":
            run("two_pass", vt, qu)
        else:
            run("split_rows", vt, qu)  # U = A·V into qu
            qu = spec.quad(y, Z, qu).to(dt).contiguous()
            run("split_cols", vt, qu)
    counters.bump("mglm_matvec")
    if narrow:
        counters.bump("mglm_matvec_bf16")
    nancheck.check("mglm_matvec", out, (A, y, Z, V))
    return out


def _op(A, y, Z, V, spec, grid):
    """:func:`_launch` through the custom op ``scso::mglm_matvec``."""
    op = lambda v, qu, form: torch.ops.scso.mglm_matvec(
        A, Z, v, qu, grid.blocks, grid.rows_per_block, FORM_CODES[form])
    if grid.form == "tensor":
        return op(V, None, "tensor")[0]
    vt = V.t().contiguous()  # the row pass reads V transposed
    if grid.form == "two_pass":
        return op(vt, None, "two_pass")[0]
    qu = op(vt, None, "split_rows")[1]  # U = A·V
    qu = spec.quad(y, Z, qu).to(V.dtype).contiguous()
    return op(vt, qu, "split_cols")[0]
