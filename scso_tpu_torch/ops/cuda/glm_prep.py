"""K2: the dual-candidate GLM epoch prep.

Port of `scso_tpu/ops/pallas/glm_prep.py` (`_fused_glm_prep_pair`): for
two candidate iterates (the greedy trial x_t and the SCORE-damped x_d)
it gives each candidate's CG matvec weights, RHS pullback, Jacobi
diagonal and loss sum — the greedy accept test, the next epoch's CG
prep and the stats objective in one call. The CUDA kernel is
``csrc/glm_prep.cu``, specialised on the logistic01 GLM in the ggn
flavour (the TPU kernel traces arbitrary Python callables, which CUDA
cannot); :func:`glm_prep_pair_torch` is the plain version, and
:func:`glm_prep_torch` its single-candidate form.

The TPU's n ≥ 8192 gate (`steps._use_pair_kernel`) is not carried over:
the kernel takes any m and n. The single-candidate kernel K2s and the
newton/least-squares/Poisson kinds are not ported yet (ROADMAP B5, B2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scso_tpu_torch.ops.cuda import build, counters, launch

KERNEL_KINDS = ("logistic01",)


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


def glm_prep_torch(A, y, x, glm):
    """Plain single-candidate prep: (w, Aᵀρ, Σᵢ wᵢAᵢⱼ², Σᵢ ℓᵢ) at x, with
    ρ, w, ℓ = the spec's ggn_rw, ggn_w, loss_sample.

    ``Σᵢ wᵢAᵢⱼ²`` materialises an A-sized temporary (w·A, then the
    contraction with A): about 8 GB at the full 196608×10112 float32
    width. The CUDA kernel needs none."""
    z = A @ x
    w = glm.ggn_w(y, z)
    return (w, A.T @ glm.ggn_rw(y, z), torch.einsum("i,ij,ij->j", w, A, A),
            torch.sum(glm.loss_sample(y, z)))


def glm_prep_pair_torch(A, y, x_t, x_d, glm) -> PairPrep:
    """Plain dual-candidate prep: :func:`glm_prep_torch` at each
    candidate (same A-sized temporary, twice)."""
    wt, bt, ht, lt = glm_prep_torch(A, y, x_t, glm)
    wd, bd, hd, ld = glm_prep_torch(A, y, x_d, glm)
    return PairPrep(wt, wd, bt, bd, ht, hd, lt, ld)


def glm_prep_pair(A, y, x_t, x_d, glm) -> PairPrep:
    """Dual-candidate prep — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. For a CUDA tensor a spec kind the kernel
    does not cover raises."""
    if launch.on_cpu(A, "glm_prep_pair"):
        return glm_prep_pair_torch(A, y, x_t, x_d, glm)
    if glm is None or glm.kind not in KERNEL_KINDS or not glm.sample_normalized:
        raise ValueError(
            f"glm_prep_pair: the CUDA kernel covers GLM kinds "
            f"{KERNEL_KINDS}; got {getattr(glm, 'kind', None)!r} "
            "(ROADMAP B2)")
    m, n = A.shape
    launch.check_operands("glm_prep_pair", A.dtype, A.device, A=A, y=y,
                          x_t=x_t, x_d=x_d)
    if y.shape != (m,) or x_t.shape != (n,) or x_d.shape != (n,):
        raise ValueError(
            f"glm_prep_pair: shapes A {tuple(A.shape)}, y {tuple(y.shape)}, "
            f"x_t {tuple(x_t.shape)}, x_d {tuple(x_d.shape)}")
    if m == 0:
        raise ValueError("glm_prep_pair: A has no rows")
    dev, dt = A.device, A.dtype
    # rows pass: one warp per row, 8 warps per block, up to 8 blocks per
    # SM; columns pass: 256 threads per block, each on one 16-byte chunk
    # of columns (the kernel's vector width), enough row chunks for ~8
    # blocks per SM
    sms = launch.sm_count(dev.index or 0)
    row_blocks = max(1, min(8 * sms, -(-m // 8)))
    vec = 16 // A.element_size()
    col_tiles = -(-(n // vec if n % vec == 0 else n) // 256)
    chunks = max(1, min(-(-8 * sms // col_tiles), -(-m // 256)))
    empty = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype,
                                                 device=dev)
    w_t, w_d = empty(m), empty(m)
    rw = empty(2, m)
    b_t, b_d, hd_t, hd_d = empty(n), empty(n), empty(n), empty(n)
    loss_t, loss_d = empty(), empty()
    col_partials = empty(chunks, 4, n, dtype=torch.float64)
    loss_partials = empty(row_blocks, 2, dtype=torch.float64)
    with torch.cuda.device(dev):
        rc = launch.entry("scso_glm_prep_pair", dt)(
            A.data_ptr(), y.data_ptr(), x_t.data_ptr(), x_d.data_ptr(),
            w_t.data_ptr(), w_d.data_ptr(), rw.data_ptr(),
            b_t.data_ptr(), b_d.data_ptr(), hd_t.data_ptr(),
            hd_d.data_ptr(), loss_t.data_ptr(), loss_d.data_ptr(),
            col_partials.data_ptr(), loss_partials.data_ptr(),
            m, n, row_blocks, chunks, launch.stream(dev))
    build.check(rc, "glm_prep_pair")
    counters.bump("glm_prep_pair")
    return PairPrep(w_t, w_d, b_t, b_d, hd_t, hd_d, loss_t, loss_d)
