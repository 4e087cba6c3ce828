"""K2 and K2s: the GLM epoch prep.

Port of `scso_tpu/ops/pallas/glm_prep.py`:
  * K2 (`_fused_glm_prep_pair`, :func:`glm_prep_pair`): for two
    candidate iterates (the greedy trial x_t and the SCORE-damped x_d)
    each candidate's CG matvec weights, RHS pullback, Jacobi diagonal
    and loss sum — the greedy accept test, the next epoch's CG prep and
    the stats objective in one call (the epoch-cache path);
  * K2s (`_fused_glm_prep`, :func:`glm_prep`): the same at one x, with
    no loss — the prep of the uncached GGN-CG path.
Both kernels are ``csrc/glm_prep.cu``, specialised on the logistic01 GLM
in the ggn flavour (the TPU kernels trace arbitrary Python callables,
which CUDA cannot); :func:`glm_prep_torch` and
:func:`glm_prep_pair_torch` are the plain versions.

The TPU's n ≥ 8192 gates (`steps._use_pair_kernel`, the AUTO
`use_fused_prep`) are not carried over: the kernels take any m and n.
The newton flavour and the least-squares/Poisson kinds are not ported
yet (ROADMAP B2).
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


def _check_kind(name, glm):
    if glm is None or glm.kind not in KERNEL_KINDS or not glm.sample_normalized:
        raise ValueError(
            f"{name}: the CUDA kernel covers GLM kinds {KERNEL_KINDS}; got "
            f"{getattr(glm, 'kind', None)!r} (ROADMAP B2)")


def _grid(A):
    """(row_blocks, chunks) for the two passes over A: the rows pass runs
    one warp per row, 8 warps per block, up to 8 blocks per SM; the
    columns pass 256 threads per block, each on one 16-byte chunk of
    columns (the kernel's vector width), with enough row chunks for ~8
    blocks per SM."""
    m, n = A.shape
    sms = launch.sm_count(A.device.index or 0)
    row_blocks = max(1, min(8 * sms, -(-m // 8)))
    vec = 16 // A.element_size()
    col_tiles = -(-(n // vec if n % vec == 0 else n) // 256)
    chunks = max(1, min(-(-8 * sms // col_tiles), -(-m // 256)))
    return row_blocks, chunks


def _check_shapes(name, A, y, *xs):
    m, n = A.shape
    if y.shape != (m,) or any(x.shape != (n,) for x in xs):
        raise ValueError(
            f"{name}: shapes A {tuple(A.shape)}, y {tuple(y.shape)}, x "
            f"{[tuple(x.shape) for x in xs]}")
    if m == 0:
        raise ValueError(f"{name}: A has no rows")


def glm_prep(A, y, x, glm):
    """Single-candidate prep (w, Aᵀρ, Σᵢ wᵢAᵢⱼ²) at x — the K2s kernel
    for CUDA tensors, the plain version for CPU tensors. For a CUDA
    tensor a spec kind the kernel does not cover raises."""
    if launch.on_cpu(A, "glm_prep"):
        return glm_prep_torch(A, y, x, glm)[:3]
    _check_kind("glm_prep", glm)
    launch.check_operands("glm_prep", A.dtype, A.device, A=A, y=y, x=x)
    _check_shapes("glm_prep", A, y, x)
    m, n = A.shape
    dev, dt = A.device, A.dtype
    row_blocks, chunks = _grid(A)
    empty = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype,
                                                 device=dev)
    w, rw, b, hd = empty(m), empty(m), empty(n), empty(n)
    col_partials = empty(chunks, 2, n, dtype=torch.float64)
    with torch.cuda.device(dev):
        rc = launch.entry("scso_glm_prep", dt)(
            A.data_ptr(), y.data_ptr(), x.data_ptr(), w.data_ptr(),
            rw.data_ptr(), b.data_ptr(), hd.data_ptr(),
            col_partials.data_ptr(), m, n, row_blocks, chunks,
            launch.stream(dev))
    build.check(rc, "glm_prep")
    counters.bump("glm_prep")
    return w, b, hd


def glm_prep_pair(A, y, x_t, x_d, glm) -> PairPrep:
    """Dual-candidate prep — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. For a CUDA tensor a spec kind the kernel
    does not cover raises."""
    if launch.on_cpu(A, "glm_prep_pair"):
        return glm_prep_pair_torch(A, y, x_t, x_d, glm)
    _check_kind("glm_prep_pair", glm)
    launch.check_operands("glm_prep_pair", A.dtype, A.device, A=A, y=y,
                          x_t=x_t, x_d=x_d)
    _check_shapes("glm_prep_pair", A, y, x_t, x_d)
    m, n = A.shape
    dev, dt = A.device, A.dtype
    row_blocks, chunks = _grid(A)
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
