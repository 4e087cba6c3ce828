"""The port's CUDA kernels and its solve on the card (marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (K2 in both its flavours; K2 and K2s also with the least-squares
and Poisson kinds computed in the kernel), and small float64 solves
through the kernels (GGN-CG, L-BFGS, Newton-CG; also on the group-lasso
and Poisson problems) against the plain path on the CPU. The group sums
and the group-lasso smoother rerun bitwise on the card.
K1s runs under a one-rank NCCL group, where it must be K1 bit for bit.
K1, K2 (both flavours), K2s and K5 with A in bfloat16 (the copy of
precision-adaptive CG, the coarse phase of iterate_mixed) are held
against their plain versions (A upcast to the other operands' dtype)
at the same tolerances as with A in that dtype, and never reach the
plain version on the card; small float64 iterate_mixed solves through
the kernels match the CPU. The solve loop's captured form (``mode='fused'``
on the card) is its eager form (``_capture=False``) bit for bit, for
each method, with the same launch counts (counted on the card under
replay), one capture serving chained solves; timed mode on the card
matches the CPU. The batched solve of a λ path (`parallel.sweep`) is
one capture serving all its waves, its eager form bit for bit, launches
none of the kernels, and matches the CPU in float64. Without a CUDA
device every test here skips.
This file imports neither jax nor scso_tpu, so it also runs on a GPU
machine without them — there, skip tests/conftest.py (which configures
jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances: float32 rtol 2e-5, atol 3e-5·max(1, max|ref|) (the f32
bounds of tests/test_pallas.py), for K5 in float32 an atol of
K5_F32_ATOL·max|ref| alone (no floor of 1: the tensor-core form's
split TF32 must hold float32 accuracy, and one TF32 product a
contraction falls outside it); float64 1e-12 of each; the small solves'
objective histories 1e-9 relative. Every kernel's rerun is bitwise
equal. TF32 is off for the plain versions' matrix products.
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu_torch as st
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.models.losses import LOGISTIC01_GLM
from scso_tpu_torch.ops import lbfgs_core
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import (
    glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
from scso_tpu_torch.ops.cuda.matvec import (
    normal_matvec, normal_matvec_sharded, normal_matvec_sharded_torch,
    normal_matvec_torch)
from scso_tpu_torch.ops.cuda import mglm_matvec as k5
from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_matvec, mglm_matvec_torch
from scso_tpu_torch.ops.cuda import launch
from scso_tpu_torch.ops.cuda import score_update as k3
from scso_tpu_torch.ops.cuda import two_loop as k4
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)
from scso_tpu_torch.ops.cuda.two_loop import two_loop, two_loop_torch
from scso_tpu_torch.parallel import distributed_init, make_mesh, shard_problem

from _torch_ranks import file_init

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 3e-5), torch.float64: (1e-12, 1e-12)}
#: K5's float32 limit over max|ref| (chip_smoke.py's TOL["k5"])
K5_F32_ATOL = 3e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, dtype):
    rtol, atol = TOL[dtype]
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * scale)


def _check_k5(got, want, dtype):
    if dtype == torch.float64:
        return _check(got, want, dtype)
    torch.testing.assert_close(got, want, rtol=0.0, atol=K5_F32_ATOL * float(
        want.abs().max()))


def _least_squares_glm():
    """A GLM spec the prep kernels do not compute themselves: squared
    loss, identity link, 1/m normalized, no ggn_rw/ggn_w."""
    return st.GLMSpec(
        link=lambda z: z, dlink=torch.ones_like,
        res=lambda y, yh: (yh - y) / y.shape[0],
        qdiag=lambda y, yh: torch.ones_like(yh) / y.shape[0],
        hvp_w=lambda y, z: torch.ones_like(z) / y.shape[0],
        gres=lambda y, z: (z - y) / y.shape[0],
        loss_z=lambda y, z: 0.5 * torch.mean((z - y) ** 2),
        loss_sample=lambda y, z: 0.5 * (z - y) ** 2, kind="least_squares")


def _squared_moglm(k):
    """An MOGLM spec K5 does not compute itself: squared loss on Z."""
    return st.MOGLMSpec(
        n_out=k, gres=lambda y, Z: (Z - y) / Z.shape[0],
        quad=lambda y, Z, U: U / Z.shape[0],
        qdiag_w=lambda y, Z: torch.ones_like(Z) / Z.shape[0],
        loss_z=lambda y, Z: 0.5 * torch.sum((Z - y) ** 2) / Z.shape[0],
        loss_sample=lambda y, Z: 0.5 * torch.sum((Z - y) ** 2, dim=-1))


# K2's one-pass form holds n <= 14336 in float32 and 7168 in float64
# (max_n); the first n past each limit runs the wide form. m = 1 and 5
# give fewer rows than blocks; odd m leaves a block a ragged row pair.
K2_SHAPES = [(37, 128), (947, 384), (3465, 2432), (999, 1001), (1, 256),
             (5, 1001), (1031, 14336), (1031, 14340), (517, 7168),
             (517, 7170)]
# K2s's: n <= 28672 in float32 and 14336 in float64
K2S_SHAPES = [(660, 256), (3465, 2432), (4099, 10112), (947, 384),
              (999, 1001), (1, 128), (5, 1001), (301, 28672), (301, 28676),
              (517, 14336), (517, 14338)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", K2_SHAPES)
def test_data_kernels_match_plain(dev, dtype, m, n):
    gen = torch.Generator(device=dev).manual_seed(m)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype)
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    counters.reset()
    _check(normal_matvec(A, w, v), normal_matvec_torch(A, w, v), dtype)
    got = glm_prep_pair(A, y, v * 0.1, v * 0.2, LOGISTIC01_GLM)
    want = glm_prep_pair_torch(A, y, v * 0.1, v * 0.2, LOGISTIC01_GLM)
    for g, w_ in zip(got, want):
        _check(g, w_, dtype)
    again = glm_prep_pair(A, y, v * 0.1, v * 0.2, LOGISTIC01_GLM)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    # one K1 launch and two K2 launches (the logistic01 kind, which has
    # no kind counter of its own); every other counter 0
    want = dict.fromkeys(counters.KERNEL_LAUNCHES, 0)
    want.update(normal_matvec=1, glm_prep_pair=2)
    assert counters.snapshot() == want


@pytest.mark.parametrize("dtype,m,n", [(torch.float32, 4099, 40000),
                                       (torch.float64, 2049, 20000)])
def test_normal_matvec_wide_n(dev, dtype, m, n):
    # above the shared-memory form's limit (28672 f32, 14336 f64)
    gen = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    got = normal_matvec(A, w, v)
    assert torch.equal(got, normal_matvec(A, w, v))
    _check(got, normal_matvec_torch(A, w, v), dtype)


# chip_smoke.py's K1 shapes: block boundaries, rows that are not
# 16-byte aligned in bfloat16 (n % 8 != 0: one value a load), and n
# above the shared-memory form (28672 for float32 v, 14336 for float64)
BF16_SHAPES = [(37, 128), (947, 384), (2249, 1920), (131, 128), (660, 256),
               (3465, 2432), (999, 1001), (64, 130), (517, 1020)]
BF16_WIDE = [(torch.float32, 4099, 40000), (torch.float64, 2049, 20000)]


def _bf16_inputs(dev, dtype, m, n):
    gen = torch.Generator(device=dev).manual_seed(m + n)
    A = (torch.randn((m, n), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    return A, w, v


@pytest.mark.parametrize("dtype,m,n", [
    (dt, m, n) for dt in (torch.float32, torch.float64)
    for (m, n) in BF16_SHAPES] + BF16_WIDE)
def test_bf16_matvec_matches_plain(dev, dtype, m, n):
    A, w, v = _bf16_inputs(dev, dtype, m, n)
    counters.reset()
    got = normal_matvec(A, w, v)
    assert got.dtype == dtype
    assert torch.equal(got, normal_matvec(A, w, v))  # bitwise rerun
    snap = counters.snapshot()
    assert snap["normal_matvec"] == snap["normal_matvec_bf16"] == 2
    _check(got, normal_matvec_torch(A, w, v), dtype)


def test_bf16_matvec_rejects_other_mixes(dev):
    A, w, v = _bf16_inputs(dev, torch.float32, 64, 128)
    for args in ((A, w.to(torch.bfloat16), v.to(torch.bfloat16)),
                 (A, w, v.double()),
                 (A.float(), w, v.to(torch.bfloat16)),
                 (A.float(), w.double(), v.double()),
                 (A.t(), v, w)):
        with pytest.raises(ValueError):
            normal_matvec(*args)


def test_small_lp_solve_matches_cpu(dev):
    """float64 with the bfloat16 copy, cg_adaptive=True and cg_lp_tol =
    1e-2 (the JAX package's EW regime): K1 on the copy in the loose
    epochs, on A in the others; the CPU plain path on the same copy."""
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             cg_adaptive=True, cg_lp_tol=1e-2)
    cpu = st.with_lp_copy(_small_logreg("cpu"))
    gpu = replace(_small_logreg(dev), A_lp=cpu.A_lp.to(dev))
    counters.reset()
    s_gpu = st.iterate(method, gpu, "l1", st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    assert 0 < got["normal_matvec_bf16"] < got["normal_matvec"]
    s_cpu = st.iterate(method, cpu, "l1", st.PHuberSmootherL1L2(1.0), **kw)
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


def _mglm_inputs(dev, dtype, m, p, k):
    gen = torch.Generator(device=dev).manual_seed(m * 131 + p * 7 + k)
    A = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, k, (m,), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(labels, k).to(dtype)
    W = torch.randn((p, k), generator=gen, device=dev, dtype=dtype) * 0.3
    V = torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
    return A, y, A @ W, V


# boundary shapes, the widest p of the tensor-core form (f32, k <= 16,
# p <= 1024) and the first past it, then k across the forms; the
# tensor-core form on both sides of its k and p limits, of each of its
# paddings (p 128/256/512, k 8) and with rows that are not 16-byte
# aligned (p % 4 != 0), and any k of the two-pass form
MGLM_SHAPES = ([(512, 128, 8), (700, 256, 4), (130, 128, 3), (16, 1, 2),
                (33, 5, 7), (8, 12, 2), (64, 4, 11), (300, 1024, 16),
                (300, 1025, 9), (300, 1025, 2)]
               + [(1031, 77, k) for k in (1, 2, 3, 7, 16, 17, 64, 128)]
               + [(3001, 1024, 17), (1031, 1020, 16), (1031, 1022, 16),
                  (999, 132, 9), (999, 256, 8), (999, 260, 16),
                  (999, 512, 5), (999, 516, 12), (1, 128, 16),
                  (1031, 77, 129), (517, 100, 200)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p,k", MGLM_SHAPES)
def test_mglm_matvec_matches_plain(dev, dtype, m, p, k):
    A, y, Z, V = _mglm_inputs(dev, dtype, m, p, k)
    spec = losses.multinom_mglm(k)
    want = mglm_matvec_torch(A, y, Z, V, spec)
    counters.reset()
    got = mglm_matvec(A, y, Z, V, spec)
    assert tuple(got.shape) == (p, k)
    _check_k5(got, want, dtype)
    assert torch.equal(got, mglm_matvec(A, y, Z, V, spec))
    assert counters.snapshot()["mglm_matvec"] == 2


@pytest.mark.parametrize("m,p,k", [(3001, 1024, 16), (999, 132, 9),
                                   (517, 77, 3)])
def test_mglm_matvec_forms_agree(dev, m, p, k):
    # each of K5's forms, against the plain version: the tensor-core
    # form, then the two-pass and split forms' geometry at these shapes
    A, y, Z, V = _mglm_inputs(dev, torch.float32, m, p, k)
    spec = losses.multinom_mglm(k)
    want = mglm_matvec_torch(A, y, Z, V, spec)
    grid = k5.mglm_grid(m, p, k, torch.float32, 132)
    assert grid.form == "tensor"
    for g in (grid, k5.mglm_grid(m, p, k, torch.float64, 132),
              k5.mglm_grid(m, p, k, torch.float32, 132, covered=False)):
        got = k5._launch(A, y, Z, V, spec, g)
        _check_k5(got, want, torch.float32)
        assert torch.equal(got, k5._launch(A, y, Z, V, spec, g))


def test_mglm_matvec_rejects_what_the_kernel_does_not_take(dev):
    A, y, Z, V = _mglm_inputs(dev, torch.float32, 64, 8, 3)
    spec = losses.multinom_mglm(3)
    with pytest.raises(ValueError, match="shapes"):
        mglm_matvec(A, y, Z[:, :2].contiguous(), V, spec)
    with pytest.raises(ValueError):
        mglm_matvec(A, y, Z, V.double(), spec)
    with pytest.raises(ValueError):
        mglm_matvec(A.half(), y.half(), Z.half(), V.half(), spec)
    # any kind runs (the split form), and any k (the two-pass form)
    probit = replace(spec, kind="probit")
    _check(mglm_matvec(A, y, Z, V, probit),
           mglm_matvec_torch(A, y, Z, V, probit), torch.float32)
    A, y, Z, V = _mglm_inputs(dev, torch.float32, 16, 4, 129)
    spec = losses.multinom_mglm(129)
    _check_k5(mglm_matvec(A, y, Z, V, spec),
              mglm_matvec_torch(A, y, Z, V, spec), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p,k", [(1031, 77, 3), (3001, 1024, 16),
                                   (300, 1025, 17), (517, 100, 200)])
def test_mglm_split_form_matches_plain(dev, dtype, m, p, k):
    # specs K5 does not compute itself: the kernel's passes over A, the
    # spec's quad between them
    A, y, Z, V = _mglm_inputs(dev, dtype, m, p, k)
    for spec in (_squared_moglm(k), replace(losses.multinom_mglm(k),
                                            kind=None)):
        counters.reset()
        got = mglm_matvec(A, y, Z, V, spec)
        assert torch.equal(got, mglm_matvec(A, y, Z, V, spec))
        assert counters.snapshot()["mglm_matvec"] == 2
        _check(got, mglm_matvec_torch(A, y, Z, V, spec), dtype)


def test_small_mglm_solve_matches_cpu(dev):
    A, Y, x0, _ = synthetic.make_multinomial_data(256, 32, 4, seed=11,
                                                  dtype=np.float64)
    mk = lambda device: st.Problem(A, Y, x0, losses.multinom_f, 1e-2,
                                   mglm=losses.multinom_mglm(4),
                                   dtype=torch.float64, device=device)
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    counters.reset()
    s_gpu = st.iterate(method, mk(dev), "l1", st.PHuberSmootherL1L2(1.0),
                       **kw)
    got = counters.snapshot()
    assert got["mglm_matvec"] > 0 and got["score_update"] > 0
    assert got["normal_matvec"] == got["glm_prep_pair"] == 0
    s_cpu = st.iterate(method, mk("cpu"), "l1", st.PHuberSmootherL1L2(1.0),
                       **kw)
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 8320, 23456])
@pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
def test_score_update_matches_plain(dev, dtype, n, reg):
    gen = torch.Generator(device=dev).manual_seed(n)
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    lgr[::10] = 0.0
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    args = (x, d, lgr, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
            reg != "none", -0.5, 0.7)
    for g, w_ in zip(score_update(*args), score_update_torch(
            *args[:9], lb=torch.full_like(x, -0.5),
            ub=torch.full_like(x, 0.7))):
        _check(g, w_, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 8320, (1 << 24) + 1])
@pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
def test_score_update_keeps_non_finite_values(dev, dtype, n, reg):
    # a runaway step (NaN and ±inf in d), then a NaN η: the kernel's
    # outputs are NaN and ±inf where the plain version's are, in both
    # forms (one block, and past it)
    gen = torch.Generator(device=dev).manual_seed(n)
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    d[::7], d[1::11], d[2::13] = float("nan"), float("inf"), -float("inf")
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    for nan_eta in (False, True):
        if nan_eta:
            lgr[n // 2] = float("nan")
        args = (x, d, lgr, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
                reg != "none", torch.full_like(x, -0.5),
                torch.full_like(x, 0.7))
        got, want = score_update(*args), score_update_torch(*args)
        assert not bool(torch.isfinite(want.x_new).all())
        for g, w_ in zip(got, want):
            fin = w_[torch.isfinite(w_)]
            rtol, atol = TOL[dtype]
            scale = max(1.0, float(fin.abs().max())) if fin.numel() else 1.0
            torch.testing.assert_close(g, w_, rtol=rtol, atol=atol * scale,
                                       equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", K2S_SHAPES)
def test_glm_prep_matches_plain(dev, dtype, m, n):
    gen = torch.Generator(device=dev).manual_seed(m + n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    x = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    counters.reset()
    got = glm_prep(A, y, x, LOGISTIC01_GLM)
    for g, w_ in zip(got, glm_prep_torch(A, y, x, LOGISTIC01_GLM)[:3]):
        _check(g, w_, dtype)
    again = glm_prep(A, y, x, LOGISTIC01_GLM)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert counters.snapshot()["glm_prep"] == 2
    assert counters.snapshot()["glm_prep_pair"] == 0


def _lbfgs_memory(dev, dtype, n, m, pushes, seed):
    """A memory from ``pushes`` SPD-quadratic pairs (γ = B·δ), pushed by
    the plain update; with pushes ≥ 2 one valid slot gets an s and a y
    of disjoint support, so yᵀs = 0 exactly (ρ = 0 there)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bdiag = torch.rand((n,), generator=gen, device=dev, dtype=dtype) * 4 + 0.5
    mem = lbfgs_core.init_memory(n, m, dtype, dev)
    for _ in range(pushes):
        delta = torch.randn((n,), generator=gen, device=dev,
                            dtype=dtype) * 0.1
        mem = lbfgs_core.update_memory(mem, delta, bdiag * delta)
    if pushes >= 2:
        slot = (int(mem.pos) - 2) % m
        S, Y = mem.S.clone(), mem.Y.clone()
        S[slot, n // 2:] = 0
        Y[slot, : n // 2] = 0
        mem = mem._replace(S=S, Y=Y)
    g = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    return mem, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [64, 361, 777, 2784, 10112, 16500, 100000])
@pytest.mark.parametrize("m", [1, 5, 10])
def test_two_loop_matches_plain(dev, dtype, n, m):
    # empty, partial, full and wrapped memories
    for pushes in sorted({0, max(1, m // 2), m, m + 3}):
        mem, g = _lbfgs_memory(dev, dtype, n, m, pushes, n * 31 + m + pushes)
        assert int(mem.count) == min(pushes, m)
        counters.reset()
        got = two_loop(mem, g)
        assert torch.equal(got, two_loop(mem, g))
        assert counters.snapshot()["two_loop"] == 2
        _check(got, two_loop_torch(mem, g), dtype)
        if pushes == 0:
            assert torch.equal(got, -g)


# memories past the old 64-slot limit: α and ρ in shared memory, then
# (m = 4100 f32, 2100 f64: more than 32 KB) in the wrapper's scratch
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(777, 65), (361, 100), (2000, 200),
                                 (64, 2100), (64, 4100)])
def test_two_loop_takes_any_memory_size(dev, dtype, n, m):
    for pushes in (m // 2, m + 3):
        mem, g = _lbfgs_memory(dev, dtype, n, m, pushes, n + m + pushes)
        counters.reset()
        got = two_loop(mem, g)
        assert torch.equal(got, two_loop(mem, g))
        assert counters.snapshot()["two_loop"] == 2
        _check(got, two_loop_torch(mem, g), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
def test_score_update_past_one_block(dev, dtype, reg):
    # n = 2²⁴ + 1: K3's multi-block form
    n = (1 << 24) + 1
    gen = torch.Generator(device=dev).manual_seed(17)
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    lgr[::10] = 0.0
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    args = (x, d, lgr, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
            reg != "none", torch.full_like(x, -0.5), torch.full_like(x, 0.7))
    counters.reset()
    got = score_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, score_update(*args)))
    assert counters.snapshot()["score_update"] == 2
    for g, w_ in zip(got, score_update_torch(*args)):
        _check(g, w_, dtype)


def _k3_case(dev, dtype, where):
    """(n, form) of K3 at one side of a gate of update_form (form None:
    the wrapper's choice) or at a slice edge of the card's largest
    cluster (forced)."""
    c = launch.max_cluster("scso_score_update", dtype, dev.index)
    edge = lambda n: (n, k3.UpdateForm(c, k3.cluster_slice(n, c), False))
    return {
        "below CLUSTER_N": (k3.CLUSTER_N - 1, None),
        "at CLUSTER_N": (k3.CLUSTER_N, None),
        "below GRID_N": (k3.GRID_N - 1, None),
        "at GRID_N": (k3.GRID_N, None),
        "full slices": edge(c * 640),
        "short last slice": edge(c * 640 + 1),
        "empty trailing blocks": edge(16 * 32 + 1),
        "one value": edge(1),
    }[where]


K3_EDGES = ["below CLUSTER_N", "at CLUSTER_N", "below GRID_N", "at GRID_N",
            "full slices", "short last slice", "empty trailing blocks",
            "one value"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", K3_EDGES)
def test_score_update_at_gates_and_slice_edges(dev, dtype, where):
    # both sides of each form gate and the slices' edges: against the
    # plain version, bitwise reruns, and a runaway step's NaN and ±inf
    n, form = _k3_case(dev, dtype, where)
    want_form = form or k3.update_form(
        n, launch.max_cluster("scso_score_update", dtype, dev.index))
    assert want_form.grid == (n >= k3.GRID_N)
    gen = torch.Generator(device=dev).manual_seed(n)
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    lgr[::10] = 0.0
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    lb, ub = torch.full_like(x, -0.5), torch.full_like(x, 0.7)
    for reg in ("l1", "indbox"):
        args = (x, d, lgr, hr, lam, ss, 3.0, reg, True, lb, ub)
        counters.reset()
        got = k3._launch(*args, form=form)
        assert all(torch.equal(a, b)
                   for a, b in zip(got, k3._launch(*args, form=form)))
        assert counters.snapshot()["score_update"] == 2
        for g, w_ in zip(got, score_update_torch(*args)):
            _check(g, w_, dtype)
    d = d.clone()
    d[::7], d[1::11], d[2::13] = float("nan"), float("inf"), -float("inf")
    args = (x, d, lgr, hr, lam, ss, 3.0, "l1", True, lb, ub)
    got, want = k3._launch(*args, form=form), score_update_torch(*args)
    for g, w_ in zip(got, want):
        fin = w_[torch.isfinite(w_)]
        rtol, atol = TOL[dtype]
        scale = max(1.0, float(fin.abs().max())) if fin.numel() else 1.0
        torch.testing.assert_close(g, w_, rtol=rtol, atol=atol * scale,
                                   equal_nan=True)


def _k4_case(dev, dtype, where):
    """(n, m) of K4 at one side of two_loop_plan's residency limit (m =
    10) or of SMEM_BYTES (α and ρ in shared memory or the scratch)."""
    size = torch.empty((), dtype=dtype).element_size()
    c = launch.max_cluster("scso_two_loop", dtype, dev.index)
    n = 32 * c
    while k4.two_loop_plan(n + 32 * c, 10, size, c).resident:
        n += 32 * c
    m = k4.SMEM_BYTES // (2 * size)
    return {"resident": (n, 10), "past residency": (n + 1, 10),
            "alpha in smem": (64, m), "alpha in scratch": (64, m + 1),
            "one block": (300, 7)}[where]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["resident", "past residency",
                                   "alpha in smem", "alpha in scratch",
                                   "one block"])
def test_two_loop_at_residency_and_smem_limits(dev, dtype, where):
    n, m = _k4_case(dev, dtype, where)
    plan = k4.two_loop_plan(n, m, torch.empty((), dtype=dtype).element_size(),
                            launch.max_cluster("scso_two_loop", dtype,
                                               dev.index))
    assert plan.resident == (where == "resident" or where == "one block")
    assert plan.alpha_smem == (where != "alpha in scratch")
    for pushes in (m // 2, m + 3):
        mem, g = _lbfgs_memory(dev, dtype, n, m, pushes, n + m + pushes)
        counters.reset()
        got = two_loop(mem, g)
        assert torch.equal(got, two_loop(mem, g))
        assert counters.snapshot()["two_loop"] == 2
        _check(got, two_loop_torch(mem, g), dtype)
        # the same blocks and slices with S and Y streamed, q in the
        # output and α, ρ in the scratch: the same bits
        bare = plan._replace(alpha_smem=False, q_smem=False, resident=False,
                             smem=0)
        assert torch.equal(got, k4._launch(mem, g, bare))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    A = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        normal_matvec(A, torch.zeros(4, device=dev, dtype=torch.float64),
                      torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        normal_matvec(A.t(), torch.zeros(8, device=dev),
                      torch.zeros(4, device=dev))
    # the preps take any spec kind (the split form), but not mismatched
    # shapes
    with pytest.raises(ValueError, match="shapes"):
        glm_prep_pair(A, torch.zeros(5, device=dev), torch.zeros(8, device=dev),
                      torch.zeros(8, device=dev),
                      replace(LOGISTIC01_GLM, kind="probit"))
    with pytest.raises(ValueError, match="shapes"):
        glm_prep(A, torch.zeros(4, device=dev), torch.zeros(9, device=dev),
                 replace(LOGISTIC01_GLM, kind="probit"))
    g = torch.zeros(8, device=dev)
    # any memory size runs: an empty one gives −g
    assert torch.equal(two_loop(lbfgs_core.init_memory(
        8, 65, torch.float32, dev), g + 1), -(g + 1))
    mem = lbfgs_core.init_memory(8, 4, torch.float32, dev)
    with pytest.raises(ValueError, match="int32"):
        two_loop(mem._replace(pos=mem.pos.long()), g)


def test_small_solve_matches_cpu(dev):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 200, density=0.05, n_active=8, seed=7, dtype=np.float64,
        label01=True)
    mk = lambda device: st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                                   glm=losses.LOGISTIC01_GLM,
                                   dtype=torch.float64, device=device,
                                   pad_features=True)
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    counters.reset()
    s_gpu = st.iterate(method, mk(dev), "l1", st.PHuberSmootherL1L2(1.0),
                       **kw)
    got = counters.snapshot()
    assert min(got[k] for k in ("normal_matvec", "glm_prep_pair",
                                "score_update")) > 0
    assert got["mglm_matvec"] == 0
    s_cpu = st.iterate(method, mk("cpu"), "l1", st.PHuberSmootherL1L2(1.0),
                       **kw)
    assert s_gpu.epochs == s_cpu.epochs
    assert tuple(s_gpu.x.shape) == (200,)
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


def _small_logreg(device, lam=0.01):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 200, density=0.05, n_active=8, seed=7, dtype=np.float64,
        label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, lam,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device=device, pad_features=True)


@pytest.mark.parametrize("method,kernels", [
    (st.ProxLQNSCORE(), ("two_loop", "score_update")),
    (st.ProxGGNSCORE(solver="cg", epoch_cache=False, greedy_alpha=False),
     ("glm_prep", "normal_matvec", "score_update")),
])
def test_small_lbfgs_and_uncached_solves_match_cpu(dev, method, kernels):
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    counters.reset()
    s_gpu = st.iterate(method, _small_logreg(dev), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    assert all((got[k] > 0) == (k in kernels) for k in got), got
    s_cpu = st.iterate(method, _small_logreg("cpu"), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


def test_small_lbfgs_solve_with_a_long_memory_matches_cpu(dev):
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4)
    method = st.ProxLQNSCORE(m=100)
    counters.reset()
    s_gpu = st.iterate(method, _small_logreg(dev), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    assert counters.snapshot()["two_loop"] == s_gpu.epochs
    s_cpu = st.iterate(method, _small_logreg("cpu"), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


# K2's newton flavour: tests/test_pallas.py's matvec shapes, then K2's
# own (both sides of the one-pass form's n limit, so the wide form too)
NEWTON_SHAPES = [(64, 128), (500, 256), (37, 128)] + K2_SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", NEWTON_SHAPES)
def test_newton_prep_matches_plain(dev, dtype, m, n):
    # mixed 0/1 labels; row 0 scaled so that its z_t = 40 saturates σ
    # (z ≳ 17 in float32, where s·(1 − s) is exactly 0); the logistic01
    # spec in the kernel, a kind=None one in the split form
    gen = torch.Generator(device=dev).manual_seed(m + 5 * n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    A[0] = xt * (40.0 / float(xt @ xt))
    for glm in (LOGISTIC01_GLM, replace(LOGISTIC01_GLM, kind=None)):
        counters.reset()
        got = glm_prep_pair(A, y, xt, xd, glm, flavour="newton")
        want = glm_prep_pair_torch(A, y, xt, xd, glm, flavour="newton")
        for g, w_ in zip(got, want):
            _check(g, w_, dtype)
        if dtype == torch.float32:
            assert float(got.w_t[0]) == float(want.w_t[0]) == 0.0
        assert all(torch.equal(g, a) for g, a in zip(
            got, glm_prep_pair(A, y, xt, xd, glm, flavour="newton")))
        snap = counters.snapshot()
        assert snap["glm_prep_pair_newton"] == 2
        assert snap["glm_prep_pair"] == 0


@pytest.mark.parametrize("method,kernels", [
    (st.ProxNSCORE(solver="cg", greedy_alpha=False),
     ("glm_prep_pair_newton", "normal_matvec", "score_update")),
    (st.ProxNSCORE(solver="cg", greedy_alpha=True),
     ("glm_prep_pair_newton", "normal_matvec", "score_update")),
    (st.ProxNSCORE(solver="cg", ss_type=3), ("normal_matvec",
                                             "score_update")),
], ids=["cached", "cached-greedy", "uncached"])
def test_small_newton_solves_match_cpu(dev, method, kernels):
    # λ = 0.1: at 0.01 the damped Newton iteration diverges on this data,
    # in the JAX package as here
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    counters.reset()
    s_gpu = st.iterate(method, _small_logreg(dev, 0.1), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    assert all((got[k] > 0) == (k in kernels) for k in got), got
    s_cpu = st.iterate(method, _small_logreg("cpu", 0.1), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    assert bool(torch.isfinite(s_cpu.obj).all())
    if method.greedy_alpha:  # the accept test sees last-ulp differences
        assert float(s_gpu.obj[-1]) == pytest.approx(float(s_cpu.obj[-1]),
                                                     rel=1e-8)
        return
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


def test_small_newton_divergence_matches_cpu(dev):
    # λ = 0.01 with greedy on: the trial's full Newton steps run away on
    # this data (in the JAX package too); the card's kernels must follow
    # the CPU's records and turn non-finite at the same one
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxNSCORE(solver="cg", greedy_alpha=True)
    counters.reset()
    s_gpu = st.iterate(method, _small_logreg(dev), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    assert counters.snapshot()["glm_prep_pair_newton"] > 0
    s_cpu = st.iterate(method, _small_logreg("cpu"), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    got, want = s_gpu.obj.numpy(), s_cpu.obj.numpy()
    assert not np.isfinite(want[-1])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(37, 128), (999, 1001), (5, 1001),
                                 (1031, 14340), (301, 28676)])
def test_prep_split_form_matches_plain(dev, dtype, m, n):
    # specs the preps do not compute themselves: the kernels' passes over
    # A, the spec's ρ, w and loss between them; normalized by A's rows
    # and by another count, as on one rank of four
    gen = torch.Generator(device=dev).manual_seed(m + 3 * n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    for glm in (_least_squares_glm(), replace(LOGISTIC01_GLM, kind=None)):
        for m_norm in (None, 4 * m + 3):
            counters.reset()
            got = glm_prep_pair(A, y, xt, xd, glm, m_norm)
            for g, w_ in zip(got, glm_prep_pair_torch(A, y, xt, xd, glm,
                                                      m_norm)):
                _check(g, w_, dtype)
            assert all(torch.equal(g, a) for g, a in zip(
                got, glm_prep_pair(A, y, xt, xd, glm, m_norm)))
            single = glm_prep(A, y, xt, glm, m_norm)
            for g, w_ in zip(single, glm_prep_torch(A, y, xt, glm,
                                                    m_norm)[:3]):
                _check(g, w_, dtype)
            assert all(torch.equal(g, a) for g, a in zip(
                single, glm_prep(A, y, xt, glm, m_norm)))
            assert counters.snapshot()["glm_prep_pair"] == 2
            assert counters.snapshot()["glm_prep"] == 2


@pytest.mark.parametrize("kernels", ["auto", "cuda"])
@pytest.mark.parametrize("epoch_cache", [None, False])
def test_uncovered_glm_kind_runs_the_split_prep(dev, epoch_cache, kernels):
    # kind=None: K1, K3 and the prep kernel (its split form) launch; the
    # solve equals kernels='torch' on the card
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    spec = replace(LOGISTIC01_GLM, kind=None)
    mk = lambda: replace(_small_logreg(dev), glm=spec)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             epoch_cache=epoch_cache, kernels=kernels)
    counters.reset()
    s_k = st.iterate(method, mk(), "l1", st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    prep = "glm_prep_pair" if epoch_cache is None else "glm_prep"
    assert got["normal_matvec"] > 0 and got["score_update"] > 0
    assert got[prep] > 0
    s_torch = st.iterate(replace(method, kernels="torch"), mk(), "l1",
                         st.PHuberSmootherL1L2(1.0), **kw)
    assert s_k.epochs == s_torch.epochs
    np.testing.assert_allclose(s_k.obj.numpy(), s_torch.obj.numpy(),
                               rtol=1e-9)


@pytest.mark.parametrize("kernels", ["auto", "cuda"])
def test_uncovered_moglm_kind_runs_the_split_matvec(dev, kernels):
    A, Y, x0, _ = synthetic.make_multinomial_data(256, 32, 4, seed=11,
                                                  dtype=np.float64)
    spec = replace(losses.multinom_mglm(4), kind=None)
    mk = lambda: st.Problem(A, Y, x0, losses.multinom_f, 1e-2, mglm=spec,
                            dtype=torch.float64, device=dev)
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             kernels=kernels)
    counters.reset()
    s_k = st.iterate(method, mk(), "l1", st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    assert got["mglm_matvec"] > 0 and got["score_update"] > 0
    s_torch = st.iterate(replace(method, kernels="torch"), mk(), "l1",
                         st.PHuberSmootherL1L2(1.0), **kw)
    assert s_k.epochs == s_torch.epochs
    np.testing.assert_allclose(s_k.obj.numpy(), s_torch.obj.numpy(),
                               rtol=1e-9)


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """A one-rank NCCL group on the card (a file rendezvous)."""
    assert distributed_init(init_method=file_init(tmp_path),
                            world_size=1, rank=0) == 1
    assert dist.is_initialized() and dist.get_backend() == "nccl"
    yield make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(37, 128), (947, 384), (3465, 2432),
                                 (999, 1001), (64, 130)])
def test_sharded_matvec_on_one_rank(nccl_mesh, dtype, m, n):
    gen = torch.Generator(device="cuda").manual_seed(m * n)
    A = torch.randn((m, n), generator=gen, device="cuda", dtype=dtype) * 0.1
    w = torch.rand((m,), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)
    counters.reset()
    got = normal_matvec_sharded(A, w, v, nccl_mesh)
    # one rank: the all_reduce is a copy, so K1s is K1 bit for bit
    assert torch.equal(got, normal_matvec(A, w, v))
    assert counters.snapshot()["normal_matvec_sharded"] == 1
    assert counters.snapshot()["normal_matvec"] == 2
    plain = normal_matvec_sharded_torch(A, w, v, nccl_mesh)
    for chunks in (2, 3):
        over = normal_matvec_sharded(A, w, v, nccl_mesh,
                                     overlap_chunks=chunks)
        _check(over, plain, dtype)
        assert torch.equal(over, normal_matvec_sharded_torch(
            A, w, v, nccl_mesh, overlap_chunks=chunks))
    # the overlapped form launches no K1 and counts nothing
    assert counters.snapshot()["normal_matvec_sharded"] == 1
    assert counters.snapshot()["normal_matvec"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(660, 256), (999, 1001), (5, 1001),
                                 (517, 7170), (301, 14340)])
def test_prep_kernels_normalize_by_m_norm(dev, dtype, m, n):
    gen = torch.Generator(device=dev).manual_seed(m + 7 * n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    m_norm = 4 * m + 3  # as on one rank of four
    got = glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, m_norm)
    want = glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM, m_norm)
    for g, w_ in zip(got, want):
        _check(g, w_, dtype)
    assert all(torch.equal(g, a) for g, a in zip(
        got, glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, m_norm)))
    single = glm_prep(A, y, xt, LOGISTIC01_GLM, m_norm)
    for g, w_ in zip(single,
                     glm_prep_torch(A, y, xt, LOGISTIC01_GLM, m_norm)[:3]):
        _check(g, w_, dtype)
    assert all(torch.equal(g, a) for g, a in zip(
        single, glm_prep(A, y, xt, LOGISTIC01_GLM, m_norm)))
    # m_norm = m is the unsharded kernel, bit for bit
    assert all(torch.equal(g, w_) for g, w_ in zip(
        glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, m),
        glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(947, 384), (999, 1001), (3465, 2432)])
def test_bf16_sharded_matvec_on_one_rank(nccl_mesh, dtype, m, n):
    A, w, v = _bf16_inputs("cuda", dtype, m, n)
    counters.reset()
    got = normal_matvec_sharded(A, w, v, nccl_mesh)
    assert torch.equal(got, normal_matvec(A, w, v))
    snap = counters.snapshot()
    assert snap["normal_matvec_sharded"] == 1
    assert snap["normal_matvec"] == snap["normal_matvec_bf16"] == 2
    _check(normal_matvec_sharded(A, w, v, nccl_mesh, overlap_chunks=2),
           normal_matvec_sharded_torch(A, w, v, nccl_mesh), dtype)


def test_small_sharded_solve_on_one_rank(nccl_mesh):
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    s_gpu = st.iterate(method, _small_logreg("cuda"), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    counters.reset()
    s_sh = st.iterate(method, shard_problem(_small_logreg("cuda"),
                                            nccl_mesh), "l1",
                      st.PHuberSmootherL1L2(1.0), **kw)
    got = counters.snapshot()
    assert got["normal_matvec_sharded"] == got["normal_matvec"] > 0
    assert got["glm_prep_pair"] > 0 and got["glm_prep"] == 0
    assert s_sh.epochs == s_gpu.epochs
    assert torch.equal(s_sh.obj, s_gpu.obj) and torch.equal(s_sh.x, s_gpu.x)
    s_cpu = st.iterate(method, _small_logreg("cpu"), "l1",
                       st.PHuberSmootherL1L2(1.0), **kw)
    np.testing.assert_allclose(s_sh.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# every method on a row shard: K5 and K2s on the shard, the captured
# line search's all-reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p,k", [(512, 128, 8), (700, 256, 4),
                                   (130, 128, 3), (1031, 77, 17),
                                   (3001, 1024, 16), (517, 100, 200)])
def test_k5_on_a_one_rank_shard(nccl_mesh, dtype, m, p, k):
    """The sharded mglm curvature matvec (K5 normalized by the rows of
    all ranks, then one all-reduce of its (p, k) result) on one rank is
    the unsharded one bit for bit, one K5 launch each; K5 normalized by
    another row count against its plain version."""
    from scso_tpu_torch.algorithms import steps

    A, y, Z, V = _mglm_inputs("cuda", dtype, m, p, k)
    spec = losses.multinom_mglm(k)
    prob = st.Problem(A, y, torch.zeros(p * k, dtype=dtype), losses.multinom_f,
                      0.01, mglm=spec, dtype=dtype, device="cuda")
    method = st.ProxGGNSCORE(solver="cg", kernels="cuda")
    lhr = torch.rand(p * k, dtype=dtype, device="cuda")
    v = V.reshape(-1)
    outs, counts = [], []
    for pr in (prob, shard_problem(prob, nccl_mesh)):
        counters.reset()
        outs.append(steps._mo_curv_matvec(method, pr, pr.A, pr.y, Z, spec,
                                          lhr, p, k)(v))
        counts.append(counters.snapshot())
    assert torch.equal(outs[0], outs[1]) and counts[0] == counts[1]
    assert counts[0]["mglm_matvec"] == 1
    m_norm = 4 * m + 3  # as on one rank of four
    _check_k5(mglm_matvec(A, y, Z, V, spec, m_norm),
              mglm_matvec_torch(A, y, Z, V, spec, m_norm), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(660, 256), (947, 384), (5, 1001),
                                 (999, 1001), (517, 7170)])
def test_k2s_on_a_one_rank_shard(nccl_mesh, dtype, m, n):
    """The uncached GGN-CG direction on one rank (K2s normalized by the
    rows of all ranks and one packed all-reduce of its sums, K1s in CG)
    is the unsharded one bit for bit, with the same K2s and K1 launches
    and K1s once for each K1."""
    from scso_tpu_torch.algorithms import steps
    from scso_tpu_torch.ops.cuda import graph

    gen = torch.Generator(device="cuda").manual_seed(m + 11 * n)
    A = torch.randn((m, n), generator=gen, device="cuda", dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device="cuda") < 0.5).to(dtype)
    x = torch.randn((n,), generator=gen, device="cuda", dtype=dtype) * 0.3
    prob = st.Problem(A, y, x, losses.logistic01_f, 0.01,
                      glm=LOGISTIC01_GLM, dtype=dtype, device="cuda")
    method = st.ProxGGNSCORE(solver="cg", epoch_cache=False, cg_maxiter=30,
                             kernels="cuda")
    gr = torch.randn((n,), generator=gen, device="cuda", dtype=dtype)
    hr = torch.rand((n,), generator=gen, device="cuda", dtype=dtype) + 0.5
    lam = torch.tensor(0.01, dtype=dtype, device="cuda")
    outs, counts = [], []
    for pr in (prob, shard_problem(prob, nccl_mesh)):
        counters.reset()
        with graph.eager():  # CG's loop, read from the host
            d, iters, _, _ = steps._ggn_cg_direction(
                method, pr, pr.A, pr.y, x, gr, hr, lam, it=1)
        outs.append((d, int(iters)))
        counts.append(counters.snapshot())
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    assert counts[0]["glm_prep"] == counts[1]["glm_prep"] == 1
    assert counts[1]["normal_matvec"] == counts[0]["normal_matvec"] > 0
    assert counts[1]["normal_matvec_sharded"] == counts[1]["normal_matvec"]


@pytest.mark.parametrize("stats_every", [1, 4])
def test_captured_line_search_on_a_one_rank_shard(nccl_mesh, stats_every):
    """L-BFGS with the Armijo line search on a one-rank NCCL shard,
    captured: each trial's f is an all-reduce inside the line search's
    WHILE node. Bit for bit the unsharded captured solve and, with a
    record every epoch, the shard's timed mode (uncaptured)."""
    from scso_tpu_torch.ops.cuda import graph

    kw = dict(x_tol=0.0, f_tol=0.0, max_epoch=25, verbose=0, alpha=1.0,
              stats_every=stats_every)
    method = st.ProxLQNSCORE(ss_type=3)
    sm = st.PHuberSmootherL1L2(1.0)
    sp = shard_problem(_small_logreg("cuda"), nccl_mesh)
    graph.reset_stats()
    fused = st.iterate(method, sp, "l1", sm, **kw)
    assert graph.STATS["captures"] > 0
    one = st.iterate(method, _small_logreg("cuda"), "l1", sm, **kw)
    assert fused.epochs == one.epochs == 25
    assert torch.equal(fused.x, one.x) and torch.equal(fused.obj, one.obj)
    if stats_every == 1:
        timed = st.iterate(method, sp, "l1", sm, **dict(kw, mode="timed"))
        assert torch.equal(fused.x, timed.x)
        assert torch.equal(fused.obj, timed.obj)


# ---------------------------------------------------------------------------
# K2, K2s and K5 with A in bfloat16, and iterate_mixed
# ---------------------------------------------------------------------------


def _bf16_prep_inputs(dev, dtype, m, n):
    gen = torch.Generator(device=dev).manual_seed(m * 7 + n)
    A = (torch.randn((m, n), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    return A, y, xt, xd


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", K2_SHAPES)
def test_bf16_pair_prep_matches_plain(dev, dtype, m, n):
    # both flavours, the logistic01 spec in the kernel and a kind=None
    # one in the split form
    A, y, xt, xd = _bf16_prep_inputs(dev, dtype, m, n)
    for flavour in ("ggn", "newton"):
        for glm in (LOGISTIC01_GLM, replace(LOGISTIC01_GLM, kind=None)):
            counters.reset()
            got = glm_prep_pair(A, y, xt, xd, glm, flavour=flavour)
            want = glm_prep_pair_torch(A, y, xt, xd, glm, flavour=flavour)
            for g, w_ in zip(got, want):
                assert g.dtype == dtype
                _check(g, w_, dtype)
            assert all(torch.equal(g, a) for g, a in zip(
                got, glm_prep_pair(A, y, xt, xd, glm, flavour=flavour)))
            base = ("glm_prep_pair_newton" if flavour == "newton"
                    else "glm_prep_pair")
            snap = counters.snapshot()
            assert snap[base] == snap[f"{base}_bf16"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", K2S_SHAPES)
def test_bf16_prep_matches_plain(dev, dtype, m, n):
    A, y, xt, _ = _bf16_prep_inputs(dev, dtype, m, n)
    for glm in (LOGISTIC01_GLM, _least_squares_glm()):
        counters.reset()
        got = glm_prep(A, y, xt, glm)
        for g, w_ in zip(got, glm_prep_torch(A, y, xt, glm)[:3]):
            assert g.dtype == dtype
            _check(g, w_, dtype)
        assert all(torch.equal(g, a) for g, a in zip(
            got, glm_prep(A, y, xt, glm)))
        snap = counters.snapshot()
        assert snap["glm_prep"] == snap["glm_prep_bf16"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p,k", MGLM_SHAPES)
def test_bf16_mglm_matvec_matches_plain(dev, dtype, m, p, k):
    A, y, Z, V = _mglm_inputs(dev, dtype, m, p, k)
    A = A.to(torch.bfloat16)
    spec = losses.multinom_mglm(k)
    want = mglm_matvec_torch(A, y, Z, V, spec)
    counters.reset()
    got = mglm_matvec(A, y, Z, V, spec)
    assert got.dtype == dtype and tuple(got.shape) == (p, k)
    _check_k5(got, want, dtype)
    assert torch.equal(got, mglm_matvec(A, y, Z, V, spec))
    snap = counters.snapshot()
    assert snap["mglm_matvec"] == snap["mglm_matvec_bf16"] == 2


@pytest.mark.parametrize("m,p,k", [(3001, 1024, 16), (999, 132, 9),
                                   (517, 77, 3), (999, 1022, 16)])
def test_bf16_mglm_matvec_forms_agree(dev, m, p, k):
    # each of K5's forms with A in bfloat16: the tensor-core form (rows
    # 16-byte aligned or not), the two-pass and split forms' geometry
    A, y, Z, V = _mglm_inputs(dev, torch.float32, m, p, k)
    A = A.to(torch.bfloat16)
    spec = losses.multinom_mglm(k)
    want = mglm_matvec_torch(A, y, Z, V, spec)
    bf = torch.bfloat16
    grid = k5.mglm_grid(m, p, k, torch.float32, 132, a_dtype=bf)
    assert grid.form == "tensor"
    for g in (grid, k5.mglm_grid(m, p, k, torch.float64, 132, a_dtype=bf),
              k5.mglm_grid(m, p, k, torch.float32, 132, covered=False,
                           a_dtype=bf)):
        got = k5._launch(A, y, Z, V, spec, g)
        _check_k5(got, want, torch.float32)
        assert torch.equal(got, k5._launch(A, y, Z, V, spec, g))


def test_bf16_a_on_the_card_never_takes_the_plain_version(dev, monkeypatch):
    from scso_tpu_torch.ops.cuda import glm_prep as k2

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((k2, "glm_prep_torch"), (k2, "glm_prep_pair_torch"),
                      (k5, "mglm_matvec_torch")):
        monkeypatch.setattr(mod, name, refuse)
    A, y, xt, xd = _bf16_prep_inputs(dev, torch.float32, 300, 256)
    counters.reset()
    k2.glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)
    k2.glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, flavour="newton")
    k2.glm_prep(A, y, xt, LOGISTIC01_GLM)
    Am, ym, Z, V = _mglm_inputs(dev, torch.float32, 300, 64, 5)
    k5.mglm_matvec(Am.to(torch.bfloat16), ym, Z, V, losses.multinom_mglm(5))
    snap = counters.snapshot()
    assert all(snap[k] == 1 for k in (
        "glm_prep_pair_bf16", "glm_prep_pair_newton_bf16", "glm_prep_bf16",
        "mglm_matvec_bf16"))
    # a mix the kernels do not take raises: A in bfloat16 with half x,
    # or candidates in two dtypes
    with pytest.raises(ValueError):
        k2.glm_prep(A, y.half(), xt.half(), LOGISTIC01_GLM)
    with pytest.raises(ValueError):
        k2.glm_prep_pair(A, y, xt, xd.double(), LOGISTIC01_GLM)
    with pytest.raises(ValueError):
        k5.mglm_matvec(Am.to(torch.bfloat16), ym, Z, V.double(),
                       losses.multinom_mglm(5))


def _mixed_problem(kind, device, lam):
    if kind == "mglm":
        A, Y, x0, _ = synthetic.make_multinomial_data(256, 32, 4, seed=11,
                                                      dtype=np.float64)
        return st.Problem(A, Y, x0, losses.multinom_f, lam,
                          grad_fx=losses.multinom_grad,
                          mglm=losses.multinom_mglm(4), dtype=torch.float64,
                          device=device)
    return _small_logreg(device, lam)


# method, problem kind, λ, the kernels the card's coarse phase launches
# with A in bfloat16
MIXED = [
    (st.ProxGGNSCORE(solver="cg", greedy_alpha=False), "logreg", 0.01,
     ("glm_prep_pair_bf16", "normal_matvec_bf16")),
    (st.ProxGGNSCORE(solver="cg", greedy_alpha=False, epoch_cache=False),
     "logreg", 0.01, ("glm_prep_bf16", "normal_matvec_bf16")),
    (st.ProxNSCORE(solver="cg", greedy_alpha=False), "logreg", 0.1,
     ("glm_prep_pair_newton_bf16", "normal_matvec_bf16")),
    (st.ProxLQNSCORE(), "logreg", 0.01, ("two_loop",)),
    (st.ProxGGNSCORE(solver="cg", greedy_alpha=False), "mglm", 0.01,
     ("mglm_matvec_bf16",)),
]


@pytest.mark.parametrize("method,kind,lam,coarse", MIXED,
                         ids=["cached", "uncached", "newton", "lbfgs",
                              "mglm"])
def test_small_mixed_solves_match_cpu(dev, method, kind, lam, coarse):
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    sm = st.PHuberSmootherL1L2(1.0)
    counters.reset()
    s_gpu = st.iterate_mixed(method, _mixed_problem(kind, dev, lam), "l1",
                             sm, coarse_max_epoch=20, **kw)
    got = counters.snapshot()
    assert all(got[k] > 0 for k in coarse), got
    s_cpu = st.iterate_mixed(method, _mixed_problem(kind, "cpu", lam), "l1",
                             sm, coarse_max_epoch=20, **kw)
    assert s_gpu.epochs == s_cpu.epochs
    assert s_gpu.cg_info["coarse_epochs"] == s_cpu.cg_info["coarse_epochs"]
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# the least-squares and Poisson kinds in K2 and K2s, the group sums, and
# the group-lasso and Poisson solves
# ---------------------------------------------------------------------------

KINDS = {"lsq": losses.LSQ_GLM, "poisson": losses.POISSON_GLM}
# both sides of K2's and K2s's one-pass limits, fewer rows than blocks,
# ragged rows
KIND_SHAPES = K2_SHAPES + [(301, 28672), (301, 28676), (517, 14336),
                           (517, 14338)]


def _kind_inputs(dev, dtype, m, n, kind):
    gen = torch.Generator(device=dev).manual_seed(m * 5 + n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    if kind == "poisson":
        y = torch.randint(0, 6, (m,), generator=gen, device=dev).to(dtype)
    else:
        y = torch.randn((m,), generator=gen, device=dev, dtype=dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    return A, y, xt, xd


@pytest.mark.parametrize("kind", ["lsq", "poisson"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", KIND_SHAPES)
def test_glm_kinds_match_plain(dev, dtype, m, n, kind):
    # K2 in both flavours and K2s compute the kind in the kernel (never
    # the split form), with A in the compute type and in bfloat16;
    # reruns are bitwise equal
    glm = KINDS[kind]
    A, y, xt, xd = _kind_inputs(dev, dtype, m, n, kind)
    for a in (A, A.to(torch.bfloat16)):
        bf = "_bf16" if a.dtype == torch.bfloat16 else ""
        for flavour in ("ggn", "newton"):
            counters.reset()
            got = glm_prep_pair(a, y, xt, xd, glm, flavour=flavour)
            want = glm_prep_pair_torch(a, y, xt, xd, glm, flavour=flavour)
            for g, w_ in zip(got, want):
                assert g.dtype == dtype
                _check(g, w_, dtype)
            assert all(torch.equal(g, r) for g, r in zip(
                got, glm_prep_pair(a, y, xt, xd, glm, flavour=flavour)))
            base = ("glm_prep_pair_newton" if flavour == "newton"
                    else "glm_prep_pair")
            snap = counters.snapshot()
            assert snap[base] == snap[f"{base}_{kind}{bf}"] == 2, snap
        counters.reset()
        got = glm_prep(a, y, xt, glm)
        for g, w_ in zip(got, glm_prep_torch(a, y, xt, glm)[:3]):
            _check(g, w_, dtype)
        assert all(torch.equal(g, r) for g, r in zip(
            got, glm_prep(a, y, xt, glm)))
        snap = counters.snapshot()
        assert snap["glm_prep"] == snap[f"glm_prep_{kind}{bf}"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_sums_and_gl_hessian_rerun_bitwise(dev, dtype):
    # the segment sums take a fixed order on the card (no float atomics):
    # contiguous groups with a zero-weight pad group, and unsorted ids
    n = 4096
    seg = np.concatenate([np.arange(4000) // 16, np.full(96, 250)])
    w = np.concatenate([np.ones(250), [0.0]])
    perm = np.random.default_rng(3).permutation(n)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    for ids in (seg, seg[perm]):
        g = st.make_groups(ids, w, dtype=dtype).to(device=dev)
        sums = st.ops.groups.segment_sum(g, x)
        assert torch.equal(sums, st.ops.groups.segment_sum(g, x))
        _check(sums.cpu(), st.ops.groups.segment_sum(
            st.make_groups(ids, w, dtype=dtype), x.cpu()), dtype)
        sm = st.ops.smoothers.PHuberSmootherGL(
            1e-2, torch.tensor(1e-8, dtype=dtype, device=dev),
            torch.tensor(0.1, dtype=dtype, device=dev), g)
        for f in ("val", "grad", "hess_diag"):
            got = getattr(sm, f)(x, g.element_weights)
            assert torch.equal(got, getattr(sm, f)(x, g.element_weights))
        assert torch.equal(st.reg_value("gl", x, lam=torch.tensor(
            [1e-8, 0.1], dtype=dtype, device=dev), groups=g),
            st.reg_value("gl", x, lam=torch.tensor(
                [1e-8, 0.1], dtype=dtype, device=dev), groups=g))


def _small_gl(device):
    A, y, x_true, x0, groups = synthetic.make_group_lasso_problem(
        512, 120, 16, p_active=0.1, noise_std=0.1, seed=1234,
        dtype=np.float64)
    return st.Problem(A, y, x0, losses.lsq_f, [1e-8, 0.01],
                      grad_fx=losses.lsq_grad, glm=losses.LSQ_GLM,
                      sol=x_true, groups=groups, dtype=torch.float64,
                      device=device, pad_features=True)


def _small_poisson(device):
    A, y, x0, x_true = synthetic.make_sparse_poisson_data(
        2000, 192, density=0.08, n_active=12, seed=7, dtype=np.float64)
    return st.Problem(A, y, x0, losses.poisson_f, 5e-2,
                      grad_fx=losses.poisson_grad, glm=losses.POISSON_GLM,
                      sol=x_true, dtype=torch.float64, device=device)


# problem, method, the kernels the card launches (and no other), mixed
SMALL_KIND_SOLVES = {
    "gl_cached": ("gl", st.ProxGGNSCORE(solver="cg", cg_maxiter=100),
                  ("normal_matvec", "glm_prep_pair", "glm_prep_pair_lsq"),
                  False),
    "gl_uncached": ("gl", st.ProxGGNSCORE(solver="cg", epoch_cache=False),
                    ("normal_matvec", "glm_prep", "glm_prep_lsq"), False),
    "poisson_cached": ("poisson", st.ProxGGNSCORE(solver="cg"),
                       ("normal_matvec", "glm_prep_pair",
                        "glm_prep_pair_poisson", "score_update"), False),
    "poisson_uncached": ("poisson", st.ProxGGNSCORE(solver="cg",
                                                    epoch_cache=False),
                         ("normal_matvec", "glm_prep", "glm_prep_poisson",
                          "score_update"), False),
    "poisson_newton": ("poisson", st.ProxNSCORE(solver="cg"),
                       ("normal_matvec", "glm_prep_pair_newton",
                        "glm_prep_pair_newton_poisson", "score_update"),
                       False),
    "gl_cached_mixed": ("gl", st.ProxGGNSCORE(solver="cg"),
                        ("glm_prep_pair_lsq_bf16", "normal_matvec_bf16"),
                        True),
    "poisson_cached_mixed": ("poisson", st.ProxGGNSCORE(solver="cg"),
                             ("glm_prep_pair_poisson_bf16",
                              "normal_matvec_bf16"), True),
}


@pytest.mark.parametrize("name", list(SMALL_KIND_SOLVES))
def test_small_gl_and_poisson_solves_match_cpu(dev, name):
    what, method, kernels, mixed = SMALL_KIND_SOLVES[name]
    mk = _small_gl if what == "gl" else _small_poisson
    reg = "gl" if what == "gl" else "l1"
    sm = ((lambda p: st.PHuberSmootherGL(1e-2, p)) if what == "gl"
          else (lambda p: st.PHuberSmootherL1L2(1.0)))
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
              stats_every=4, alpha=1.0)
    run = ((lambda p: st.iterate_mixed(method, p, reg, sm(p),
                                       coarse_max_epoch=20, **kw))
           if mixed else (lambda p: st.iterate(method, p, reg, sm(p), **kw)))
    counters.reset()
    s_gpu = run(mk(dev))
    got = counters.snapshot()
    if mixed:
        assert all(got[k] > 0 for k in kernels), got
    else:
        assert all((got[k] > 0) == (k in kernels) for k in got), got
    s_cpu = run(mk("cpu"))
    assert s_gpu.epochs == s_cpu.epochs
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# the redesigned bfloat16 forms: K2's cluster form, K5's bfloat16 form
# ---------------------------------------------------------------------------

# K2's cluster form on both sides of each of its limits
# (tests/test_torch_bf16_forms.py): the one-pass form up to n = 1024,
# then 16-row groups up to n = 2320 and
# 8-row ones past it (one block), clusters of 2 from 3592 (16-row groups
# to 4560), 3 from 7176, 4 from 10760, the wide form past 14336; pieces
# of 8 values at n = 8k ± 1 and rows that are not 16-byte aligned; m = 1,
# m below a group, m not a multiple of a group or of a cluster's rows;
# then tests/test_pallas.py's block-boundary shapes
CLUSTER_SHAPES = [(1, 256), (5, 1001), (7, 1024), (7, 1025), (1, 1032),
                  (17, 2047), (17, 2048), (17, 2049),
                  (1031, 2320), (1031, 2328), (1031, 3584), (1031, 3585),
                  (1031, 3592), (1031, 4560), (1031, 4568), (517, 7168),
                  (517, 7176), (517, 10752), (517, 10753), (517, 10760),
                  (301, 14336), (301, 14344), (4099, 10112), (64, 128),
                  (500, 256), (37, 128), (947, 384), (2249, 1920),
                  (131, 128), (660, 256), (3465, 2432)]


@pytest.mark.parametrize("m,n", CLUSTER_SHAPES)
def test_bf16_cluster_form_matches_plain(dev, m, n):
    # the form K2 and K2s pick (the cluster form from n = 1025, the
    # one-pass form up to 1024, past 14336 the wide form for K2 and the
    # one-pass form for K2s), then, up to 1024, the cluster form's grid
    # forced
    from scso_tpu_torch.ops.cuda import glm_prep as k2

    A, y, xt, xd = _bf16_prep_inputs(dev, torch.float32, m, n)
    grid = k2._grid(A, torch.float32, 2, LOGISTIC01_GLM)
    assert grid.form == ("wide" if n > k2.cluster_max_n() else "cluster"
                         if n > k2.CLUSTER_MIN_N else "one_pass")
    assert k2._grid(A, torch.float32, 1, LOGISTIC01_GLM).form == (
        "cluster" if grid.form == "cluster" else "one_pass")
    if grid.form == "one_pass":
        forced = k2.cluster_grid(m, n, 2, 132)
        for fl in ("ggn", "newton"):
            got = k2._pair(A, y, xt, xd, LOGISTIC01_GLM, m, fl, forced)
            for g, w_ in zip(got, glm_prep_pair_torch(
                    A, y, xt, xd, LOGISTIC01_GLM, flavour=fl)):
                _check(g, w_, torch.float32)
            assert all(torch.equal(g, a) for g, a in zip(got, k2._pair(
                A, y, xt, xd, LOGISTIC01_GLM, m, fl, forced)))
    for glm, name in ((LOGISTIC01_GLM, "logistic01"),
                      (losses.LSQ_GLM, "lsq"),
                      (losses.POISSON_GLM, "poisson")):
        yk = (torch.poisson(torch.full_like(y, 2.0)) if name == "poisson"
              else y)
        for flavour in ("ggn", "newton"):
            counters.reset()
            got = glm_prep_pair(A, yk, xt, xd, glm, flavour=flavour)
            want = glm_prep_pair_torch(A, yk, xt, xd, glm, flavour=flavour)
            for g, w_ in zip(got, want):
                _check(g, w_, torch.float32)
            assert all(torch.equal(g, a) for g, a in zip(
                got, glm_prep_pair(A, yk, xt, xd, glm, flavour=flavour)))
            base = ("glm_prep_pair_newton" if flavour == "newton"
                    else "glm_prep_pair")
            snap = counters.snapshot()
            assert snap[base] == snap[f"{base}_bf16"] == 2
            if name != "logistic01":
                assert snap[f"{base}_{name}_bf16"] == 2
        # K2s, in the same form
        counters.reset()
        got = glm_prep(A, yk, xt, glm)
        for g, w_ in zip(got, glm_prep_torch(A, yk, xt, glm)[:3]):
            _check(g, w_, torch.float32)
        assert all(torch.equal(g, a) for g, a in zip(
            got, glm_prep(A, yk, xt, glm)))
        assert counters.snapshot()["glm_prep_bf16"] == 2


@pytest.mark.parametrize("c,r,s", [(3, 8, 4), (3, 8, 3), (4, 8, 5),
                                   (1, 16, 3), (2, 16, 3), (2, 8, 6)])
def test_bf16_cluster_design_points_match_plain(dev, c, r, s):
    # chip_ab.py's sweep at the main shape's width, and narrow rows
    from scso_tpu_torch.ops.cuda import glm_prep as k2

    for m, n in ((4099, 10112), (2049, 1024)):
        A, y, xt, xd = _bf16_prep_inputs(dev, torch.float32, m, n)
        g = k2.cluster_grid(m, n, 2, 132, cluster=c, group_rows=r, stages=s)
        if g.smem_bytes > 224 * 1024 or g.threads > 512:
            continue
        got = k2._pair(A, y, xt, xd, LOGISTIC01_GLM, m, "ggn", g)
        for g_, w_ in zip(got, glm_prep_pair_torch(A, y, xt, xd,
                                                   LOGISTIC01_GLM)):
            _check(g_, w_, torch.float32)
        assert all(torch.equal(g_, a) for g_, a in zip(
            got, k2._pair(A, y, xt, xd, LOGISTIC01_GLM, m, "ggn", g)))


@pytest.mark.parametrize("p", [1, 100, 128, 129, 256, 512, 1000, 1024])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_bf16_mglm_form_matches_plain_at_every_p_and_k(dev, p, k):
    # the bfloat16 tensor-core form at each padded p (128/256/512/1024),
    # rows 16-byte aligned or not (p % 8 != 0), k up to 16; 1031 rows end
    # in a partial tile
    A, y, Z, V = _mglm_inputs(dev, torch.float32, 1031, p, k)
    A = A.to(torch.bfloat16)
    spec = losses.multinom_mglm(k)
    grid = k5.mglm_grid(1031, p, k, torch.float32, 132,
                        a_dtype=torch.bfloat16)
    assert grid.form == "tensor"
    counters.reset()
    got = mglm_matvec(A, y, Z, V, spec)
    _check_k5(got, mglm_matvec_torch(A, y, Z, V, spec), torch.float32)
    assert torch.equal(got, mglm_matvec(A, y, Z, V, spec))
    snap = counters.snapshot()
    assert snap["mglm_matvec"] == snap["mglm_matvec_bf16"] == 2


@pytest.mark.parametrize("m,n,dtype", [(777, 3072, torch.float32),
                                       (777, 1536, torch.float64),
                                       (777, 6144, torch.float32)])
def test_kernels_at_the_48_kb_launch_boundary(dev, m, n, dtype):
    # 49152 bytes of dynamic shared memory and a few of static ones need
    # the opt-in: K2 (f32 n = 3072, f64 1536), K2s and K1 (f32 n = 6144)
    gen = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.3
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype)
    for g, w_ in zip(glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM),
                     glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM)):
        _check(g, w_, dtype)
    for g, w_ in zip(glm_prep(A, y, xt, LOGISTIC01_GLM),
                     glm_prep_torch(A, y, xt, LOGISTIC01_GLM)[:3]):
        _check(g, w_, dtype)
    _check(normal_matvec(A, w, xt), normal_matvec_torch(A, w, xt), dtype)


# ---------------------------------------------------------------------------
# the captured solve (mode='fused' on the card) against its eager
# form (the private _capture=False): the same kernels on the same inputs
# ---------------------------------------------------------------------------

def _small_mglm(device):
    A, Y, x0, _ = synthetic.make_multinomial_data(384, 48, 4, seed=11,
                                                  dtype=np.float32)
    return st.Problem(A, Y, x0, losses.multinom_f, 1e-3,
                      grad_fx=losses.multinom_grad,
                      mglm=losses.multinom_mglm(4), dtype=torch.float32,
                      device=device)


CAPTURED = {
    "ggn-cached": (st.ProxGGNSCORE(solver="cg", cg_maxiter=100,
                                   auto_lp=False), _small_logreg, 4),
    "ggn-cached-f32": (st.ProxGGNSCORE(solver="cg", cg_maxiter=100,
                                       auto_lp=False), "f32", 1),
    "ggn-lp-adaptive": (st.ProxGGNSCORE(solver="cg", cg_adaptive=True,
                                        cg_lp_tol=1e-2), "lp", 4),
    "ggn-uncached": (st.ProxGGNSCORE(solver="cg", epoch_cache=False,
                                     greedy_alpha=False), _small_logreg, 4),
    # λ = 0.1: at 0.01 damped Newton diverges on this problem (in the JAX
    # package too), and NaN bits are no test
    "newton-cg": (st.ProxNSCORE(solver="cg", greedy_alpha=False),
                  lambda dev: _small_logreg(dev, lam=0.1), 4),
    "newton-ss3": (st.ProxNSCORE(solver="cg", ss_type=3),
                   lambda dev: _small_logreg(dev, lam=0.1), 1),
    "lbfgs": (st.ProxLQNSCORE(), _small_logreg, 4),
    "mglm": (st.ProxGGNSCORE(solver="cg", auto_lp=False), _small_mglm, 4),
}


def _captured_problem(dev, build):
    if build == "f32":
        A, y, x0, _ = synthetic.make_sparse_logreg_data(
            512, 200, density=0.05, n_active=8, seed=7, dtype=np.float32,
            label01=True)
        return st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                          glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                          device=dev)
    if build == "lp":
        return st.with_lp_copy(_small_logreg(dev))
    return build(dev)


def _solve_pair(method, prob, K, **kw):
    kw = dict(dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
                   stats_every=K, alpha=1.0), **kw)
    sm = st.PHuberSmootherL1L2(1.0)
    out = []
    for capture in (True, False):
        counters.reset()
        s = st.iterate(method, prob, "l1", sm, _capture=capture, **kw)
        out.append((s, counters.snapshot()))
    return out


@pytest.mark.parametrize("name", list(CAPTURED))
def test_captured_solve_is_the_eager_solve_bitwise(dev, name):
    from scso_tpu_torch.ops.cuda import graph

    method, build, K = CAPTURED[name]
    graph.clear()
    (cap, lc), (eag, le) = _solve_pair(method, _captured_problem(dev, build),
                                       K)
    assert cap.epochs == eag.epochs and cap.cg_info == eag.cg_info
    assert torch.equal(cap.x, eag.x) and bool(torch.isfinite(cap.x).all())
    for field in ("obj", "fval", "rel", "objrel", "pri_res_norm"):
        torch.testing.assert_close(getattr(cap, field), getattr(eag, field),
                                   rtol=0, atol=0, equal_nan=True)
    # the counts on the card under replay are the eager launches, exactly
    assert lc == le and any(lc.values())


def test_launch_counts_are_exact_across_replays(dev):
    from scso_tpu_torch.ops.cuda import graph

    graph.clear()
    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100, auto_lp=False)
    prob = _small_logreg(dev)
    (_, first), _ = _solve_pair(method, prob, 4)
    # the second captured solve replays the cached graph: the same counts
    (s, again), (_, eager) = _solve_pair(method, prob, 4)
    assert first == again == eager
    # K1 once a CG iteration and once an epoch (the warm start's
    # residual); K3 once an epoch; K2 once an epoch and twice to prime
    # (at x0 and x*)
    assert again["normal_matvec"] == s.cg_info["total_cg_iters"] + s.epochs
    assert again["score_update"] == s.epochs
    assert again["glm_prep_pair"] == s.epochs + 2


def test_one_capture_serves_chained_solves(dev):
    from scso_tpu_torch.ops.cuda import graph

    graph.clear()
    graph.reset_stats()
    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100, auto_lp=False)
    prob = _small_logreg(dev)
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=6, verbose=0,
              stats_every=4, alpha=1.0)
    sm = st.PHuberSmootherL1L2(1.0)
    s1 = st.iterate(method, prob, "l1", sm, **kw)
    chained = replace(prob, x0=s1.state.x)
    s2 = st.iterate(method, chained, "l1", sm, **kw)
    assert graph.STATS["captures"] == 1
    want = st.iterate(method, chained, "l1", sm, _capture=False, **kw)
    assert torch.equal(s2.x, want.x) and torch.equal(s2.obj, want.obj)
    # the solution is the solve's own: the next replay leaves it alone
    assert not torch.equal(s1.x, s2.x)


SWEPT = {
    "newton_cg": lambda: st.ProxNSCORE(solver="cg", ss_type=3),
    "ggn_cached": lambda: st.ProxGGNSCORE(solver="cg"),
    "lbfgs": lambda: st.ProxLQNSCORE(),
}


@pytest.mark.parametrize("name", list(SWEPT))
def test_batched_sweep_on_the_card(dev, name):
    from scso_tpu_torch.ops.cuda import graph
    from scso_tpu_torch.parallel import sweep

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        256, 32, density=0.1, n_active=16, seed=7, dtype=np.float64,
        label01=True)
    prob = lambda d: st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                                grad_fx=losses.logistic01_grad,
                                hvp_w=losses.logistic01_hvp_w,
                                glm=losses.LOGISTIC01_GLM,
                                dtype=torch.float64, device=d)
    lam = np.logspace(-3, -0.5, 8)
    opts = st.Options(max_epoch=40, verbose=0, stats_every=4)
    sm = st.PHuberSmootherL1L2(1.0)
    run = lambda d, **kw: sweep(SWEPT[name](), prob(d), "l1", sm,
                                lam_grid=lam, opts=opts, **kw)
    graph.clear()
    graph.reset_stats()
    counters.reset()
    cap = run(dev)
    assert graph.STATS["captures"] == 1
    # the waves' batch of 4 is another shape: one capture for both waves
    waves = run(dev, path_waves=2, wave_max_epoch=10)
    assert graph.STATS["captures"] == 2
    assert not any(counters.snapshot().values())
    eager = run(dev, _capture=False)
    for f in ("x", "obj", "epochs", "n_rec", "obj_hist"):
        assert torch.equal(getattr(cap, f), getattr(eager, f)), f
    assert cap.x.device.type == "cuda"
    cpu = run("cpu")
    torch.testing.assert_close(cap.x.cpu(), cpu.x, rtol=0, atol=1e-9)
    torch.testing.assert_close(cap.obj.cpu(), cpu.obj, rtol=1e-10, atol=0)
    assert torch.equal(cap.epochs.cpu(), cpu.epochs)
    cw = run("cpu", path_waves=2, wave_max_epoch=10)
    torch.testing.assert_close(waves.x.cpu(), cw.x, rtol=0, atol=1e-9)


def test_device_if_on_the_card_raises_outside_a_capture(dev):
    from scso_tpu_torch.ops.cuda import graph

    with pytest.raises(RuntimeError, match="outside a graph capture"):
        graph.device_if(torch.ones((), dtype=torch.bool, device=dev),
                        lambda: None)
    ran = []
    with graph.eager():
        graph.device_if(torch.ones((), dtype=torch.bool, device=dev),
                        lambda: ran.append(1))
    assert ran == [1]


def test_timed_mode_on_the_card_matches_cpu(dev):
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=20, verbose=0,
              alpha=1.0, mode="timed")
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    sm = st.PHuberSmootherL1L2(1.0)
    s_gpu = st.iterate(method, _small_logreg(dev), "l1", sm, **kw)
    s_cpu = st.iterate(method, _small_logreg("cpu"), "l1", sm, **kw)
    assert s_gpu.epochs == s_cpu.epochs
    assert len(s_gpu.times) == len(s_gpu.obj)
    assert bool((s_gpu.times[1:] >= s_gpu.times[:-1]).all())
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)


@pytest.mark.parametrize("go,stop,want", [(True, 5, 5), (True, 0, 0),
                                          (True, 100, 40), (False, 5, 0)])
def test_device_loop_is_one_while_node(dev, go, stop, want):
    """A captured `device_loop` is one WHILE node whose body is captured
    once (here inside an IF): each replay runs the body while its test
    holds, at most 40 times, and none behind a false IF."""
    from scso_tpu_torch.ops.cuda import graph

    k = torch.zeros((), dtype=torch.int32, device=dev)
    bound = torch.zeros((), dtype=torch.int32, device=dev)
    live = torch.zeros((), dtype=torch.bool, device=dev)
    outer = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        k.add_(1)
        live.copy_((k < bound) & (k < 40))

    def fn():
        k.zero_()
        live.copy_(k < bound)
        graph.device_if(outer, lambda: graph.device_loop(live, 40, body))

    cap = graph.capture(fn, dev)
    assert cap.nodes is None or cap.nodes < 30
    for _ in range(2):
        outer.fill_(go)
        bound.fill_(stop)
        cap.replay()
        torch.cuda.synchronize()
        assert int(k) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_sums_capture_with_skewed_groups(dev, dtype):
    """The group sums capture (no host read), replay to the eager bits,
    and stay O(n) for one group of 3000 among 3000 singletons."""
    from scso_tpu_torch.ops.cuda import graph

    rng = np.random.default_rng(5)
    seg = rng.permutation(np.concatenate([np.zeros(3000, np.int64),
                                          np.arange(1, 3001)]))
    g = st.make_groups(seg, dtype=dtype, device=dev)
    assert g.offsets.shape == (g.n_groups + 1,)
    v = torch.tensor(rng.standard_normal(seg.size), dtype=dtype, device=dev)
    out = torch.empty(g.n_groups, dtype=dtype, device=dev)
    cap = graph.capture(
        lambda: out.copy_(st.ops.groups.segment_sum(g, v)), dev)
    cap.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, st.ops.groups.segment_sum(g, v))
    _check(out.cpu(), st.ops.groups.segment_sum(
        st.make_groups(seg, dtype=dtype), v.cpu()), dtype)


def test_dense_solve_captures_after_a_timed_dense_solve(dev):
    """C14: a dense solve captured in timed mode (at a graph's top
    level) left cuSOLVER's getrs allocating stream-ordered memory, which
    a later fused capture (the solve inside a conditional body) refused
    at instantiate. Dense solves on the card take the LU factors and two
    triangular solves (`linalg._lu_triangular`): the fused solve now
    captures, and replays to its eager form's bits."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        100, 50, density=0.3, n_active=8, seed=1234, dtype=np.float64,
        label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 0.1,
                      grad_fx=losses.logistic01_grad,
                      hess_fx=losses.logistic01_hess, dtype=torch.float64,
                      device=dev)
    sm = st.PHuberSmootherL1L2(1.0)
    kw = dict(verbose=0, max_epoch=30)
    st.iterate(st.ProxNSCORE(solver="dense"), prob, "l1", sm, mode="timed",
               **kw)
    Q, c, q0 = synthetic.make_box_qp(10, seed=1234, dtype=np.float64)
    qp = st.Problem(Q, c, q0, losses.qp_f, 1e-4, grad_fx=losses.qp_grad,
                    hess_fx=losses.qp_hess, C_set=[-1.0, 1.0],
                    dtype=torch.float64, device=dev)
    box = st.PHuberSmootherIndBox(-1.0, 1.0, 0.6)
    fused = st.iterate(st.ProxNSCORE(), qp, "indbox", box, alpha=0.8, **kw)
    eager = st.iterate(st.ProxNSCORE(), qp, "indbox", box, alpha=0.8,
                       _capture=False, **kw)
    assert fused.epochs == eager.epochs and torch.equal(fused.x, eager.x)
