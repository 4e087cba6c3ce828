"""The port's CUDA kernels and its solve on the card (marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, and a small float64 solve through the kernels against the
plain path on the CPU. K1s runs under a one-rank NCCL group, where it
must be K1 bit for bit. Without a CUDA device every test here skips.
This file imports neither jax nor scso_tpu, so it also runs on a GPU
machine without them — there, skip tests/conftest.py (which configures
jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances: float32 rtol 2e-5, atol 3e-5·max(1, max|ref|) (the f32
bounds of tests/test_pallas.py); float64 1e-12 of each; the small
solves' objective histories 1e-9 relative. Every kernel's rerun is
bitwise equal. TF32 is off for the plain
versions' matrix products.
"""

import socket

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
from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_matvec, mglm_matvec_torch
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)
from scso_tpu_torch.ops.cuda.two_loop import two_loop, two_loop_torch
from scso_tpu_torch.parallel import distributed_init, make_mesh, shard_problem

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 3e-5), torch.float64: (1e-12, 1e-12)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(37, 128), (947, 384), (3465, 2432),
                                 (999, 1001)])
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
    assert counters.snapshot() == {"normal_matvec": 1,
                                   "normal_matvec_sharded": 0,
                                   "glm_prep": 0, "glm_prep_pair": 2,
                                   "score_update": 0, "mglm_matvec": 0,
                                   "two_loop": 0}


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


def _mglm_inputs(dev, dtype, m, p, k):
    gen = torch.Generator(device=dev).manual_seed(m * 131 + p * 7 + k)
    A = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, k, (m,), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(labels, k).to(dtype)
    W = torch.randn((p, k), generator=gen, device=dev, dtype=dtype) * 0.3
    V = torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
    return A, y, A @ W, V


# boundary shapes, the widest p of the one-read form (k <= 16, p <= 1024)
# and the first past it, then k across both forms
MGLM_SHAPES = ([(512, 128, 8), (700, 256, 4), (130, 128, 3), (16, 1, 2),
                (33, 5, 7), (8, 12, 2), (64, 4, 11), (300, 1024, 16),
                (300, 1025, 9), (300, 1025, 2)]
               + [(1031, 77, k) for k in (1, 2, 3, 7, 16, 17, 64, 128)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p,k", MGLM_SHAPES)
def test_mglm_matvec_matches_plain(dev, dtype, m, p, k):
    A, y, Z, V = _mglm_inputs(dev, dtype, m, p, k)
    spec = losses.multinom_mglm(k)
    want = mglm_matvec_torch(A, y, Z, V, spec)
    counters.reset()
    got = mglm_matvec(A, y, Z, V, spec)
    assert tuple(got.shape) == (p, k)
    _check(got, want, dtype)
    assert torch.equal(got, mglm_matvec(A, y, Z, V, spec))
    assert counters.snapshot()["mglm_matvec"] == 2


def test_mglm_matvec_rejects_what_the_kernel_does_not_take(dev):
    A, y, Z, V = _mglm_inputs(dev, torch.float32, 64, 8, 3)
    with pytest.raises(ValueError, match="A9"):
        mglm_matvec(A, y, Z, V, replace(losses.multinom_mglm(3),
                                        kind="poisson"))
    A, y, Z, V = _mglm_inputs(dev, torch.float32, 16, 4, 129)
    with pytest.raises(ValueError, match="128"):
        mglm_matvec(A, y, Z, V, losses.multinom_mglm(129))


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
@pytest.mark.parametrize("m,n", [(660, 256), (3465, 2432), (4099, 10112),
                                 (947, 384), (999, 1001)])
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    A = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        normal_matvec(A, torch.zeros(4, device=dev, dtype=torch.float64),
                      torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        normal_matvec(A.t(), torch.zeros(8, device=dev),
                      torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="B2"):
        glm_prep_pair(A, torch.zeros(4, device=dev), torch.zeros(8, device=dev),
                      torch.zeros(8, device=dev),
                      replace(LOGISTIC01_GLM, kind="poisson"))
    with pytest.raises(ValueError, match="B2"):
        glm_prep(A, torch.zeros(4, device=dev), torch.zeros(8, device=dev),
                 replace(LOGISTIC01_GLM, kind="poisson"))
    g = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="64"):
        two_loop(lbfgs_core.init_memory(8, 65, torch.float32, dev), g)
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


def _small_logreg(device):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 200, density=0.05, n_active=8, seed=7, dtype=np.float64,
        label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, 0.01,
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


@pytest.fixture
def nccl_mesh(dev):
    """A one-rank NCCL group on the card (a TCP store on localhost)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert distributed_init(init_method=f"tcp://localhost:{port}",
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
@pytest.mark.parametrize("m,n", [(660, 256), (999, 1001)])
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
    for g, w_ in zip(glm_prep(A, y, xt, LOGISTIC01_GLM, m_norm),
                     glm_prep_torch(A, y, xt, LOGISTIC01_GLM, m_norm)[:3]):
        _check(g, w_, dtype)
    # m_norm = m is the unsharded kernel, bit for bit
    assert all(torch.equal(g, w_) for g, w_ in zip(
        glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, m),
        glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)))


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
