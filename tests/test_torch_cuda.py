"""The port's CUDA kernels and its solve on the card (marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, and a small float64 solve through the kernels against the
plain path on the CPU. Without a CUDA device every test here skips.
This file imports neither jax nor scso_tpu, so it also runs on a GPU
machine without them — there, skip tests/conftest.py (which configures
jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances: float32 rtol 2e-5, atol 3e-5·max(1, max|ref|) (the f32
bounds of tests/test_pallas.py); float64 1e-12 of each; the small
solve's objective history 1e-9 relative.
"""

import numpy as np
import pytest
import torch

import scso_tpu_torch as st
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.models.losses import LOGISTIC01_GLM
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import glm_prep_pair, glm_prep_pair_torch
from scso_tpu_torch.ops.cuda.matvec import normal_matvec, normal_matvec_torch
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 3e-5), torch.float64: (1e-12, 1e-12)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
    assert counters.snapshot() == {"normal_matvec": 1, "glm_prep_pair": 2,
                                   "score_update": 0}


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
    assert min(counters.snapshot().values()) > 0
    s_cpu = st.iterate(method, mk("cpu"), "l1", st.PHuberSmootherL1L2(1.0),
                       **kw)
    assert s_gpu.epochs == s_cpu.epochs
    assert tuple(s_gpu.x.shape) == (200,)
    np.testing.assert_allclose(s_gpu.obj.numpy(), s_cpu.obj.numpy(),
                               rtol=1e-9)
