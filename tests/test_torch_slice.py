"""The port's main-path slice end to end against scso_tpu.

`scso_tpu_torch.iterate(ProxGGNSCORE(solver='cg'), ...)` on the CPU
(kernels resolve to 'torch', the plain versions) against
`scso_tpu.iterate(ProxGGNSCORE(solver='cg', kernels='xla'), ...)`, both in
float64 on the same numpy logistic01 problem, 512×256 and a feature-
padded 384×200:
  * greedy off (the branch-free damped cached path): same epoch count
    and objective history to 1e-9 relative;
  * greedy on: the fixed point, final objective to 1e-8 relative (the
    accept test turns last-ulp differences into different trajectories,
    so greedy runs are compared only at the fixed point);
  * one step from the JAX-primed cache, carried over by utils/convert.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.algorithms import steps as jsteps
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops.lbfgs_core import init_memory
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.algorithms.iterate import _resolve_kernels
from scso_tpu_torch.models import losses
from scso_tpu_torch.utils.convert import (
    glm_cache_from_numpy, problem_from_numpy)

torch.set_num_threads(1)

SHAPES = [(512, 256, False), (384, 200, True)]
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
          stats_every=4, alpha=1.0)


def _problems(m, n, pad, seed=7):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.05, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64,
                      pad_features=pad)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    pad_features=pad, device="cpu")
    return pj, pt


def _solve(pj, pt, greedy):
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla",
                                        greedy_alpha=greedy),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(solver="cg", greedy_alpha=greedy),
                   pt, "l1", st.PHuberSmootherL1L2(1.0), **KW)
    return sj, s


@pytest.mark.parametrize("m,n,pad", SHAPES)
def test_damped_trajectory_matches(m, n, pad):
    sj, s = _solve(*_problems(m, n, pad), greedy=False)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-9)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), atol=1e-9)


@pytest.mark.parametrize("m,n,pad", SHAPES)
def test_greedy_fixed_point_matches(m, n, pad):
    sj, s = _solve(*_problems(m, n, pad), greedy=True)
    assert float(s.obj[-1]) == pytest.approx(float(sj.obj[-1]), rel=1e-8)


def test_x_is_sliced_back_to_n_true():
    _, pt = _problems(384, 200, True)
    assert tuple(pt.A.shape) == (384, 256) and pt.n_true == 200
    s = st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    assert tuple(s.x.shape) == (200,)
    assert tuple(s.state.x.shape) == (256,)
    assert bool((s.state.x[200:] == 0).all())


@pytest.mark.parametrize("greedy", [False, True])
def test_one_step_from_the_jax_primed_cache(greedy):
    pj, _ = _problems(512, 256, False, seed=3)
    mj = scso.ProxGGNSCORE(solver="cg", kernels="xla", greedy_alpha=greedy)
    sm_j = scso.PHuberSmootherL1L2(1.0)
    x0 = pj.x0
    cache = jsteps.prime_glm_cache(mj, pj, x0)
    out_j = jsteps.ggn_step(
        mj, pj, "l1", sm_j, pj.A, pj.y, x0, x0, jnp.zeros_like(x0),
        jnp.int32(1), init_memory(256, 1, np.float64),
        d_prev=jnp.zeros_like(x0), bnorm_prev=jnp.asarray(jnp.nan),
        fcache=cache)

    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(x0), np.asarray(pj.lam),
                            device="cpu")
    ct = glm_cache_from_numpy(*(np.asarray(f) for f in cache),
                              device="cpu")
    mt = st.ProxGGNSCORE(solver="cg", greedy_alpha=greedy, kernels="torch")
    xt = pt.x0
    out = steps.ggn_step(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), pt.A,
                         pt.y, xt, xt, 1, d_prev=torch.zeros_like(xt),
                         bnorm_prev=None, fcache=ct)
    assert out.cg_iters == int(out_j.cg_iters)
    for got, want in ((out.x_new, out_j.x_new), (out.d, out_j.d),
                      (out.dx, out_j.dx), (out.pri_res_norm,
                                           out_j.pri_res_norm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
    for got, want in zip(out.fcache, out_j.fcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)


def test_cache_predicate_and_greedy_rule():
    _, pt = _problems(128, 64, False)
    on = st.ProxGGNSCORE(solver="cg")
    assert steps.epoch_cache_enabled(on, pt, "l1", True)
    assert not steps.epoch_cache_enabled(on, pt, "l1", False)
    assert not steps.epoch_cache_enabled(
        st.ProxGGNSCORE(solver="cg", epoch_cache=False), pt, "l1", True)
    assert not steps.epoch_cache_enabled(
        st.ProxGGNSCORE(solver="cg", ss_type=2), pt, "l1", True)
    # AUTO greedy: on at n >= 4096 only (kept from the JAX package)
    assert not steps.use_greedy(on, 4095, pt)
    assert steps.use_greedy(on, 4096, pt)
    assert steps.use_greedy(st.ProxGGNSCORE(greedy_alpha=True), 10, pt)


def test_kernel_resolution():
    _, pt = _problems(64, 32, False)
    assert _resolve_kernels(st.ProxGGNSCORE(), pt).kernels == "torch"
    assert _resolve_kernels(st.ProxGGNSCORE(kernels="torch"),
                            pt).kernels == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        _resolve_kernels(st.ProxGGNSCORE(kernels="cuda"), pt)
    with pytest.raises(ValueError):
        st.ProxGGNSCORE(kernels="pallas")


@pytest.mark.parametrize("method,kw", [
    (st.ProxGGNSCORE(solver="cg"), {"resume_state": None}),
    (st.ProxGGNSCORE(solver="dense_dual"), {}),
    (st.ProxGGNSCORE(solver="cg", auto_lp=True), {}),
    (st.ProxGGNSCORE(solver="cg"), {"batch_size": 16}),
    (st.ProxGGNSCORE(solver="cg"), {"mode": "timed"}),
])
def test_unported_parts_raise(method, kw):
    _, pt = _problems(64, 32, False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.iterate(method, pt, "l1", st.PHuberSmootherL1L2(1.0),
                   verbose=0, max_epoch=2, **kw)
