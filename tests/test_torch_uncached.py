"""The port's uncached GGN-CG path against scso_tpu.

Same numpy inputs, float64, through each JAX function and its port:
  * the plain version of K2s (`glm_prep_torch`, through the `glm_prep`
    wrapper on CPU tensors) against the Pallas kernel `fused_glm_prep`
    in interpret mode at (660, 256) and a small ragged shape, rtol 1e-10
    and atol 1e-12·max|ref| (tests/test_pallas.py's f64 bounds);
  * one uncached `ggn_step` with kernels='cuda' on CPU tensors (the K2s
    branch, each wrapper on its plain version) against the JAX step with
    kernels='pallas', use_fused_prep=True in interpret mode (which
    reaches `fused_glm_prep`), and with kernels='torch' (z = A·x and the
    spec's weights) against kernels='xla', 1e-10;
  * uncached solves — epoch_cache=False, ss_type 2 (inverse BB) and
    ss_type 3 (Armijo) — against `scso.iterate(kernels='xla')`, greedy
    off: the same epochs and CG iterations and objective histories to
    1e-10 relative; greedy on: the fixed point, final objective to 1e-8
    (the accept test turns last-ulp differences into other
    trajectories);
  * an uncached multinomial solve through `_mo_glm_system`, greedy off,
    to the same bounds;
  * uncached solves with the JAX package's bfloat16 copy of A (carried
    over by utils/convert), cg_adaptive=True and cg_lp_tol=1e-3, ss_type
    2 and 3: the bulk epochs' CG on the copy, to the same bounds.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import warnings

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
from scso_tpu.ops.pallas import counters as jcounters
from scso_tpu.ops.pallas.glm_prep import fused_glm_prep
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import glm_prep
from scso_tpu_torch.utils.convert import problem_from_numpy

torch.set_num_threads(1)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)


def _close(got, want, rtol=1e-10, atol=1e-12):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


@pytest.mark.parametrize("m,n", [(660, 256), (131, 128)])
def test_plain_prep_matches_pallas(m, n):
    rng = np.random.default_rng(m + n)
    A = rng.standard_normal((m, n)) * 0.1
    y = (rng.random(m) < 0.5).astype(np.float64)
    x = rng.standard_normal(n) * 0.3
    rw_fn, w_fn, _ = jsteps._glm_kernel_fns(jlosses.LOGISTIC01_GLM, m)
    jcounters.reset()
    want = fused_glm_prep(jnp.asarray(A), jnp.asarray(y), jnp.asarray(x),
                          rw_fn, w_fn)
    assert jcounters.KERNEL_HITS["fused_glm_prep"] == 1  # not its fallback
    counters.reset()
    got = glm_prep(_t(A), _t(y), _t(x), losses.LOGISTIC01_GLM)
    assert counters.snapshot()["glm_prep"] == 0  # plain on the CPU
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


def _logreg(m, n, pad=False, seed=7):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.05, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64,
                      pad_features=pad)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    pad_features=pad, device="cpu")
    return pj, pt


@pytest.mark.parametrize("kernels,jkernels", [("cuda", "pallas"),
                                              ("torch", "xla")])
@pytest.mark.parametrize("greedy", [False, True])
def test_one_uncached_step_matches(kernels, jkernels, greedy):
    pj, _ = _logreg(256, 128, seed=6)
    mj = scso.ProxGGNSCORE(solver="cg", cg_tol=1e-12, kernels=jkernels,
                           use_fused_prep=True, greedy_alpha=greedy,
                           epoch_cache=False)
    x0 = pj.x0
    jcounters.reset()
    out_j = jsteps.ggn_step(
        mj, pj, "l1", scso.PHuberSmootherL1L2(1.0), pj.A, pj.y, x0, x0,
        jnp.zeros_like(x0), jnp.int32(1), init_memory(128, 1, np.float64),
        d_prev=jnp.zeros_like(x0), bnorm_prev=jnp.asarray(jnp.nan))
    assert jcounters.KERNEL_HITS["fused_glm_prep"] == (jkernels == "pallas")

    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(x0), np.asarray(pj.lam), grad_fx=True,
                            device="cpu")
    mt = st.ProxGGNSCORE(solver="cg", cg_tol=1e-12, kernels=kernels,
                         greedy_alpha=greedy, epoch_cache=False)
    xt = pt.x0
    counters.reset()
    out = steps.ggn_step(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), pt.A,
                         pt.y, xt, xt, 1, d_prev=torch.zeros_like(xt))
    assert set(counters.snapshot().values()) == {0}  # CPU: plain versions
    assert out.fcache is None
    assert out.cg_iters == int(out_j.cg_iters)
    for f in ("x_new", "d", "dx", "pri_res_norm", "gq", "gq_new"):
        _close(getattr(out, f), getattr(out_j, f))


def _solve(pj, pt, **kw):
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla", **kw),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(solver="cg", **kw), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    return sj, s


# greedy resolves off for ss_type 2 and 3 (the JAX package's AUTO rule)
@pytest.mark.parametrize("kw", [dict(epoch_cache=False, greedy_alpha=False),
                                dict(ss_type=2), dict(ss_type=3)])
def test_uncached_trajectory_matches(kw):
    pj, pt = _logreg(512, 256)
    assert not steps.epoch_cache_enabled(st.ProxGGNSCORE(solver="cg", **kw),
                                         pt, "l1", True)
    sj, s = _solve(pj, pt, **kw)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)
    assert s.state.fcache is None


@pytest.mark.parametrize("pad", [False, True])
def test_uncached_greedy_fixed_point_matches(pad):
    sj, s = _solve(*_logreg(384, 200, pad), epoch_cache=False,
                   greedy_alpha=True)
    assert float(s.obj[-1]) == pytest.approx(float(sj.obj[-1]), rel=1e-8)
    assert tuple(s.x.shape) == (200,)


def test_uncached_multinomial_trajectory_matches():
    A, y, x0, _ = jsynth.make_multinomial_data(256, 32, 4, seed=11,
                                               dtype=np.float64)
    pj = scso.Problem(A, y, x0, jlosses.multinom_f, 1e-2,
                      grad_fx=jlosses.multinom_grad,
                      mglm=jlosses.multinom_mglm(4), dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.multinom_f, 1e-2,
                    grad_fx=losses.multinom_grad,
                    mglm=losses.multinom_mglm(4), dtype=torch.float64,
                    device="cpu")
    sj, s = _solve(pj, pt, epoch_cache=False, greedy_alpha=False)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("ss_type", [2, 3])
def test_uncached_lp_copy_trajectory_matches(ss_type):
    pj, _ = _logreg(512, 256)
    pj = scso.with_lp_copy(pj)
    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(pj.x0), np.asarray(pj.lam),
                            grad_fx=True, device="cpu",
                            A_lp=np.asarray(pj.A_lp, np.float32))
    kw = dict(ss_type=ss_type, cg_adaptive=True, cg_lp_tol=1e-3)
    sj, s = _solve(pj, pt, **kw)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kw,match", [
    (dict(curvature_rows=256), "A7"),
    (dict(static_precond=True), "A7"),
])
def test_unported_uncached_options_raise(kw, match):
    """Subsampled curvature and the static preconditioner raised until
    their item (``match``) was ported: now each uncached solve runs as
    scso_tpu's, the histories to 1e-10."""
    pj, pt = _logreg(512, 64)
    if kw.get("static_precond"):
        pj, pt = scso.with_col_sumsq(pj), st.with_col_sumsq(pt)
    opts = dict(verbose=0, max_epoch=12, x_tol=1e-12, f_tol=1e-12,
                alpha=1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # curvature_rows < 2·n warns
        sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", epoch_cache=False,
                                            kernels="xla", **kw),
                          pj, "l1", scso.PHuberSmootherL1L2(1.0), **opts)
        s = st.iterate(st.ProxGGNSCORE(solver="cg", epoch_cache=False, **kw),
                       pt, "l1", st.PHuberSmootherL1L2(1.0), **opts)
    assert s.epochs == sj.epochs, match
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)
