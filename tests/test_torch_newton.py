"""The port's ProxNSCORE and dense GGN solves against scso_tpu.

Same numpy inputs, float64, through each JAX function and its port:
  * `_resolve_newton_solver` and `_resolve_ggn_solver`: dense up to the
    budgets, CG above (warned once a shape), an explicit solver wins;
  * the reference's 5×2 oracle fixture (tests/test_algs.py), l1 and l2:
    `ProxNSCORE()` (dense, autograd Hessian) to rel and objrel ≤ 1e-6
    with x within 1e-10 of `scso.iterate`, the user hess_fx against
    autograd, and `ProxGGNSCORE(solver=s)` for s in auto, dense_dual and
    dense_primal, each to the oracle's 1e-6, within 1e-6 of each other
    and within 1e-10 of `scso.iterate`;
  * the plain version of K2's newton flavour (`glm_prep_pair_torch(...,
    flavour='newton')`, also through the `glm_prep_pair` wrapper on CPU
    tensors for a kind=None spec) against the Pallas kernel
    `_fused_glm_prep_pair` in interpret mode with
    `_glm_kernel_fns(g, m, 'newton')`, rtol 1e-10 and atol
    1e-12·max|ref|;
  * Newton-CG solves against `scso.iterate(kernels='xla')`: greedy off,
    the same epochs and CG iterations and objective histories to 1e-10
    relative; greedy on, the final objective to 1e-8 (the accept test
    turns last-ulp differences into other trajectories). Cached
    logistic01 under kernels='cuda' on CPU tensors (each wrapper on its
    plain version) and 'torch'; uncached (ss_type 2 and 3,
    epoch_cache=False); multinomial (K5's system); a problem with the
    hvp_w hook only and one with neither (forward-over-reverse HVPs);
  * at λ = 0.01, where the greedy Newton iteration runs away on this
    data, the same objectives (1e-10) until both packages turn
    non-finite at the same record (the Newton-CG trajectory tests use
    λ = 0.1 for that reason);
  * one `newton_step` from a JAX-primed newton-flavour cache, carried
    over by `utils/convert.glm_cache_from_numpy`, to 1e-10.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu._src.struct import replace as jreplace
from scso_tpu.algorithms import steps as jsteps
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops.lbfgs_core import init_memory
from scso_tpu.ops.pallas.glm_prep import _fused_glm_prep_pair
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import iterate as titerate
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import (
    glm_prep_pair, glm_prep_pair_torch)
from scso_tpu_torch.utils.convert import (
    glm_cache_from_numpy, problem_from_numpy)

torch.set_num_threads(1)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)


def _close(got, want, rtol=1e-10, atol=1e-12):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


@pytest.mark.parametrize("n", [50, 2048, 2049])
@pytest.mark.parametrize("solver", ["auto", "dense", "cg"])
def test_newton_solver_resolution(monkeypatch, n, solver):
    monkeypatch.setattr(steps, "_warned", set())
    monkeypatch.setattr(jsteps, "_warned", set())
    want = jsteps._resolve_newton_solver(scso.ProxNSCORE(solver=solver),
                                         jnp.zeros((n,)))
    assert want == ("cg" if solver == "cg" or (solver == "auto" and n > 2048)
                    else "dense")
    method = st.ProxNSCORE(solver=solver)
    if want == "cg" and solver == "auto":
        with pytest.warns(UserWarning, match="Newton-CG"):
            assert steps._resolve_newton_solver(method, torch.zeros(n)) \
                == want
        # once a shape
        assert steps._resolve_newton_solver(method, torch.zeros(n)) == want
    else:
        assert steps._resolve_newton_solver(method, torch.zeros(n)) == want


# --- the reference's 5×2 logistic oracle (tests/test_algs.py) -------------
A_LOG = np.array([[-0.560501, 0.0], [0.0, 1.85278], [-0.0192918, -0.827763],
                  [0.128064, 0.110096], [0.0, -0.251176]])
Y_LOG = np.array([-1.0, -1.0, -1.0, 1.0, -1.0])
X0_LOG = np.array([0.5908446386657102, 0.7667970365022592])


def _j_f_reg(A, y, x):
    return jnp.sum(jnp.log1p(jnp.exp(-y * (A @ x)))) / 5.0


def _j_f_reg_y(y, yhat):
    return -jnp.sum(y * jnp.log(yhat) + (1.0 - y) * jnp.log(1.0 - yhat)) / 5.0


def _j_mfunc(A, x):
    return 1.0 / (1.0 + jnp.exp(-(A @ x)))


def _t_f_reg(A, y, x):
    return torch.sum(torch.log1p(torch.exp(-y * (A @ x)))) / 5.0


def _t_mfunc(A, x):
    return 1.0 / (1.0 + torch.exp(-(A @ x)))


def _oracle(ggn=False, user=False):
    jkw, tkw = {}, {}
    if ggn:
        jkw = dict(out_fn=_j_mfunc, loss_fn=_j_f_reg_y)
        tkw = dict(out_fn=_t_mfunc, loss_fn=losses.logistic_loss_01)
    if user:
        jkw = dict(grad_fx=jlosses.logistic_grad,
                   hess_fx=jlosses.logistic_hess)
        tkw = dict(grad_fx=losses.logistic_grad, hess_fx=losses.logistic_hess)
    pj = scso.Problem(A_LOG, Y_LOG, X0_LOG, _j_f_reg, 1.0, dtype=np.float64,
                      **jkw)
    pt = st.Problem(A_LOG, Y_LOG, X0_LOG, _t_f_reg, 1.0, dtype=torch.float64,
                    device="cpu", **tkw)
    return pj, pt


def _oracle_check(sol):
    assert float(sol.rel[-1]) <= 1e-6
    assert float(sol.objrel[-1]) <= 1e-6


@pytest.mark.parametrize("reg_name", ["l1", "l2"])
def test_oracle_newton_dense(reg_name):
    sm_j, sm_t = scso.PHuberSmootherL1L2(1.0), st.PHuberSmootherL1L2(1.0)
    pj, pt = _oracle()
    sj = scso.iterate(scso.ProxNSCORE(), pj, reg_name, sm_j, verbose=0)
    s = st.iterate(st.ProxNSCORE(), pt, reg_name, sm_t, verbose=0)
    _oracle_check(s)
    assert s.epochs == sj.epochs and s.cg_info is None
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-10)
    # the closed-form gradient and Hessian against autograd
    _, pu = _oracle(user=True)
    su = st.iterate(st.ProxNSCORE(), pu, reg_name, sm_t, verbose=0)
    _close(su.x.numpy(), s.x.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("reg_name", ["l1", "l2"])
def test_oracle_ggn_dense_variants(reg_name):
    sm_j, sm_t = scso.PHuberSmootherL1L2(1.0), st.PHuberSmootherL1L2(1.0)
    pj, pt = _oracle(ggn=True)
    xs = {}
    for solver in ("auto", "dense_dual", "dense_primal"):
        s = st.iterate(st.ProxGGNSCORE(solver=solver), pt, reg_name, sm_t,
                       verbose=0)
        _oracle_check(s)
        xs[solver] = s.x.numpy()
        if solver == "auto":
            continue  # the primal branch here (q + 1 = 6 > n = 2)
        sj = scso.iterate(scso.ProxGGNSCORE(solver=solver), pj, reg_name,
                          sm_j, verbose=0)
        assert s.epochs == sj.epochs
        _close(xs[solver], np.asarray(sj.x), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(xs["auto"], xs["dense_primal"])
    np.testing.assert_allclose(xs["dense_dual"], xs["auto"], atol=1e-6)


@pytest.mark.parametrize("hooks", ["autograd", "user"])
def test_ggn_pieces_match(hooks):
    """Problem.ggn_pieces and ggn_residual_qdiag against the JAX
    package's, from autograd of out_fn/loss_fn or from the user's
    jac_yx, grad_fy, hess_fy and hess_fy_diag."""
    pj, pt = _oracle(ggn=True)
    if hooks == "user":
        jh = dict(jac_yx=jlosses.sigmoid_jac,
                  grad_fy=jlosses.logistic_ggn_residual,
                  hess_fy=lambda A, y, yh: jnp.diag(
                      jlosses.logistic_ggn_qdiag(A, y, yh)),
                  hess_fy_diag=jlosses.logistic_ggn_qdiag)
        th = dict(jac_yx=losses.sigmoid_jac,
                  grad_fy=losses.logistic_ggn_residual,
                  hess_fy=lambda A, y, yh: torch.diag(
                      losses.logistic_ggn_qdiag(A, y, yh)),
                  hess_fy_diag=losses.logistic_ggn_qdiag)
        pj, pt = jreplace(pj, **jh), replace(pt, **th)
    x = np.array([0.3, -0.7])
    for got, want in ((pt.ggn_pieces(pt.A, pt.y, _t(x)),
                       pj.ggn_pieces(pj.A, pj.y, jnp.asarray(x))),
                      (pt.ggn_residual_qdiag(pt.A, pt.y, _t(x)),
                       pj.ggn_residual_qdiag(pj.A, pj.y, jnp.asarray(x)))):
        for g, w in zip(got, want):
            _close(g, w)
    with pytest.raises(ValueError, match="out_fn"):
        replace(pt, out_fn=None).ggn_pieces(pt.A, pt.y, _t(x))


def test_ggn_solver_resolution(monkeypatch):
    monkeypatch.setattr(steps, "_warned", set())
    _, pt = _oracle(ggn=True)
    assert steps._resolve_ggn_solver(st.ProxGGNSCORE(), pt, pt.x0) == "auto"
    big = replace(pt, m_total=(1 << 23) + 1)  # J past 2²⁴ elements
    with pytest.warns(UserWarning, match="GGN-CG"):
        assert steps._resolve_ggn_solver(st.ProxGGNSCORE(), big,
                                         big.x0) == "cg"
    assert steps._resolve_ggn_solver(st.ProxGGNSCORE(solver="dense_dual"),
                                     big, big.x0) == "dense_dual"
    # without the matrix-free pieces 'auto' stays dense at any size
    nothing = replace(big, out_fn=None)
    assert steps._resolve_ggn_solver(st.ProxGGNSCORE(), nothing,
                                     nothing.x0) == "auto"


# --- K2's newton flavour ---------------------------------------------------
@pytest.mark.parametrize("m,n", [(660, 256), (131, 128)])
def test_plain_newton_prep_matches_pallas(m, n):
    rng = np.random.default_rng(m + n)
    A = rng.standard_normal((m, n)) * 0.1
    y = (rng.random(m) < 0.5).astype(np.float64)
    xt = rng.standard_normal(n) * 0.3
    xd = rng.standard_normal(n) * 0.3
    rw_fn, w_fn, loss_fn = jsteps._glm_kernel_fns(jlosses.LOGISTIC01_GLM,
                                                  m, "newton")
    want = _fused_glm_prep_pair(jnp.asarray(A), jnp.asarray(y),
                                jnp.asarray(xt), jnp.asarray(xd), rw_fn,
                                w_fn, loss_fn, interpret=True)
    args = (_t(A), _t(y), _t(xt), _t(xd))
    got = glm_prep_pair_torch(*args, losses.LOGISTIC01_GLM,
                              flavour="newton")
    for g, w in zip(got, want):
        _close(g, w)
    # the wrapper on CPU tensors, a spec the kernel does not compute
    # itself (the split form on the card)
    counters.reset()
    split = glm_prep_pair(*args, replace(losses.LOGISTIC01_GLM, kind=None),
                          flavour="newton")
    assert set(counters.snapshot().values()) == {0}
    for g, w in zip(split, want):
        _close(g, w)
    with pytest.raises(ValueError, match="flavour"):
        glm_prep_pair(*args, losses.LOGISTIC01_GLM, flavour="gauss")


# --- Newton-CG solves --------------------------------------------------------
def _logreg(m, n, seed=7, glm=True, lam=0.01, **hooks):
    """The logistic01 problem in both packages: with the GLM spec, or
    without it and with the named loss hooks (e.g.
    hvp_w='logistic01_hvp_w')."""
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.05, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    jh = {k: getattr(jlosses, v) for k, v in hooks.items()}
    th = {k: getattr(losses, v) for k, v in hooks.items()}
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM if glm else None,
                      dtype=np.float64, **jh)
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM if glm else None,
                    dtype=torch.float64, device="cpu", **th)
    return pj, pt


def _mglm():
    A, y, x0, _ = jsynth.make_multinomial_data(256, 32, 4, seed=11,
                                               dtype=np.float64)
    pj = scso.Problem(A, y, x0, jlosses.multinom_f, 1e-2,
                      grad_fx=jlosses.multinom_grad,
                      mglm=jlosses.multinom_mglm(4), dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.multinom_f, 1e-2,
                    grad_fx=losses.multinom_grad,
                    mglm=losses.multinom_mglm(4), dtype=torch.float64,
                    device="cpu")
    return pj, pt


def _port_solve(method, pt):
    """st.iterate, or for kernels='cuda' on CPU tensors (which `iterate`
    refuses) its solve loop itself: each wrapper then runs its plain
    version."""
    sm = st.PHuberSmootherL1L2(1.0)
    if method.kernels != "cuda":
        return st.iterate(method, pt, "l1", sm, **KW)
    kw = dict(KW)
    prob = titerate._effective_L(pt, kw.pop("alpha"))
    return titerate._solve_impl(method, prob, "l1", sm,
                                titerate.Options(**kw))


CASES = {
    "cached-cuda": (dict(), "cuda", "glm"),
    "cached-torch": (dict(), "torch", "glm"),
    "cached-greedy": (dict(greedy_alpha=True), "torch", "glm"),
    "no-cache": (dict(epoch_cache=False), "torch", "glm"),
    "ss2": (dict(ss_type=2), "torch", "glm"),
    "ss3": (dict(ss_type=3), "torch", "glm"),
    "mglm": (dict(), "torch", "mglm"),
    "hvp_w-hook": (dict(), "torch", "hvp_w"),
    "hvp_f": (dict(), "torch", "none"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_newton_cg_trajectory_matches(case):
    kw, kernels, problem = CASES[case]
    kw.setdefault("greedy_alpha", False)
    if problem == "mglm":
        pj, pt = _mglm()
    else:  # "none": neither a spec nor the hvp_w hook
        hooks = dict(hvp_w="logistic01_hvp_w") if problem == "hvp_w" else {}
        pj, pt = _logreg(384, 200, glm=problem == "glm", lam=0.1, **hooks)
    method = st.ProxNSCORE(solver="cg", kernels=kernels, **kw)
    cached = (problem in ("glm", "mglm") and kw.get("ss_type", 1) == 1
              and kw.get("epoch_cache") is not False)
    assert steps.epoch_cache_enabled(method, pt, "l1", True) == cached
    sj = scso.iterate(scso.ProxNSCORE(solver="cg", kernels="xla", **kw),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    counters.reset()
    s = _port_solve(method, pt)
    assert set(counters.snapshot().values()) == {0}  # CPU: plain versions
    assert (s.state.fcache is not None) == cached
    assert bool(torch.isfinite(s.obj).all())
    if kw["greedy_alpha"]:
        assert float(s.obj[-1]) == pytest.approx(float(sj.obj[-1]),
                                                 rel=1e-8)
        return
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)


def test_newton_divergence_matches_the_reference():
    """At λ = 0.01 the Newton step (here with the greedy trial's full
    steps) runs away on this data in the JAX package: the port follows
    the same objectives to 1e-10 until both turn non-finite at the same
    record."""
    pj, pt = _logreg(384, 200)
    sj = scso.iterate(scso.ProxNSCORE(solver="cg", kernels="xla",
                                      greedy_alpha=True), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxNSCORE(solver="cg", greedy_alpha=True), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    want, got = np.asarray(sj.obj), s.obj.numpy()
    assert not np.isfinite(want[-1])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], rtol=1e-10, atol=0)
    assert s.cg_info == sj.cg_info


def test_newton_step_from_a_jax_primed_cache():
    pj, _ = _logreg(256, 128, seed=6)
    mj = scso.ProxNSCORE(solver="cg", cg_tol=1e-12, kernels="xla",
                         greedy_alpha=True)
    x0 = pj.x0
    cache = jsteps.prime_glm_cache(mj, pj, x0)
    out_j = jsteps.newton_step(
        mj, pj, "l1", scso.PHuberSmootherL1L2(1.0), pj.A, pj.y, x0, x0,
        jnp.zeros_like(x0), jnp.int32(1), init_memory(128, 1, np.float64),
        d_prev=jnp.zeros_like(x0), bnorm_prev=jnp.asarray(jnp.nan),
        fcache=cache)
    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(x0), np.asarray(pj.lam), grad_fx=True,
                            device="cpu")
    fc = glm_cache_from_numpy(*(np.asarray(f) for f in cache), device="cpu")
    mt = st.ProxNSCORE(solver="cg", cg_tol=1e-12, kernels="cuda",
                       greedy_alpha=True)
    xt = pt.x0
    out = steps.newton_step(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), pt.A,
                            pt.y, xt, xt, 1, d_prev=torch.zeros_like(xt),
                            fcache=fc)
    assert out.cg_iters == int(out_j.cg_iters)
    for f in ("x_new", "d", "dx", "pri_res_norm"):
        _close(getattr(out, f), getattr(out_j, f))
    for g, w in zip(out.fcache, out_j.fcache):
        _close(g, w)


@pytest.mark.parametrize("what", ["sharded", "static_precond"])
def test_unported_newton_parts_raise(what):
    """A sharded Newton solve still raises (A11); the static Jacobi
    preconditioner of a Newton-CG solve now runs, off the epoch cache,
    as `scso_tpu`'s does."""
    from scso_tpu_torch.algorithms.iterate import _check_sharded

    pj, pt = _logreg(64, 32)
    if what == "sharded":
        with pytest.raises(NotImplementedError, match="A11"):
            _check_sharded(st.ProxNSCORE(solver="cg"),
                           replace(pt, mesh=object()), "l1")
        return
    kw = dict(solver="cg", static_precond=True, greedy_alpha=False)
    pt = st.with_col_sumsq(pt)
    assert not steps.epoch_cache_enabled(st.ProxNSCORE(**kw), pt, "l1",
                                         True)
    sj = scso.iterate(scso.ProxNSCORE(kernels="xla", **kw),
                      scso.with_col_sumsq(pj), "l1",
                      scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxNSCORE(**kw), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **KW)
    assert s.epochs == sj.epochs
    _close(s.obj.numpy(), sj.obj)
    _close(s.x.numpy(), sj.x)
