"""Metrics, a test set, and the curvature options off the epoch cache,
against scso_tpu (float64, CPU).

  * ``Atest``/``ytest`` (``Solution.fvaltest``: f on the test set at each
    record) and ``metrics`` (a torch function recorded on the device in
    fused mode, a host function called at each record in timed mode)
    against the JAX package's to 1e-10, with ``stats_every`` 1 and 4;
  * ``static_precond`` with `with_col_sumsq` (the Jacobi diagonal
    (Σw/m)·diag(AᵀA) + λHr, off the epoch cache) and ``curvature_rows``
    (the RHS over all rows, the CG operator over a strided subsample, off
    the cache) against `scso_tpu.iterate` to 1e-10, in both modes, and
    under kernels='cuda' on CPU tensors (K2s on A and on the subsample,
    K1 on the subsample: their plain versions here); the epoch cache
    refused for each, as the JAX package routes them; the thin
    subsample's warning.
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
from scso_tpu_torch.algorithms import iterate as titerate
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses

torch.set_num_threads(1)

KW = dict(x_tol=1e-12, f_tol=1e-12, verbose=0, alpha=1.0, max_epoch=12)


def _problems(m=512, n=64, test=False, seed=7):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.2, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    At, yt, _, _ = jsynth.make_sparse_logreg_data(
        97, n, density=0.2, n_active=8, seed=seed + 1, dtype=np.float64,
        label01=True)
    extra = dict(Atest=At, ytest=yt) if test else {}
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64, **extra)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    device="cpu", **extra)
    return pj, pt


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("stats_every", [1, 4])
@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_test_set_and_metrics_match(mode, stats_every):
    pj, pt = _problems(test=True)
    jm = {"xnorm": lambda p, x: jnp.linalg.norm(x),
          "test_mse": lambda p, x: jnp.mean(
              (jlosses.sigmoid_out(p.Atest, x) - p.ytest) ** 2)}
    tm = {"xnorm": lambda p, x: torch.linalg.vector_norm(x),
          "test_mse": lambda p, x: torch.mean(
              (losses.sigmoid_out(p.Atest, x) - p.ytest) ** 2)}
    kw = dict(KW, mode=mode, stats_every=stats_every)
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla"), pj,
                      "l1", scso.PHuberSmootherL1L2(1.0), metrics=jm, **kw)
    s = st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), metrics=tm, **kw)
    assert s.epochs == sj.epochs and len(s.fvaltest) == len(s.obj)
    _close(s.fvaltest.numpy(), sj.fvaltest)
    assert sorted(s.metricvals) == sorted(sj.metricvals)
    for name in tm:
        assert len(s.metricvals[name]) == len(s.obj)
        _close(s.metricvals[name].numpy(), np.asarray(sj.metricvals[name]))
    # the test loss is the problem's f on the test set
    assert float(s.fvaltest[0]) == pytest.approx(float(losses.logistic01_f(
        pt.Atest, pt.ytest, pt.x0)), rel=1e-14)


def test_no_test_set_gives_empty_fvaltest():
    _, pt = _problems()
    for mode in ("fused", "timed"):
        s = st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                       st.PHuberSmootherL1L2(1.0), mode=mode, **KW)
        assert s.fvaltest.shape == (0,) and s.metricvals == {}


def test_fused_metric_must_be_a_tensor():
    _, pt = _problems()
    with pytest.raises(TypeError, match="mode='timed'"):
        st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0),
                   metrics={"host": lambda p, x: 1.0}, **KW)
    s = st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), mode="timed",
                   metrics={"host": lambda p, x: 1.0}, **KW)
    assert bool((s.metricvals["host"] == 1.0).all())


CURV = {
    "static_precond": dict(static_precond=True),
    "curvature_rows": dict(curvature_rows=256),
}


@pytest.mark.parametrize("mode", ["fused", "timed"])
@pytest.mark.parametrize("case", list(CURV))
def test_curvature_options_match(case, mode):
    pj, pt = _problems()
    kw = CURV[case]
    if kw.get("static_precond"):
        pj, pt = scso.with_col_sumsq(pj), st.with_col_sumsq(pt)
    mj = scso.ProxGGNSCORE(solver="cg", kernels="xla", **kw)
    mt = st.ProxGGNSCORE(solver="cg", **kw)
    # each option routes off the epoch cache, as in the JAX package
    assert not steps.epoch_cache_enabled(mt, pt, "l1", True)
    assert not jsteps.epoch_cache_enabled(mj, pj, "l1", True)
    sj = scso.iterate(mj, pj, "l1", scso.PHuberSmootherL1L2(1.0),
                      mode=mode, **KW)
    s = st.iterate(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), mode=mode,
                   **KW)
    assert s.epochs == sj.epochs
    if mode == "fused":
        assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), sj.obj)
    _close(s.x.numpy(), sj.x)


@pytest.mark.parametrize("case", ["static_precond", "curvature_rows"])
def test_curvature_options_kernel_route(case):
    """kernels='cuda' on CPU tensors (each wrapper then runs its plain
    version): K2s on A for the RHS and, under curvature_rows, on the
    subsample for its weights and diagonal, K1 on the subsample — the
    same solve as scso_tpu's to 1e-10."""
    pj, pt = _problems()
    kw = CURV[case]
    if kw.get("static_precond"):
        pj, pt = scso.with_col_sumsq(pj), st.with_col_sumsq(pt)
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla", **kw),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    opts = dict(KW)
    prob = titerate._effective_L(pt, opts.pop("alpha"))
    s = titerate._solve_impl(st.ProxGGNSCORE(solver="cg", kernels="cuda",
                                             **kw), prob, "l1",
                             st.PHuberSmootherL1L2(1.0),
                             titerate.Options(**opts))
    assert s.epochs == sj.epochs
    _close(s.obj.numpy(), sj.obj)
    _close(s.x.numpy(), sj.x)


def test_static_precond_diagonal():
    """(Σw/m)·diag(AᵀA) + λHr where the rows are all of A's, the exact
    diagonal on a subsample or a batch (other column sums)."""
    _, pt = _problems()
    pt = st.with_col_sumsq(pt)
    m = pt.A.shape[0]
    w = torch.rand(m, dtype=torch.float64)
    lhr = torch.full((pt.A.shape[1],), 0.5, dtype=torch.float64)
    v = torch.ones_like(lhr)
    method = st.ProxGGNSCORE(static_precond=True, kernels="torch")
    _, M_inv = steps._weighted_system(method, pt, pt.A, pt.x0, w, lhr)
    want = (w.sum() / m) * pt.col_sumsq + lhr
    torch.testing.assert_close(M_inv(v), v / want, rtol=1e-15, atol=0)
    As = pt.A[:100]
    _, M_inv = steps._weighted_system(method, pt, As, pt.x0, w[:100], lhr)
    exact = torch.einsum("i,ij,ij->j", w[:100], As, As) + lhr
    torch.testing.assert_close(M_inv(v), v / exact, rtol=1e-15, atol=0)


def test_thin_subsample_warns(monkeypatch):
    monkeypatch.setattr(steps, "_warned", set())
    _, pt = _problems(m=256, n=64)
    with pytest.warns(UserWarning, match="rank-deficient"):
        steps._curvature_stride(st.ProxGGNSCORE(curvature_rows=100), pt,
                                pt.A, pt.x0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert steps._curvature_stride(st.ProxGGNSCORE(curvature_rows=200),
                                       pt, pt.A, pt.x0) == 2
        assert steps._curvature_stride(st.ProxGGNSCORE(curvature_rows=256),
                                       pt, pt.A, pt.x0) == 0
