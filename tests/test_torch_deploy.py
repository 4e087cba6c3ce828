"""Serving and export (`scso_tpu_torch.utils.deploy`) against the JAX
package's artifact (tests/test_deploy.py's cases), float64 on the CPU
(tests/test_torch_export.py holds the exported program's other
cases).

The port's round trip equals its own ``iterate`` bit for bit, and the
JAX artifact's ``serve`` to 1e-12 (absolute on x, relative on the
objective); fresh data through the artifact equals a fresh solve."""

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.utils import export_solver as jexport
from scso_tpu.utils import load_solver as jload
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.utils import export_solver, load_solver, make_serving_fn

TOL = 1e-12  # the port's serve against the JAX artifact's


def _data(seed=1, label01=False):
    return synthetic.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=seed, dtype=np.float64,
        label01=label01)


def _prob(seed=1, data=None):
    A, y, x0, _ = data if data is not None else _data(seed)
    return st.Problem(A, y, x0, losses.logistic_f, 1e-2,
                      grad_fx=losses.logistic_grad,
                      hess_fx=losses.logistic_hess, dtype=torch.float64,
                      device="cpu")


def _jprob(seed=1):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=seed, dtype=np.float64)
    return scso.Problem(A, y, x0, jlosses.logistic_f, 1e-2,
                        grad_fx=jlosses.logistic_grad,
                        hess_fx=jlosses.logistic_hess, dtype=np.float64)


def _glm(pkg, loss_mod, seed=3):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=seed, dtype=np.float64,
        label01=True)
    kw = dict(grad_fx=loss_mod.logistic01_grad, glm=loss_mod.LOGISTIC01_GLM)
    if pkg is st:
        return st.Problem(A, y, x0, loss_mod.logistic01_f, 1e-2,
                          dtype=torch.float64, device="cpu", **kw)
    return scso.Problem(A, y, x0, loss_mod.logistic01_f, 1e-2,
                        dtype=np.float64, **kw)


SM = lambda pkg: pkg.PHuberSmootherL1L2(1.0)
METHODS = {
    "newton_dense": lambda pkg: pkg.ProxNSCORE(solver="dense", ss_type=3),
    "ggn_cg": lambda pkg: pkg.ProxGGNSCORE(solver="cg"),
}


def _problems(name):
    if name == "ggn_cg":
        return _glm(st, losses), _glm(scso, jlosses)
    return _prob(), _jprob()


@pytest.mark.parametrize("name", sorted(METHODS))
def test_export_roundtrip_matches_iterate_and_the_jax_artifact(name):
    prob, jprob = _problems(name)
    blob = export_solver(METHODS[name](st), prob, "l1", SM(st))
    assert isinstance(blob, bytes) and len(blob) > 500
    x, k, obj = load_solver(blob, device="cpu")(prob.A, prob.y, prob.x0)
    ref = st.iterate(METHODS[name](st), prob, "l1", SM(st), verbose=0)
    assert int(k) == ref.epochs
    assert torch.equal(x, ref.x)
    assert float(obj) == float(ref.obj[-1])
    jx, jk, jobj = jload(jexport(METHODS[name](scso), jprob, "l1",
                                 SM(scso)))(jprob.A, jprob.y, jprob.x0)
    assert int(k) == int(jk)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(obj), float(jobj), rtol=TOL, atol=0)


def test_fresh_data_through_artifact():
    """Same-shape fresh data: nothing of the template's A, y, x0 is
    baked in; a second call serves as a fresh solve on that data does."""
    prob = _prob(seed=1)
    serve = load_solver(export_solver(METHODS["newton_dense"](st), prob,
                                      "l1", SM(st)), device="cpu")
    serve(prob.A, prob.y, prob.x0)
    data = _data(seed=9)
    x2, k2, o2 = serve(*data[:3])
    ref2 = st.iterate(METHODS["newton_dense"](st), _prob(data=data), "l1",
                      SM(st), verbose=0)
    assert torch.equal(x2, ref2.x) and int(k2) == ref2.epochs
    assert float(o2) == float(ref2.obj[-1])


@pytest.mark.parametrize("static_precond", [False, True])
def test_fresh_data_through_a_cached_ggn_artifact(static_precond):
    """Same-shape fresh data through a cached GGN-CG artifact: the epoch
    cache is primed at the call's x0 and, with ``static_precond``,
    diag(AᵀA) is the call's A's (``with_col_sumsq``); the call gives the
    bits of ``iterate`` on a problem built from that data."""
    from scso_tpu_torch.problems import with_col_sumsq

    method = st.ProxGGNSCORE(solver="cg", static_precond=static_precond)
    attach = with_col_sumsq if static_precond else (lambda p: p)
    tpl = attach(_glm(st, losses))
    serve = load_solver(export_solver(method, tpl, "l1", SM(st)),
                        device="cpu")
    A2, y2, x02, _ = synthetic.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=11, dtype=np.float64,
        label01=True)
    x02 = x02 + 0.01  # the cache primed away from the template's x0
    x2, k2, o2 = serve(A2, y2, x02)
    fresh = attach(st.Problem(A2, y2, x02, losses.logistic01_f, 1e-2,
                              grad_fx=losses.logistic01_grad,
                              glm=losses.LOGISTIC01_GLM,
                              dtype=torch.float64, device="cpu"))
    ref = st.iterate(method, fresh, "l1", SM(st), verbose=0)
    assert ref.epochs > 1
    assert torch.equal(x2, ref.x) and int(k2) == ref.epochs
    assert float(o2) == float(ref.obj[-1])
    stale = st.iterate(method, attach(_glm(st, losses)), "l1", SM(st),
                       verbose=0)
    assert not torch.equal(x2, stale.x)


def test_serving_fn_serves_the_template_and_fresh_data():
    """make_serving_fn itself: the template's solve, then fresh data,
    and the template problem's own tensors are never written."""
    prob = _glm(st, losses)
    A0 = prob.A.clone()
    serve = make_serving_fn(METHODS["ggn_cg"](st), prob, "l1", SM(st))
    x, _, _ = serve(prob.A, prob.y, prob.x0)
    ref = st.iterate(METHODS["ggn_cg"](st), prob, "l1", SM(st), verbose=0)
    assert torch.equal(x, ref.x)
    A2, y2, x02, _ = synthetic.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=11, dtype=np.float64,
        label01=True)
    x2, _, _ = serve(A2, y2, x02)
    fresh = st.Problem(A2, y2, x02, losses.logistic01_f, 1e-2,
                       grad_fx=losses.logistic01_grad,
                       glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                       device="cpu")
    ref2 = st.iterate(METHODS["ggn_cg"](st), fresh, "l1", SM(st), verbose=0)
    assert torch.equal(x2, ref2.x)
    assert torch.equal(prob.A, A0)


def test_padded_problem_takes_unpadded_data():
    """pad_features: the served data come at n_true columns and are
    padded as make_problem pads them; the copy of A for
    precision-adaptive CG is cast again from each call's A."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        96, 20, density=0.3, n_active=4, seed=5, dtype=np.float64,
        label01=True)
    mk = lambda A, y, x0: st.with_lp_copy(st.Problem(
        A, y, x0, losses.logistic01_f, 1e-2, grad_fx=losses.logistic01_grad,
        glm=losses.LOGISTIC01_GLM, dtype=torch.float64, device="cpu",
        pad_features=True))
    meth = st.ProxGGNSCORE(solver="cg", cg_adaptive=True, cg_lp_tol=1e-2)
    prob = mk(A, y, x0)
    assert prob.n_true == 20 and prob.A.shape[1] == 128
    serve = make_serving_fn(meth, prob, "l1", SM(st))
    serve(A, y, x0)
    A2, y2, x02, _ = synthetic.make_sparse_logreg_data(
        96, 20, density=0.3, n_active=4, seed=6, dtype=np.float64,
        label01=True)
    x2, k2, _ = serve(A2, y2, x02)
    ref = st.iterate(meth, mk(A2, y2, x02), "l1", SM(st), verbose=0)
    assert x2.shape == (20,) and torch.equal(x2, ref.x)
    assert int(k2) == ref.epochs
    with pytest.raises(ValueError, match="shape"):
        serve(A2[:, :7], y2, x02)


def test_requires_data_problem():
    p = st.Problem(np.zeros(4), losses.rosenbrock, 1e-3,
                   dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="data problem"):
        export_solver(METHODS["newton_dense"](st), p, "l1", SM(st))
    with pytest.raises(ValueError, match="data problem"):
        make_serving_fn(METHODS["newton_dense"](st), p, "l1", SM(st))
