"""Problems without data, the generic GGN-CG branch and the package
surface, against scso_tpu (float64, CPU).

  * the QP, Rosenbrock and logistic Hessian-vector losses against
    `scso_tpu.models.losses` to 1e-12; `make_box_qp` bit for bit;
  * `make_problem`'s flavours: f(x) without data, the empty
    `ProblemLike`, a test set padded with A, `with_col_sumsq`;
  * tests/test_algs.py's TestBoxQP (the three box smoothers, Newton) and
    TestRosenbrock (L-BFGS and Newton on f(x)) through both packages,
    x to 1e-8, in both modes;
  * the generic GGN-CG branch (J by jvp and vjp of out_fn, no spec)
    against `scso_tpu.iterate` to 1e-10, with and without the ggn_w
    hook (K1's plain version);
  * every NotImplementedError left in the port is a sharded serve or
    export refusal naming ROADMAP A12, or the refusal of overlapped
    chunks in a captured solve over ranks naming ROADMAP A11; and the
    exports of scso_tpu's ``__all__`` that the port has.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch.models import losses, synthetic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_qp_and_rosenbrock_losses():
    rng = np.random.default_rng(3)
    Q, c, x0 = jsynth.make_box_qp(12, seed=5, dtype=np.float64)
    x = rng.standard_normal(12)
    for name in ("qp_f", "qp_grad", "qp_hess"):
        _close(getattr(losses, name)(_t(Q), _t(c), _t(x)),
               getattr(jlosses, name)(jnp.asarray(Q), jnp.asarray(c),
                                      jnp.asarray(x)), 1e-12)
    for v in ([0.2, -0.5], [1.3, 2.0]):
        _close(losses.rosenbrock(_t(v)), jlosses.rosenbrock(jnp.asarray(v)),
               1e-12)


def test_logistic_hvp_losses():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((40, 9))
    y = np.sign(rng.standard_normal(40))
    x, v = rng.standard_normal(9), rng.standard_normal(9)
    _close(losses.logistic_hvp(_t(A), _t(y), _t(x), _t(v)),
           jlosses.logistic_hvp(*(jnp.asarray(a) for a in (A, y, x, v))),
           1e-12)
    _close(losses.logistic_hvp_w(_t(A), _t(y), _t(x)),
           jlosses.logistic_hvp_w(*(jnp.asarray(a) for a in (A, y, x))),
           1e-12)


@pytest.mark.parametrize("n,seed,dtype", [(10, 1234, np.float64),
                                          (33, 7, np.float32)])
def test_make_box_qp_bit_identical(n, seed, dtype):
    for a, b in zip(synthetic.make_box_qp(n, seed=seed, dtype=dtype),
                    jsynth.make_box_qp(n, seed=seed, dtype=dtype)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_problem_flavours():
    assert isinstance(st.Problem(), st.ProblemLike)
    with pytest.raises(TypeError, match="make_problem takes"):
        st.Problem(1, 2)
    bare = st.Problem(np.array([0.2, -0.5]), losses.rosenbrock, 1e-8,
                      dtype=torch.float64, device="cpu", name="rb")
    assert not bare.has_data and bare.A is None and bare.name == "rb"
    assert float(bare.f_val(None, None, bare.x0)) == pytest.approx(
        float(jlosses.rosenbrock(jnp.asarray([0.2, -0.5]))), rel=1e-14)
    want = jax.grad(jlosses.rosenbrock)(jnp.asarray([0.2, -0.5]))
    torch.testing.assert_close(bare.grad_f(None, None, bare.x0), _t(want),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="requires a data problem"):
        st.Problem(np.zeros(5), losses.rosenbrock, 1e-8, device="cpu",
                   pad_features=True)
    A, y, x0, _ = jsynth.make_sparse_logreg_data(30, 100, density=0.3,
                                                 seed=2, dtype=np.float64,
                                                 label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.1, Atest=A[:7],
                      ytest=y[:7], dtype=np.float64, pad_features=True)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.1, Atest=A[:7],
                    ytest=y[:7], dtype=torch.float64, device="cpu",
                    pad_features=True)
    assert pt.has_data and pt.has_test and pt.Atest.shape == (7, 128)
    assert np.array_equal(pt.Atest.numpy(), np.asarray(pj.Atest))
    np.testing.assert_allclose(st.with_col_sumsq(pt).col_sumsq.numpy(),
                               np.asarray(scso.with_col_sumsq(pj).col_sumsq),
                               rtol=1e-14)
    with pytest.raises(ValueError, match="data problem"):
        st.with_col_sumsq(bare)


def _box_qp():
    Q, c, x0 = jsynth.make_box_qp(10, seed=1234, dtype=np.float64)
    kw = dict(C_set=[-1.0, 1.0], dtype=np.float64)
    pj = scso.Problem(Q, c, x0, jlosses.qp_f, 1e-4, grad_fx=jlosses.qp_grad,
                      hess_fx=jlosses.qp_hess, **kw)
    pt = st.Problem(Q, c, x0, losses.qp_f, 1e-4, grad_fx=losses.qp_grad,
                    hess_fx=losses.qp_hess, C_set=[-1.0, 1.0],
                    dtype=torch.float64, device="cpu")
    return pj, pt


@pytest.mark.parametrize("mode", ["fused", "timed"])
@pytest.mark.parametrize("smoother,alpha", [
    ("PHuberSmootherIndBox", 0.8), ("ExponentialSmootherIndBox", 1.0),
    ("LogExpSmootherIndBox", 0.8)])
def test_box_qp_matches(smoother, alpha, mode):
    """tests/test_algs.py's TestBoxQP through both packages."""
    pj, pt = _box_qp()
    kw = dict(alpha=alpha, max_epoch=200, verbose=0, mode=mode)
    sj = scso.iterate(scso.ProxNSCORE(), pj, "indbox",
                      getattr(scso, smoother)(-1.0, 1.0, 0.6), **kw)
    s = st.iterate(st.ProxNSCORE(), pt, "indbox",
                   getattr(st, smoother)(-1.0, 1.0, 0.6), **kw)
    assert s.epochs == sj.epochs
    _close(s.x.numpy(), sj.x, 1e-8)
    assert bool(((s.x >= -1.0) & (s.x <= 1.0)).all())


@pytest.mark.parametrize("mode", ["fused", "timed"])
@pytest.mark.parametrize("name", ["lbfgs", "newton"])
def test_rosenbrock_matches(name, mode):
    """tests/test_algs.py's TestRosenbrock (the README quick start, f(x)
    without data) through both packages."""
    x0 = np.array([0.2, -0.5])
    pj = scso.Problem(x0, jlosses.rosenbrock, 1e-8, dtype=np.float64)
    pt = st.Problem(x0, losses.rosenbrock, 1e-8, dtype=torch.float64,
                    device="cpu")
    if name == "lbfgs":
        mj, mt = scso.ProxLQNSCORE(m=10), st.ProxLQNSCORE(m=10)
        kw = dict(max_epoch=2000)
    else:
        mj, mt = scso.ProxNSCORE(), st.ProxNSCORE()
        kw = dict(max_epoch=500, alpha=1.0)
    kw.update(verbose=0, mode=mode)
    sj = scso.iterate(mj, pj, "l1", scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs
    _close(s.x.numpy(), sj.x, 1e-8)
    np.testing.assert_allclose(s.x.numpy(), [1.0, 1.0], atol=1e-3)


def _generic(ggn_w):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        300, 40, density=0.2, n_active=8, seed=3, dtype=np.float64,
        label01=True)
    names = dict(out_fn="sigmoid_out", grad_fy="logistic_ggn_residual",
                 hess_fy_diag="logistic_ggn_qdiag",
                 loss_fn="logistic_loss_01")
    if ggn_w:
        names["ggn_w"] = "logistic_ggn_w"
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.02,
                      dtype=np.float64,
                      **{k: getattr(jlosses, v) for k, v in names.items()})
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.02,
                    dtype=torch.float64, device="cpu",
                    **{k: getattr(losses, v) for k, v in names.items()})
    return pj, pt


@pytest.mark.parametrize("mode", ["fused", "timed"])
@pytest.mark.parametrize("ggn_w", [False, True])
def test_generic_ggn_cg_matches(ggn_w, mode):
    """No GLM spec: J applied by jvp/vjp of out_fn (diagonal Q from
    hess_fy_diag), or the ggn_w hook's weights (K1's plain version)."""
    pj, pt = _generic(ggn_w)
    kw = dict(max_epoch=30, x_tol=1e-10, f_tol=1e-12, verbose=0, alpha=1.0,
              mode=mode)
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla"), pj,
                      "l1", scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs
    if mode == "fused":
        assert s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    _close(s.x.numpy(), sj.x, 1e-10)


def _raises_named(path):
    """The NotImplementedError raises of a source file: (line, message)."""
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        func = exc.func if isinstance(exc, ast.Call) else exc
        if getattr(func, "id", None) != "NotImplementedError":
            continue
        text = ast.get_source_segment(open(path).read(), node)
        out.append((node.lineno, text))
    return out


def test_every_unported_raise_names_a11_or_a12():
    """What the port leaves out is serving and exporting a sharded
    problem (A12) and a captured solve with overlapped chunks over more
    than one rank (A11): the two NotImplementedErrors of utils/deploy.py
    name A12, the one of algorithms/iterate.py names A11."""
    pkg = os.path.join(ROOT, "scso_tpu_torch")
    found = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found += [(path, line, text)
                          for line, text in _raises_named(path)]
    where = {os.path.join("utils", "deploy.py"): "ROADMAP A12",
             os.path.join("algorithms", "iterate.py"): "ROADMAP A11"}
    bad = [(p, line) for p, line, text in found
           if not any(p.endswith(f) and tag in text
                      for f, tag in where.items())]
    assert not bad, bad
    deploy, iterate = where
    assert sorted(os.path.relpath(p, pkg) for p, _, _ in found) == sorted(
        [deploy, deploy, iterate])


def test_exports_of_the_jax_surface():
    """Every name of scso_tpu's ``__all__`` that the port has is
    exported, and the orbax checkpoints (no PyTorch counterpart) are not
    in the port's utils."""
    for name in ("with_col_sumsq", "ProblemLike", "iterate_continuation",
                 "ProximalMethod", "get_reg", "indbox_f", "inv_bb_step",
                 "armijo_linesearch"):
        assert name in scso.__all__ and name in st.__all__
        assert hasattr(st, name)
    import scso_tpu_torch.utils as tu

    for name in ("save_state", "load_state", "solution_to_state",
                 "solve_with_recovery", "mean_square_error", "slice_data",
                 "batch_iter"):
        assert name in tu.__all__
    assert not hasattr(tu, "save_state_orbax")
    assert st.ProxGGNSCORE in st.ProximalMethod
    _, pt = _box_qp()
    assert float(st.get_reg(pt, pt.x0, "indbox")) == float(
        pt.reg("indbox", pt.x0))
