"""The port's examples (examples/torch/NN_*.py) on the CPU: each
``main(device='cpu')`` with tests/test_examples.py's assertions, and,
where both run in float64, the final objective within 1e-8 relative of
the JAX package's example (examples/NN_*.py) on the same data. The three
examples that return an L-BFGS solve which amplifies rounding (01, 03,
07) are held record by record instead, to the JAX example and to the
JAX package's own spread under last-ulp changes of the same problem
(``test_lbfgs_records_stay_within_the_references_own_spread``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-8  # relative, on the final objective of the float64 examples


def _load(path: Path, prefix: str):
    """The example at ``path`` as a module of its own name (the two
    packages' examples share file names)."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    mod = _load(ROOT / "examples" / "torch" / f"{name}.py", "torch_example")
    return mod.main(device="cpu")


def _jax(name):
    return _load(ROOT / "examples" / f"{name}.py", "jax_example").main()


def _final(sol) -> float:
    return float(np.asarray(sol.obj)[-1])


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _descends(sol):
    assert _final(sol) <= float(np.asarray(sol.obj)[0])


def _rosenbrock(sol):
    np.testing.assert_allclose(_np(sol.x), [1.0, 1.0], atol=1e-3)


def _group_lasso(sol):
    assert float(sol.rel[-1]) < 0.5


def _box_qp(sol):
    assert np.all(np.abs(_np(sol.x)) <= 1 + 1e-9)


def _scaleout(res):
    assert res.batch_size == 8
    assert np.all(np.isfinite(_np(res.obj)))


def _poisson(sol):
    _descends(sol)
    # l1 at this lambda must actually sparsify (192 features, ~30 kept)
    assert int((np.abs(_np(sol.x)) > 1e-4).sum()) < 60


def _finite(sol):
    assert np.all(np.isfinite(_np(sol.x)))


def _finite_descends(sol):
    _finite(sol)
    _descends(sol)


#: example → (tests/test_examples.py's check, how its result is held to
#: the JAX example's: "f64" both run in float64, final objective within
#: RTOL; "f32" float32, not compared; "records" float64, an L-BFGS solve
#: whose final objective moves with last-ulp changes of the problem in
#: the JAX package too (ROADMAP Queue C, C12, not a fault): its records
#: are held by test_lbfgs_records_stay_within_the_references_own_spread)
CASES = {
    "01_rosenbrock_l1": (_rosenbrock, "records"),
    "02_sparse_logistic": (_descends, "f64"),
    "03_group_lasso": (_group_lasso, "records"),
    "04_box_qp": (_box_qp, "f64"),
    "05_scaleout": (_scaleout, "f32"),
    "06_checkpoint_profile": (_descends, "f64"),
    "07_poisson": (_poisson, "records"),
    "08_multinomial": (_descends, "f64"),
    "09_federated": (_finite, "f64"),
    "10_continuation": (_finite_descends, "f64"),
    "11_outofcore_bigrows": (_finite_descends, "f32"),
}


def test_every_jax_example_has_a_port():
    jax_names = sorted(p.stem for p in (ROOT / "examples").glob("[0-9]*.py"))
    port_names = sorted(p.stem for p in
                        (ROOT / "examples" / "torch").glob("[0-9]*.py"))
    assert jax_names == port_names == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example(name):
    check, held = CASES[name]
    got = _port(name)
    check(got)
    if held != "f64":
        return
    ref = _jax(name)
    check(ref)
    assert got.epochs == ref.epochs
    np.testing.assert_allclose(_final(got), _final(ref), rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# the L-BFGS examples, record by record (C12)
# ---------------------------------------------------------------------------

#: before the first record where the JAX package's own spread passes
#: SPREAD_ONSET, each record of the port within EARLY_RTOL (relative) of
#: the JAX example's; from it on, within SPREAD_FACTOR times that spread
SPREAD_ONSET, EARLY_RTOL, SPREAD_FACTOR = 1e-12, 1e-11, 10.0
#: 07's epochs: past its spread's onset (~record 68) and past the first
#: record where the two packages part by 1e-8 (~105); the example's 300
#: add nothing the comparison needs
POISSON_EPOCHS = 150


def _rosenbrock_xx(x):
    """losses.rosenbrock with x₁² as x₁·x₁: the same function, rounded
    otherwise at every evaluation of f and ∇f."""
    return 100.0 * (x[1] - x[0] * x[0]) ** 2 + (1.0 - x[0]) ** 2


def _kw(pkg):
    import scso_tpu as scso

    return (dict(dtype=np.float64) if pkg is scso
            else dict(dtype=torch.float64, device="cpu"))


def _permuted(A, y, variant):
    """A's and y's rows in a permutation of seed ``variant`` (0: as
    they are): the same problem, its sums over the rows in another
    order."""
    if not variant:
        return A, y
    perm = np.random.default_rng(variant).permutation(A.shape[0])
    return A[perm], y[perm]


def _lbfgs_01(pkg, losses, synthetic, variant):
    """examples/01_rosenbrock_l1.py's solve. Variants 1–4 move x0 by one
    ulp (each sign on each coordinate); 5 is x₁·x₁ in f."""
    x0 = np.array([0.2, -0.5])
    f = losses.rosenbrock
    if 1 <= variant <= 4:
        x0 = np.nextafter(x0, [[np.inf, np.inf], [-np.inf, -np.inf],
                               [np.inf, -np.inf],
                               [-np.inf, np.inf]][variant - 1])
    elif variant == 5:
        f = _rosenbrock_xx
    p = pkg.Problem(x0, f, 1e-8, **_kw(pkg))
    return pkg.iterate(pkg.ProxLQNSCORE(use_prox=True, ss_type=1, m=10), p,
                       "l1", pkg.PHuberSmootherL1L2(1.0), max_epoch=2000,
                       x_tol=1e-10, f_tol=1e-10, verbose=0)


def _lbfgs_03(pkg, losses, synthetic, variant):
    """examples/03_group_lasso.py's solve; variants permute the rows."""
    A, y, x_true, x0, groups = synthetic.make_group_lasso_problem(
        50, 100, 10, p_active=0.1, noise_std=0.1, seed=1234, corr=0.5,
        dtype=np.float64)
    A, y = _permuted(A, y, variant)
    p = pkg.Problem(
        A, y, x0, losses.lsq_f, [1e-8, 1.0], grad_fx=losses.lsq_grad,
        hess_fx=losses.lsq_hess, out_fn=losses.linear_out,
        loss_fn=losses.lsq_loss, grad_fy=losses.lsq_ggn_residual,
        hess_fy_diag=losses.lsq_ggn_qdiag, sol=x_true, groups=groups,
        **_kw(pkg))
    return pkg.iterate(pkg.ProxLQNSCORE(use_prox=True, ss_type=1, m=10), p,
                       "gl", pkg.PHuberSmootherGL(1e-2, p), alpha=1.0,
                       max_epoch=100, verbose=0)


def _lbfgs_07(pkg, losses, synthetic, variant):
    """examples/07_poisson.py's returned (L-BFGS) solve, for
    POISSON_EPOCHS; variants permute the rows."""
    A, y, x0, x_true = synthetic.make_sparse_poisson_data(
        2000, 192, density=0.08, n_active=12, seed=7, dtype=np.float64)
    A, y = _permuted(A, y, variant)
    p = pkg.Problem(
        A, y, x0, losses.poisson_f, 5e-2, grad_fx=losses.poisson_grad,
        hess_fx=losses.poisson_hess, out_fn=losses.exp_out,
        grad_fy=losses.poisson_ggn_residual,
        hess_fy_diag=losses.poisson_ggn_qdiag, loss_fn=losses.poisson_loss,
        hvp_w=losses.poisson_hvp_w, ggn_w=losses.poisson_ggn_w,
        glm=losses.POISSON_GLM, sol=x_true, **_kw(pkg))
    return pkg.iterate(pkg.ProxLQNSCORE(m=10), p, "l1",
                       pkg.PHuberSmootherL1L2(1.0),
                       max_epoch=POISSON_EPOCHS, verbose=0)


#: example → (its solve, the JAX package's last-ulp variants of it)
LBFGS = {
    "01_rosenbrock_l1": (_lbfgs_01, (1, 2, 3, 4, 5)),
    "03_group_lasso": (_lbfgs_03, (1, 2, 3)),
    "07_poisson": (_lbfgs_07, (1, 2, 3)),
}


def _objs(sol) -> np.ndarray:
    return _np(sol.obj).astype(np.float64)


@pytest.mark.parametrize("name", sorted(LBFGS))
def test_lbfgs_records_stay_within_the_references_own_spread(name):
    """The example's L-BFGS solve in the port against the JAX example's,
    record by record. The JAX package's own spread at a record is the
    most that any of its last-ulp variants of the same problem moves
    that record (relative): rows permuted (03, 07; every sum over the
    rows in another order), and for 01, which has no rows, x0 moved by
    one ulp, and x₁² written x₁·x₁ in f. (A one-ulp move of x0 perturbs
    once: from record 29 on, those four runs are the unmoved run's bits;
    the port, whose sums and products round otherwise at every
    evaluation, is held to a re-rounded f's spread there.) Until the
    spread reaches SPREAD_ONSET each record agrees to EARLY_RTOL; from
    then on the port's deviation stays within SPREAD_FACTOR times the
    spread at the same record."""
    import scso_tpu as scso
    from scso_tpu.models import losses as jl
    from scso_tpu.models import synthetic as js
    from scso_tpu_torch.models import losses as tl
    from scso_tpu_torch.models import synthetic as ts

    solve, variants = LBFGS[name]
    ref = _objs(solve(scso, jl, js, 0))
    port = _objs(solve(_torch_pkg(), tl, ts, 0))
    others = [_objs(solve(scso, jl, js, v)) for v in variants]
    n = len(ref)
    assert len(port) == n and all(len(o) == n for o in others)
    rel = lambda o: np.abs(o - ref) / np.abs(ref)
    dev = rel(port)
    spread = np.max([rel(o) for o in others], axis=0)
    onset = int(np.argmax(spread > SPREAD_ONSET)) if np.any(
        spread > SPREAD_ONSET) else n
    assert onset > 0
    early = np.flatnonzero(dev[:onset] > EARLY_RTOL)
    assert not early.size, (onset, early, dev[early])
    late = onset + np.flatnonzero(dev[onset:] > SPREAD_FACTOR
                                  * spread[onset:])
    assert not late.size, (onset, late, dev[late], spread[late])


def _torch_pkg():
    import scso_tpu_torch

    return scso_tpu_torch
