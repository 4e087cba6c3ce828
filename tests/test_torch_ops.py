"""Parity of the port's numerics core (scso_tpu_torch.ops) with scso_tpu.

The same numpy inputs, drawn from a seed, go through the JAX function
and its PyTorch counterpart in float64. Tolerance: 1e-14 relative for
the elementwise operators (same formulas, last-ulp differences only)
and 1e-12 for CG (a different summation order inside the dot products).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scso_tpu.ops import linalg as jlinalg
from scso_tpu.ops import prox as jprox
from scso_tpu.ops import regularizers as jreg
from scso_tpu.ops import smoothers as jsm
from scso_tpu_torch.ops import linalg, prox, regularizers, smoothers

torch.set_num_threads(1)

RTOL = 1e-14


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=RTOL, atol=1e-15):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


class TestSmoothers:
    @pytest.mark.parametrize("mu", [0.3, 1.0, 2.5])
    def test_phuber_val_grad_hess(self, mu):
        x = np.random.default_rng(0).standard_normal(257) * 3.0
        x[:5] = 0.0
        for jf, tf in ((jsm.phuber_val, smoothers.phuber_val),
                       (jsm.phuber_grad, smoothers.phuber_grad),
                       (jsm.phuber_hess, smoothers.phuber_hess)):
            _close(tf(_t(x), mu), jf(jnp.asarray(x), mu))

    def test_l1l2_smoother_methods(self):
        x = np.random.default_rng(1).standard_normal(64)
        js, ts = jsm.PHuberSmootherL1L2(0.7), smoothers.PHuberSmootherL1L2(0.7)
        assert (ts.Mh, ts.nu) == (js.Mh, js.nu)
        for name in ("val", "grad", "hess_diag"):
            _close(getattr(ts, name)(_t(x)),
                   getattr(js, name)(jnp.asarray(x)))
        assert ts.Mg(10112) == pytest.approx(float(js.Mg(10112)), rel=RTOL)

    @pytest.mark.parametrize("Mh,nu,mu,n", [
        (2.0, 2.6, 1.0, 10000), (2.0, 2.6, 0.1, 7), (1.0, 3.0, 0.5, 100),
        (2.0, 3.5, 0.8, 50), (0.0, 2.0, 1.0, 3)])
    def test_get_Mg(self, Mh, nu, mu, n):
        assert smoothers.get_Mg(Mh, nu, mu, n) == pytest.approx(
            float(jsm.get_Mg(Mh, nu, mu, n)), rel=RTOL)

    @pytest.mark.parametrize("args", [(-1.0, 2.6, 1.0, 5), (1.0, 2.6, 0.0, 5),
                                      (1.0, 0.0, 1.0, 5)])
    def test_get_Mg_rejects_bad_constants(self, args):
        with pytest.raises(ValueError):
            smoothers.get_Mg(*args)


class TestProx:
    @pytest.mark.parametrize("reg", ["l1", "l2", "indbox"])
    def test_prox_step(self, reg):
        rng = np.random.default_rng(2)
        n = 300
        x = rng.standard_normal(n)
        x[::17] = 0.0   # the l2 x² = 0 branch
        h = rng.random(n) + 0.05
        lb, ub = -0.4 * np.ones(n), 0.6 * np.ones(n)
        got = prox.prox_step(reg, _t(x), _t(h), _t(0.05), _t(0.7),
                             lb=_t(lb), ub=_t(ub))
        want = jprox.prox_step(reg, jnp.asarray(x), jnp.asarray(h), 0.05,
                               0.7, lb=jnp.asarray(lb), ub=jnp.asarray(ub))
        _close(got, want)

    def test_gl_and_unknown_raise(self):
        x = _t(np.ones(4))
        with pytest.raises(NotImplementedError, match="A8"):
            prox.prox_step("gl", x, x, 0.1, 1.0)
        with pytest.raises(ValueError):
            prox.prox_step("l0", x, x, 0.1, 1.0)
        with pytest.raises(ValueError):
            prox.prox_step("indbox", x, x, 0.1, 1.0)


class TestRegularizers:
    @pytest.mark.parametrize("reg", ["l1", "l2"])
    def test_reg_value(self, reg):
        x = np.random.default_rng(3).standard_normal(123)
        got = regularizers.reg_value(reg, _t(x), lam=_t(0.03))
        want = jreg.reg_value(reg, jnp.asarray(x), lam=0.03)
        assert float(got) == pytest.approx(float(want), rel=RTOL)

    @pytest.mark.parametrize("scale", [0.5, 2.0])
    def test_indbox(self, scale):
        x = np.random.default_rng(4).random(20) * scale
        lb, ub = np.zeros(20), np.ones(20)
        got = regularizers.reg_value("indbox", _t(x), lam=_t(1.0),
                                     lb=_t(lb), ub=_t(ub))
        want = jreg.reg_value("indbox", jnp.asarray(x), lam=1.0,
                              lb=jnp.asarray(lb), ub=jnp.asarray(ub))
        assert float(got) == float(want)

    def test_gl_raises(self):
        with pytest.raises(NotImplementedError, match="A8"):
            regularizers.reg_value("gl", _t(np.ones(3)), lam=_t(0.1))


class TestCG:
    def _system(self, n=40, seed=5):
        rng = np.random.default_rng(seed)
        B = rng.standard_normal((n, n))
        M = B @ B.T + n * np.eye(n)
        b = rng.standard_normal(n)
        x0 = rng.standard_normal(n) * 0.1
        return M, b, x0

    @pytest.mark.parametrize("precond", [False, True])
    @pytest.mark.parametrize("warm", [False, True])
    def test_matches_jax_cg(self, precond, warm):
        M, b, x0 = self._system()
        dg = np.diag(M).copy()
        Mt, Mj = _t(M), jnp.asarray(M)
        kw = dict(tol=1e-10, maxiter=200)
        got = linalg.cg_solve(lambda v: Mt @ v, _t(b),
                              _t(x0) if warm else None,
                              M_inv=(lambda v: v / _t(dg)) if precond
                              else None, **kw)
        want = jlinalg.cg_solve(lambda v: Mj @ v, jnp.asarray(b),
                                jnp.asarray(x0) if warm else None,
                                M_inv=(lambda v: v / jnp.asarray(dg))
                                if precond else None, **kw)
        assert got.iters == int(want.iters)
        _close(got.x, want.x, rtol=1e-12, atol=1e-13)
        _close(got.x, np.linalg.solve(M, b), rtol=1e-8, atol=1e-9)

    def test_maxiter_caps_and_tensor_tol(self):
        M, b, _ = self._system(seed=6)
        Mt = _t(M)
        res = linalg.cg_solve(lambda v: Mt @ v, _t(b), tol=_t(1e-14),
                              maxiter=3)
        assert res.iters == 3
        assert float(res.res_norm_sq) > 0
