"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against the TPU kernel run in Pallas
interpret mode (as tests/test_pallas.py runs it), in float64 on the same
numpy inputs, at small block-boundary shapes with ragged m (so the
padded-label and masked-loss rules of the TPU kernel are exercised).
Tolerances: 1e-10 relative / 1e-12 absolute for the data kernels (sums
in another order), 1e-13 absolute for the elementwise update. The CUDA
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scso_tpu.algorithms.steps import _glm_kernel_fns
from scso_tpu.models import losses as jlosses
from scso_tpu.ops.pallas.glm_prep import _fused_glm_prep_pair
from scso_tpu.ops.pallas.matvec import _fused_normal_matvec
from scso_tpu.ops.pallas.score_update import _fused_update
from scso_tpu.ops.smoothers import phuber_grad, phuber_hess
from scso_tpu_torch.models.losses import LOGISTIC01_GLM
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import (
    PairPrep, glm_prep_pair, glm_prep_pair_torch)
from scso_tpu_torch.ops.cuda.matvec import normal_matvec, normal_matvec_torch
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)

torch.set_num_threads(1)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _data(m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.1
    y = (rng.random(m) > 0.5).astype(np.float64)
    return rng, A, y


class TestNormalMatvec:
    @pytest.mark.parametrize("m,n", [(37, 128), (660, 256), (947, 384)])
    def test_plain_matches_pallas(self, m, n):
        rng, A, _ = _data(m, n, m)
        w, v = rng.random(m), rng.standard_normal(n)
        want = _fused_normal_matvec(jnp.asarray(A), jnp.asarray(w),
                                    jnp.asarray(v), interpret=True)
        _close(normal_matvec_torch(_t(A), _t(w), _t(v)), want)

    def test_wrapper_runs_plain_on_cpu_without_counting(self):
        rng, A, _ = _data(50, 30, 0)
        w, v = _t(rng.random(50)), _t(rng.standard_normal(30))
        counters.reset()
        got = normal_matvec(_t(A), w, v)
        assert torch.equal(got, normal_matvec_torch(_t(A), w, v))
        assert counters.snapshot()["normal_matvec"] == 0


class TestGLMPrepPair:
    @pytest.mark.parametrize("m,n", [(37, 128), (500, 256), (1100, 384)])
    def test_plain_matches_pallas(self, m, n):
        rng, A, y = _data(m, n, m + 1)
        xt, xd = rng.standard_normal(n) * 0.3, rng.standard_normal(n) * 0.3
        rw_fn, w_fn, loss_fn = _glm_kernel_fns(jlosses.LOGISTIC01_GLM, m)
        want = _fused_glm_prep_pair(
            jnp.asarray(A), jnp.asarray(y), jnp.asarray(xt), jnp.asarray(xd),
            rw_fn, w_fn, loss_fn, interpret=True)
        got = glm_prep_pair_torch(_t(A), _t(y), _t(xt), _t(xd),
                                  LOGISTIC01_GLM)
        assert got._fields == PairPrep._fields
        for f, g, w_ in zip(got._fields, got, want):
            assert tuple(g.shape) == tuple(w_.shape), f
            _close(g, w_)

    def test_saturated_predictor_stays_finite(self):
        # |z| ≫ 20: the softplus identity shortcut of torch.nn.functional
        # would differ from jax.nn.softplus here; logaddexp does not
        rng, A, y = _data(64, 128, 9)
        x = np.full(128, 40.0) * np.sign(rng.standard_normal(128))
        rw_fn, w_fn, loss_fn = _glm_kernel_fns(jlosses.LOGISTIC01_GLM, 64)
        want = _fused_glm_prep_pair(
            jnp.asarray(A), jnp.asarray(y), jnp.asarray(x), jnp.asarray(-x),
            rw_fn, w_fn, loss_fn, interpret=True)
        got = glm_prep_pair_torch(_t(A), _t(y), _t(x), _t(-x),
                                  LOGISTIC01_GLM)
        for g, w_ in zip(got, want):
            assert bool(torch.isfinite(g).all())
            _close(g, w_)

    def test_wrapper_runs_plain_on_cpu(self):
        rng, A, y = _data(40, 20, 2)
        x = _t(rng.standard_normal(20))
        got = glm_prep_pair(_t(A), _t(y), x, x, LOGISTIC01_GLM)
        want = glm_prep_pair_torch(_t(A), _t(y), x, x, LOGISTIC01_GLM)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


class TestScoreUpdate:
    @pytest.mark.parametrize("n", [1000, 8320])
    @pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
    def test_plain_matches_pallas(self, reg, n):
        rng = np.random.default_rng(n)
        x, d = rng.standard_normal(n), rng.standard_normal(n)
        mu, lam, ss, Mg = 0.8, 0.05, 0.5, 3.0
        lgr = lam * np.asarray(phuber_grad(jnp.asarray(x), mu))
        lgr[rng.random(n) < 0.1] = 0.0   # the lgr = 0 guard
        hr = np.asarray(phuber_hess(jnp.asarray(x), mu))
        lb, ub = np.full(n, -0.4), np.full(n, 0.4)
        xj, pri_j, eta_j, safe_j = _fused_update(
            *(jnp.asarray(a) for a in (x, d, lgr, hr, lb, ub)),
            lam, ss, Mg, reg, True)
        got = score_update_torch(
            _t(x), _t(d), _t(lgr), _t(hr), _t(lam), _t(ss), Mg,
            "l1" if reg == "none" else reg, use_prox=reg != "none",
            lb=_t(lb), ub=_t(ub))
        _close(got.x_new, xj, rtol=0, atol=1e-13)
        for g, w_ in ((got.pri, pri_j), (got.safe, safe_j),
                      (got.eta, eta_j)):
            assert float(g) == pytest.approx(float(w_), rel=1e-12)

    def test_zero_gradient_at_zero_curvature_is_not_nan(self):
        n = 16
        lgr = torch.zeros(n, dtype=torch.float64)
        lgr[:8] = 0.1
        hr = torch.ones(n, dtype=torch.float64)
        hr[8:] = 0.0     # 0/0 in the unguarded branch
        out = score_update(torch.ones(n, dtype=torch.float64),
                           torch.ones(n, dtype=torch.float64), lgr, hr,
                           0.1, 1.0, 2.0, "none", use_prox=False)
        assert bool(torch.isfinite(out.eta))
        assert float(out.eta) == pytest.approx((8 * 0.01) ** 0.5, rel=1e-14)

    def test_rejects_unknown_reg_and_device(self):
        x = torch.ones(4, dtype=torch.float64)
        with pytest.raises(ValueError):
            score_update(x, x, x, x, 0.1, 1.0, 1.0, "gl")
        meta = torch.empty(4, device="meta")
        with pytest.raises(ValueError, match="meta"):
            score_update(meta, meta, meta, meta, 0.1, 1.0, 1.0, "l1")


def test_counters_reset_and_snapshot():
    counters.bump("score_update")
    assert counters.snapshot()["score_update"] >= 1
    counters.reset()
    assert set(counters.snapshot().values()) == {0}
