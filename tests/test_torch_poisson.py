"""The Poisson GLM paths of the port, against scso_tpu.

Same numpy inputs, float64:
  * `make_sparse_poisson_data`: bit-identical arrays;
  * examples/07_poisson.py's problem (2000×192, density 0.08, 12 active,
    seed 7, λ = 0.05, every derivative hook and `POISSON_GLM`) solved by
    cached GGN-CG, uncached GGN-CG (epoch_cache=False), Newton-CG
    (K2's newton flavour through the cache) and L-BFGS, against
    `scso.iterate(kernels='xla')`, greedy off (AUTO at n = 192): the same
    epochs and CG iterations, objective histories to 1e-10 and x to 1e-9;
    with greedy on (explicitly), the cached GGN-CG fixed point, the final
    objective to 1e-8;
  * `iterate_mixed` on it (cached GGN-CG and Newton-CG; the coarse phase
    on A in bfloat16) against `scso.iterate_mixed(kernels='xla')`, with
    x* from each method's own prior solve so that the coarse phase stops
    at its 1e-3 gap: the same coarse and fine epochs and CG iterations,
    objectives to 1e-10.
"""

import functools

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.ops.cuda import counters

torch.set_num_threads(1)

LAM = 5e-2
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)
HOOKS = ("grad_fx", "hess_fx", "out_fn", "grad_fy", "hess_fy_diag",
         "loss_fn", "hvp_w", "ggn_w")
HOOK_FNS = ("poisson_grad", "poisson_hess", "exp_out",
            "poisson_ggn_residual", "poisson_ggn_qdiag", "poisson_loss",
            "poisson_hvp_w", "poisson_ggn_w")


@pytest.mark.parametrize("m,n,density,n_active,seed", [
    (2000, 192, 0.08, 12, 7), (80, 24, 0.2, 6, 3), (300, 50, 0.05, None, 1)])
def test_make_sparse_poisson_data_is_bit_identical(m, n, density, n_active,
                                                   seed):
    for dtype in (np.float32, np.float64):
        got = synthetic.make_sparse_poisson_data(
            m, n, density=density, n_active=n_active, seed=seed, dtype=dtype)
        want = jsynth.make_sparse_poisson_data(
            m, n, density=density, n_active=n_active, seed=seed, dtype=dtype)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _data():
    return jsynth.make_sparse_poisson_data(2000, 192, density=0.08,
                                           n_active=12, seed=7,
                                           dtype=np.float64)


def _problems(sol=None):
    """examples/07_poisson.py's problem in both packages (x* ``sol``,
    else the generator's x_true)."""
    A, y, x0, x_true = _data()
    sol = x_true if sol is None else sol
    pj = scso.Problem(A, y, x0, jlosses.poisson_f, LAM, sol=sol,
                      glm=jlosses.POISSON_GLM, dtype=np.float64,
                      **{h: getattr(jlosses, f)
                         for h, f in zip(HOOKS, HOOK_FNS)})
    pt = st.Problem(A, y, x0, losses.poisson_f, LAM, sol=sol,
                    glm=losses.POISSON_GLM, dtype=torch.float64,
                    device="cpu",
                    **{h: getattr(losses, f) for h, f in zip(HOOKS, HOOK_FNS)})
    return pj, pt


# name → (method class name, its fields)
PATHS = {
    "ggn_cached": ("ProxGGNSCORE", dict(solver="cg")),
    "ggn_uncached": ("ProxGGNSCORE", dict(solver="cg", epoch_cache=False)),
    "newton_cg": ("ProxNSCORE", dict(solver="cg")),
    "lbfgs": ("ProxLQNSCORE", dict(m=10)),
}


def _solve(name, mixed=False, sol=None, **extra):
    cls, fields = PATHS[name]
    fields = dict(fields, **extra)
    pj, pt = _problems(sol)
    run_j = scso.iterate_mixed if mixed else scso.iterate
    run_t = st.iterate_mixed if mixed else st.iterate
    sj = run_j(getattr(scso, cls)(kernels="xla", **fields), pj, "l1",
               scso.PHuberSmootherL1L2(1.0), **KW)
    counters.reset()
    s = run_t(getattr(st, cls)(**fields), pt, "l1",
              st.PHuberSmootherL1L2(1.0), **KW)
    assert set(counters.snapshot().values()) == {0}  # CPU: plain versions
    return s, sj


def _info(sol):
    return {k: v for k, v in (sol.cg_info or {}).items()
            if k != "coarse_time_s"}


@pytest.mark.parametrize("name", list(PATHS))
def test_poisson_solve_matches(name):
    s, sj = _solve(name)
    assert s.epochs == sj.epochs and _info(s) == _info(sj)
    assert (s.state.fcache is not None) == (name in ("ggn_cached",
                                                      "newton_cg"))
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-9)


def test_poisson_greedy_fixed_point_matches():
    s, sj = _solve("ggn_cached", greedy_alpha=True)
    obj, obj_j = float(s.obj[-1]), float(sj.obj[-1])
    assert abs(obj - obj_j) <= 1e-8 * abs(obj_j)


@functools.lru_cache(maxsize=None)
def _own_sol(name):
    cls, fields = PATHS[name]
    return st.iterate(getattr(st, cls)(**fields), _problems()[1], "l1",
                      st.PHuberSmootherL1L2(1.0), x_tol=1e-14, f_tol=1e-14,
                      max_epoch=300, verbose=0).x.numpy()


@pytest.mark.parametrize("name", ["ggn_cached", "newton_cg"])
def test_poisson_iterate_mixed_matches(name):
    s, sj = _solve(name, mixed=True, sol=_own_sol(name))
    assert s.cg_info["coarse_epochs"] == sj.cg_info["coarse_epochs"]
    assert 0 < s.cg_info["coarse_epochs"] < 40 and s.epochs > 0
    assert s.epochs == sj.epochs and _info(s) == _info(sj)
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-9)
