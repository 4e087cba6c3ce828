"""Interval-set ``C_set`` bounds in the port against scso_tpu.

``scso_tpu_torch.make_problem(..., C_set=..., device='cpu')``'s lb/ub
against ``scso_tpu.make_problem``'s on the same float64 data problem,
with exact equality, for the three forms the reference takes: one
interval (normalised to min/max, scalar bounds), a tuple/list of n
intervals (per-coordinate bounds, each normalised) and ``[lb, ub]``
(scalars or length-n arrays, a bare nested sequence included);
infinities are kept. ``is_interval_set`` against the reference's truth
table (tests/test_algs.py::TestIntervalCSet). One small dense
ProxNSCORE 'indbox' solve with per-coordinate intervals against
``scso.iterate``, x and the objective history to 1e-10 relative (the
same float64 arithmetic in another order).
"""

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu_torch.models import losses

torch.set_num_threads(1)

M, N = 24, 5
_rng = np.random.default_rng(3)
A = _rng.standard_normal((M, N))
Y = A @ np.array([1.5, -0.3, 2.5, 0.0, -4.0]) + 0.1 * _rng.standard_normal(M)
X0 = np.zeros(N)
INF = float("inf")

C_SETS = {
    "reversed_interval": st.Interval(2.0, -2.0),
    "five_intervals": tuple(st.Interval(-1.0, 1.0) for _ in range(N)),
    "interval_list": [st.Interval(-1.0, 1.0), st.Interval(3.0, -3.0),
                      st.Interval(0.0, 0.5), st.Interval(-2.0, -1.0),
                      st.Interval(4.0, 4.0)],
    "infinite_interval": st.Interval(-INF, 1.5),
    "infinite_per_coordinate": (st.Interval(-INF, INF),) * N,
    "scalars": [-1.0, 1.0],
    "scalar_tuple": (-0.5, 2.0),
    "infinite_scalars": [-INF, INF],
    "arrays": [np.linspace(-2.0, -1.0, N), np.linspace(1.0, 3.0, N)],
    "nested_lists": [[-1.0, -2.0, -3.0, -4.0, -5.0], [1.0, 2.0, 3.0, 4.0, 5.0]],
    "array_with_inf": [np.array([-INF, -1.0, -INF, 0.0, -2.0]),
                       np.array([1.0, INF, 2.0, INF, 3.0])],
}


def _jax_c_set(c_set):
    """The same C_set built from the reference's own Interval."""
    if isinstance(c_set, st.Interval):
        return scso.Interval(*c_set)
    if isinstance(c_set, (tuple, list)) and st.is_interval_set(c_set):
        return type(c_set)(scso.Interval(*i) for i in c_set)
    return c_set


def _problems(c_set, n=N):
    pj = scso.make_problem(A[:, :n], Y, X0[:n], jlosses.lsq_f, 1e-3,
                           C_set=_jax_c_set(c_set), dtype=np.float64)
    pt = st.make_problem(A[:, :n], Y, X0[:n], losses.lsq_f, 1e-3,
                         C_set=c_set, dtype=torch.float64, device="cpu")
    return pj, pt


def _exact(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(C_SETS))
def test_bounds_match_the_reference(name):
    pj, pt = _problems(C_SETS[name])
    _exact(pt.lb, pj.lb)
    _exact(pt.ub, pj.ub)


def test_two_intervals_on_two_columns():
    """The case the port used to read as [lb, ub] without an error."""
    pj, pt = _problems((st.Interval(-1, 1), st.Interval(-3, 3)), n=2)
    _exact(pt.lb, pj.lb)
    _exact(pt.ub, pj.ub)
    np.testing.assert_array_equal(pt.lb.numpy(), [-1.0, -3.0])
    np.testing.assert_array_equal(pt.ub.numpy(), [1.0, 3.0])


def test_no_c_set_has_no_bounds():
    pj, pt = _problems(None)
    assert pt.lb is None and pt.ub is None
    assert pj.lb is None and pj.ub is None


class _Duck:
    lower, upper = 1.0, -1.0


@pytest.mark.parametrize("obj, want", [
    (st.Interval(0, 1), True),
    ((st.Interval(0, 1),) * 3, True),
    ([st.Interval(0, 1), st.Interval(2, 3)], True),
    (_Duck(), True),
    ([-1.0, 1.0], False),
    ((), False),
    ([st.Interval(0, 1), 2.0], False),
    (None, False),
])
def test_is_interval_set_truth_table(obj, want):
    assert st.is_interval_set(obj) is want
    jobj = _jax_c_set(obj) if isinstance(obj, (tuple, list)) else obj
    assert scso.is_interval_set(jobj) is want


def test_duck_typed_interval_bounds():
    pj, pt = _problems(_Duck())
    _exact(pt.lb, pj.lb)
    _exact(pt.ub, pj.ub)


def test_indbox_solve_with_per_coordinate_intervals():
    c_set = C_SETS["interval_list"]
    pj, pt = _problems(c_set)
    sm_j = scso.PHuberSmootherIndBox(np.asarray(pj.lb), np.asarray(pj.ub),
                                     0.6)
    sm_t = st.PHuberSmootherIndBox(pt.lb.numpy(), pt.ub.numpy(), 0.6)
    kw = dict(alpha=0.8, max_epoch=40, verbose=0)
    sj = scso.iterate(scso.ProxNSCORE(), pj, "indbox", sm_j, **kw)
    s = st.iterate(st.ProxNSCORE(), pt, "indbox", sm_t, **kw)
    x, xj = s.x.numpy(), np.asarray(sj.x)
    assert np.all(x >= pt.lb.numpy()) and np.all(x <= pt.ub.numpy())
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-12)
    assert s.epochs == sj.epochs
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10)
