"""The port's precision-adaptive CG against scso_tpu.

A low-precision copy of A (`Problem.A_lp`, bfloat16, `with_lp_copy` or
AUTO) carries the CG matvecs of the epochs whose forcing tolerance is at
least ``cg_lp_tol``. On the CPU K1 with a bfloat16 A runs its plain
version (A upcast to w's dtype):
  * K1's plain version with A in bfloat16 against the JAX Pallas kernel
    in interpret mode at n >= 512, a multiple of 128 (below n·2 bytes =
    1024 the JAX package takes its XLA form and the kernel never runs),
    float32, the TPU kernel's hit counter checked; rtol 2e-5, atol
    3e-5·max(1, max|ref|) (sums in another order);
  * cached and uncached solves with the JAX package's own bfloat16 copy
    (carried over bit for bit by utils/convert) and cg_adaptive=True,
    cg_lp_tol=1e-2, float64, against scso_tpu.iterate with kernels='xla'
    (where bf16 @ f64 promotes to f64, as the port's upcast): equal
    epochs and CG iterations, objective histories to 1e-10 relative;
  * the port's mirrors of tests/test_pallas.py's TestPrecisionAdaptiveCG,
    TestPrecisionAdaptiveCGEndgame and TestAutoLP: a same-dtype copy
    solves bit for bit as no copy, a zero copy with an engaging
    threshold changes the solve, thresholds at or below the CG floor are
    refused with a warning, the bf16 copy reaches the same optimum, and
    `_auto_lp`'s gates decide as the JAX package's do.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.algorithms.iterate import Options as JOptions
from scso_tpu.algorithms.iterate import _auto_lp as j_auto_lp
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops.pallas import counters as jcounters
from scso_tpu.ops.pallas.matvec import fused_normal_matvec
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import iterate as it_mod
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda.matvec import normal_matvec, normal_matvec_torch
from scso_tpu_torch.utils.convert import problem_from_numpy

torch.set_num_threads(1)

FLOOR = 3e-4  # the float32 AUTO CG floor (steps._cg_tol)
SM = st.PHuberSmootherL1L2(1.0)


def _data(dtype, m=512, n=128, seed=0):
    return jsynth.make_sparse_logreg_data(
        m, n, density=0.3, n_active=8, seed=seed, dtype=dtype,
        label01=True)[:3]


def _port(dtype=np.float64, **kw):
    A, y, x0 = _data(dtype, **kw)
    return st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, device="cpu",
                      dtype=torch.float32 if dtype == np.float32
                      else torch.float64)


def _jax(dtype=np.float64, **kw):
    A, y, x0 = _data(dtype, **kw)
    return scso.Problem(A, y, x0, jlosses.logistic01_f, 1e-2,
                        grad_fx=jlosses.logistic01_grad,
                        glm=jlosses.LOGISTIC01_GLM, dtype=dtype)


def _solve(prob, max_epoch=120, **method_kw):
    return st.iterate(st.ProxGGNSCORE(solver="cg", **method_kw), prob, "l1",
                      SM, max_epoch=max_epoch, verbose=0)


def _poisoned(prob):
    return replace(prob, A_lp=torch.zeros_like(prob.A))


@pytest.mark.parametrize("m,n", [(384, 512), (1000, 640)])
def test_bf16_matvec_matches_the_pallas_kernel(m, n):
    rng = np.random.default_rng(m)
    A = jnp.asarray(rng.standard_normal((m, n)), jnp.float32).astype(
        jnp.bfloat16)
    w = rng.random(m).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    jcounters.reset()
    want = fused_normal_matvec(A, jnp.asarray(w), jnp.asarray(v))
    assert jcounters.KERNEL_HITS["fused_normal_matvec"] == 1
    assert want.dtype == jnp.float32
    A_lp = torch.tensor(np.asarray(A, np.float32)).to(torch.bfloat16)
    got = normal_matvec(A_lp, torch.tensor(w), torch.tensor(v))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=2e-5,
        atol=3e-5 * max(1.0, float(np.abs(want).max())))
    # the plain version is exactly the f32 product of the upcast copy
    assert torch.equal(got, normal_matvec_torch(
        A_lp.float(), torch.tensor(w), torch.tensor(v)))


@pytest.mark.parametrize("cache", [None, False], ids=["cached", "uncached"])
def test_lp_solve_matches_jax(cache):
    pj = scso.with_lp_copy(_jax())
    A, y, x0 = _data(np.float64)
    pt = problem_from_numpy(A, y, x0, 1e-2, device="cpu",
                            A_lp=np.asarray(pj.A_lp, np.float32))
    assert pt.A_lp.dtype == torch.bfloat16
    kw = dict(solver="cg", cg_adaptive=True, cg_lp_tol=1e-2,
              epoch_cache=cache)
    sj = scso.iterate(scso.ProxGGNSCORE(kernels="xla", **kw), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), max_epoch=120,
                      verbose=0)
    s = st.iterate(st.ProxGGNSCORE(**kw), pt, "l1", SM, max_epoch=120,
                   verbose=0)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), atol=1e-9)
    # the copy acted: without it the solve takes another path
    base = _solve(pt, cg_adaptive=True, epoch_cache=cache)
    assert not torch.equal(base.x, s.x)


def test_same_dtype_copy_and_closed_gates_solve_bit_for_bit():
    prob = _port()
    base = _solve(prob, cg_adaptive=True, epoch_cache=False)
    kw = dict(cg_adaptive=True, epoch_cache=False)
    same = _solve(st.with_lp_copy(prob, dtype=prob.A.dtype), cg_lp_tol=1e-2,
                  **kw)
    assert torch.equal(same.x, base.x)
    # a zero copy that the threshold never lets in, or no threshold
    assert torch.equal(_solve(_poisoned(prob), cg_lp_tol=1e30, **kw).x,
                       base.x)
    assert torch.equal(_solve(_poisoned(prob), **kw).x, base.x)


def test_same_dtype_copy_solves_bit_for_bit_cached():
    prob = _port(np.float32)
    base = _solve(prob)
    same = _solve(st.with_lp_copy(prob, dtype=prob.A.dtype), cg_lp_tol=FLOOR)
    assert torch.equal(same.x, base.x)


@pytest.mark.parametrize("dtype,kw", [
    (np.float64, dict(cg_adaptive=True, cg_lp_tol=1e-2)),
    (np.float32, dict(cg_lp_tol=FLOOR)),
    (np.float32, dict(cg_lp_tol=FLOOR, epoch_cache=False)),
], ids=["f64-adaptive", "f32-floor-cached", "f32-floor-uncached"])
def test_engaging_threshold_runs_on_the_copy(dtype, kw):
    """A zero copy with an engaging threshold must change the solve:
    the bulk epochs really run CG on the copy (from the first epoch, so
    three epochs of at most 20 CG iterations show it)."""
    prob = _port(dtype)
    base_kw = {k: v for k, v in kw.items() if k != "cg_lp_tol"}
    short = dict(max_epoch=3, cg_maxiter=20)
    base = _solve(prob, **short, **base_kw)
    assert not torch.equal(_solve(_poisoned(prob), **short, **kw).x, base.x)


@pytest.mark.parametrize("dtype,lp_tol", [(np.float64, 1e-12),
                                          (np.float32, FLOOR)])
def test_thresholds_at_the_floor_are_refused(monkeypatch, dtype, lp_tol):
    """Below the CG floor, or equal to it under cg_adaptive (the forcing
    never passes below the floor), the copy would stay engaged through
    the endgame: refused with a warning, the solve runs on A."""
    monkeypatch.setattr(steps, "_warned", set())
    prob = st.with_lp_copy(_port(dtype))
    kw = dict(cg_adaptive=True, epoch_cache=False)
    base = _solve(prob, **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s = _solve(prob, cg_lp_tol=lp_tol, **kw)
    assert torch.equal(s.x, base.x)
    assert any("cg_lp_tol" in str(w.message) for w in rec)
    assert not steps._lp_engaged(
        st.ProxGGNSCORE(cg_lp_tol=lp_tol, cg_adaptive=True), prob, prob.A,
        prob.dtype)


@pytest.mark.parametrize("dtype,kw,rtol,atol", [
    (np.float64, dict(cg_adaptive=True, cg_lp_tol=1e-2), 1e-7, 1e-5),
    (np.float32, dict(cg_lp_tol=FLOOR), 1e-5, 1e-3),
], ids=["f64-adaptive", "f32-floor"])
def test_bf16_copy_reaches_the_same_optimum(dtype, kw, rtol, atol):
    prob = st.with_lp_copy(_port(dtype))
    assert prob.A_lp.dtype == torch.bfloat16
    assert prob.A_lp.shape == prob.A.shape
    base_kw = {k: v for k, v in kw.items() if k != "cg_lp_tol"}
    base = _solve(prob, **base_kw)
    lp = _solve(prob, **kw)
    np.testing.assert_allclose(float(lp.obj[-1]), float(base.obj[-1]),
                               rtol=rtol)
    np.testing.assert_allclose(lp.x.numpy(), base.x.numpy(), atol=atol)


def test_with_lp_copy_requires_a_data_problem():
    """with_lp_copy refuses a problem without data; on a data problem
    with a copy, iterate_mixed runs and matches scso.iterate_mixed."""
    bare = st.CompositeProblem(
        x0=torch.zeros(3), lam=torch.tensor(0.1), A=None, y=None,
        x_star=torch.zeros(3), f=None, dtype=torch.float64,
        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="data problem"):
        st.with_lp_copy(bare)
    kw = dict(max_epoch=20, verbose=0)
    s = st.iterate_mixed(st.ProxGGNSCORE(solver="cg"),
                         st.with_lp_copy(_port()), "l1", SM, **kw)
    sj = scso.iterate_mixed(scso.ProxGGNSCORE(solver="cg", kernels="xla"),
                            scso.with_lp_copy(_jax()), "l1",
                            scso.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs
    assert s.cg_info["coarse_epochs"] == sj.cg_info["coarse_epochs"]
    assert (s.cg_info["total_cg_iters"]
            == sj.cg_info["total_cg_iters"])
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), atol=1e-9)


def test_converter_refuses_a_copy_bf16_cannot_hold():
    A, y, x0 = _data(np.float64)
    with pytest.raises(ValueError, match="bfloat16"):
        problem_from_numpy(A, y, x0, 1e-2, device="cpu",
                           A_lp=A.astype(np.float32))


# (ProxGGNSCORE fields, float32 data?) — each gate of _auto_lp, in the
# JAX package's order, with auto_lp=True
GATES = [
    (dict(), True),
    (dict(cg_adaptive=True), True),
    (dict(cg_lp_tol=1e-2), True),
    (dict(curvature_rows=64), True),
    (dict(), False),
    (dict(auto_lp=False), True),
]


@pytest.mark.parametrize("fields,f32", GATES,
                         ids=["open", "cg_adaptive", "cg_lp_tol",
                              "curvature_rows", "float64", "off"])
def test_auto_lp_gates_decide_as_jax(fields, f32):
    dtype = np.float32 if f32 else np.float64
    kw = dict(dict(solver="cg", auto_lp=True), **fields)
    m_t, p_t = it_mod._auto_lp(st.ProxGGNSCORE(**kw), _port(dtype, seed=1))
    m_j, p_j = j_auto_lp(scso.ProxGGNSCORE(**kw), _jax(dtype, seed=1),
                         JOptions())
    attached = getattr(p_j, "A_lp", None) is not None
    assert (p_t.A_lp is not None) == attached
    assert m_t.cg_lp_tol == m_j.cg_lp_tol
    if attached:
        assert p_t.A_lp.dtype == torch.bfloat16
        assert m_t.cg_lp_tol == pytest.approx(FLOOR)
        # the same bits as the JAX package's copy
        assert np.array_equal(p_t.A_lp.float().numpy(),
                              np.asarray(p_j.A_lp, np.float32))


def test_auto_lp_stays_off_for_data_off_the_card(monkeypatch):
    """auto_lp=None engages only for A on a CUDA device: a CPU problem
    never gets a copy, whatever its size."""
    monkeypatch.setattr(it_mod, "_AUTO_LP_MIN_BYTES", 0)
    method = st.ProxGGNSCORE(solver="cg")
    m2, p2 = it_mod._auto_lp(method, _port(np.float32))
    assert p2.A_lp is None and m2.cg_lp_tol == 0.0
    # a problem that has a copy keeps it, and ProxLQNSCORE has no AUTO
    withcopy = st.with_lp_copy(_port(np.float32))
    assert it_mod._auto_lp(dataclasses.replace(method, auto_lp=True),
                           withcopy)[1].A_lp is withcopy.A_lp
    lq = st.ProxLQNSCORE()
    assert it_mod._auto_lp(lq, _port(np.float32))[0] is lq


def test_forced_auto_solve_reaches_the_plain_optimum():
    prob = _port(np.float32, seed=1)
    base = _solve(prob)
    s = _solve(prob, auto_lp=True)
    np.testing.assert_allclose(float(s.obj[-1]), float(base.obj[-1]),
                               rtol=1e-5)
    np.testing.assert_allclose(s.x.numpy(), base.x.numpy(), atol=1e-3)
