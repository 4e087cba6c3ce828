"""The port's L-BFGS path (ProxLQNSCORE) against scso_tpu.

Same numpy inputs, float64, through each JAX function and its port:
  * the two-loop recursion (the plain version of K4) against
    `scso_tpu.ops.lbfgs_core.two_loop` and the Pallas kernel
    `fused_two_loop` in interpret mode, at the JAX tests' shapes (a
    wrapped buffer, a large ragged n, an empty memory, partial
    memories), rtol 1e-12 and atol 1e-12·max|ref|; the memories that
    `update_memory` builds from the same pairs, to 1e-13 (H0 is a ratio
    of two dot products summed in another order);
  * `update_memory` with a rejected pair (the memory is unchanged);
  * `inv_bb_step` (also at δ·γ = 0) and the Armijo line search, 1e-12;
  * one `lbfgs_step` from a memory that the JAX package filled, 1e-12;
  * the reference's L-BFGS oracle (5×2 logistic, l1 and l2, rel and
    objrel ≤ 1e-6) through the autograd fallback of `grad_f`;
  * sparse-logistic solves, 512×256 and a feature-padded 384×200, with
    and without ``alpha``, stats_every 1 and 4, ``iterate(None, ...)``
    for the default method: the same epochs and objective histories to
    1e-10 relative.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.algorithms import steps as jsteps
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops import lbfgs_core as jcore
from scso_tpu.ops import linalg as jlinalg
from scso_tpu.ops.pallas.two_loop import fused_two_loop
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops import lbfgs_core, linalg
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.two_loop import two_loop
from scso_tpu_torch.utils.convert import (
    lbfgs_memory_from_numpy, problem_from_numpy)

torch.set_num_threads(1)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=1e-12, atol=1e-12):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


def _pairs(n, pushes, seed, quadratic):
    """Curvature pairs as the JAX tests make them: perturbed scalings of
    δ, or SPD-quadratic pairs (γ = B·δ)."""
    rng = np.random.default_rng(seed)
    bdiag = rng.random(n) * 4 + 0.5
    out = []
    for i in range(pushes):
        delta = rng.standard_normal(n) * 0.1
        if quadratic:
            gamma = bdiag * delta
        else:
            gamma = delta * (1.0 + 0.1 * i) + 0.01 * rng.standard_normal(n)
        out.append((delta, gamma))
    return out, rng.standard_normal(n)


def _memories(n, m, pairs):
    """The same pairs pushed through both packages' update_memory."""
    mj = jcore.init_memory(n, m, np.float64)
    mt = lbfgs_core.init_memory(n, m, torch.float64)
    for delta, gamma in pairs:
        mj = jcore.update_memory(mj, jnp.asarray(delta), jnp.asarray(gamma))
        mt = lbfgs_core.update_memory(mt, _t(delta), _t(gamma))
    return mj, mt


# (n, m, pushes, quadratic): tests/test_pallas.py's wrapped buffer, large
# ragged n and empty memory, then its partial-memory shapes
TWO_LOOP_CASES = [(300, 5, 7, False), (16500, 4, 3, False),
                  (64, 10, 0, False), (777, 9, 18, True),
                  (2784, 10, 20, True), (361, 9, 9, True)]


@pytest.mark.parametrize("n,m,pushes,quadratic", TWO_LOOP_CASES)
def test_two_loop_matches_jax_and_pallas(n, m, pushes, quadratic):
    pairs, g = _pairs(n, pushes, n + pushes, quadratic)
    mj, mt = _memories(n, m, pairs)
    for got, want in zip(mt, mj):  # H0's dot products: summation order
        _close(got, want, rtol=1e-13, atol=1e-15)
    # the memory the JAX package filled, carried over
    mc = lbfgs_memory_from_numpy(*(np.asarray(f) for f in mj),
                                 device="cpu")
    for got, want in zip(mc, mj):
        _close(got, want, rtol=0, atol=0)
    assert mt.pos.dtype == mt.count.dtype == mc.pos.dtype == torch.int32
    counters.reset()
    got = two_loop(mt, _t(g))  # the wrapper: plain on CPU tensors
    assert counters.snapshot()["two_loop"] == 0
    _close(got, jcore.two_loop(mj, jnp.asarray(g)))
    _close(got, fused_two_loop(mj, jnp.asarray(g)))
    if pushes == 0:
        _close(got, -g, rtol=0, atol=0)


def test_update_memory_rejects_a_flat_pair():
    pairs, _ = _pairs(50, 3, 1, False)
    mj, mt = _memories(50, 4, pairs)
    delta = np.random.default_rng(2).standard_normal(50)
    gamma = -delta  # δ·γ < 0: fails the curvature guard
    mj2 = jcore.update_memory(mj, jnp.asarray(delta), jnp.asarray(gamma))
    mt2 = lbfgs_core.update_memory(mt, _t(delta), _t(gamma))
    for a, b in zip(mt2, mt):
        assert torch.equal(a, b)
    for got, want in zip(mt2, mj2):
        _close(got, want, rtol=1e-13, atol=1e-15)
    assert int(mt2.count) == 3 and int(mt2.pos) == 3


@pytest.mark.parametrize("flat", [False, True])
def test_inv_bb_step_matches(flat):
    rng = np.random.default_rng(4)
    x, xp, g, gp = (rng.standard_normal(40) for _ in range(4))
    if flat:
        xp = x.copy()  # δ·γ = 0: divides by 1
    want = jlinalg.inv_bb_step(*(jnp.asarray(v) for v in (x, xp, g, gp)))
    got = linalg.inv_bb_step(_t(x), _t(xp), _t(g), _t(gp))
    _close(got, want)
    if flat:
        _close(got, np.dot(g - gp, g - gp))


@pytest.mark.parametrize("scale", [0.1, 30.0])
def test_armijo_matches(scale):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        64, 16, density=0.3, n_active=4, seed=3, dtype=np.float64,
        label01=True)
    d = scale * np.random.default_rng(5).standard_normal(16)
    fj = lambda v: jlosses.logistic01_f(jnp.asarray(A), jnp.asarray(y), v)
    gj = lambda v: jlosses.logistic01_grad(jnp.asarray(A), jnp.asarray(y), v)
    ft = lambda v: losses.logistic01_f(_t(A), _t(y), v)
    gt = lambda v: losses.logistic01_grad(_t(A), _t(y), v)
    want = jlinalg.armijo_linesearch(jnp.asarray(x0), jnp.asarray(d), fj, gj)
    got = linalg.armijo_linesearch(_t(x0), _t(d), ft, gt)
    _close(got, want)
    if scale > 1:
        assert float(got) < 1.0  # it backtracked


def _logreg(m, n, pad, seed=7, grad=True):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.05, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01,
                      grad_fx=jlosses.logistic01_grad if grad else None,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64,
                      pad_features=pad)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                    grad_fx=losses.logistic01_grad if grad else None,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    pad_features=pad, device="cpu")
    return pj, pt


def test_one_step_from_a_jax_filled_memory():
    pj, _ = _logreg(256, 64, False, seed=3)
    sm_j = scso.PHuberSmootherL1L2(1.0)
    mj_ = scso.ProxLQNSCORE(m=5, kernels="xla")
    # fill the memory by three JAX epochs
    x = pj.x0
    mem = jcore.init_memory(64, 5, np.float64)
    cg = lambda v: pj.grad_f(pj.A, pj.y, v) + pj.lam * sm_j.grad(v)
    gq, gq_prev, x_prev = cg(x), jnp.zeros_like(x), x
    for it in (1, 2, 3):
        out = jsteps.lbfgs_step(mj_, pj, "l1", sm_j, pj.A, pj.y, x, x_prev,
                                gq_prev, jnp.int32(it), mem, gq_cached=gq)
        x, x_prev, gq, gq_prev, mem = (out.x_new, x, out.gq_new, out.gq,
                                       out.mem)
    assert int(mem.count) == 3
    out_j = jsteps.lbfgs_step(mj_, pj, "l1", sm_j, pj.A, pj.y, x, x_prev,
                              gq_prev, jnp.int32(4), mem, gq_cached=gq)

    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(pj.x0), np.asarray(pj.lam),
                            grad_fx=True, device="cpu")
    mt = lbfgs_memory_from_numpy(*(np.asarray(f) for f in mem),
                                 device="cpu")
    out = steps.lbfgs_step(st.ProxLQNSCORE(m=5, kernels="torch"), pt, "l1",
                           st.PHuberSmootherL1L2(1.0), pt.A, pt.y, _t(x),
                           _t(x_prev), _t(gq_prev), 4, mt, gq_cached=_t(gq))
    assert out.cg_iters == 0
    for f in ("x_new", "pri_res_norm", "dx", "gq", "gq_new", "d"):
        _close(getattr(out, f), getattr(out_j, f))
    for got, want in zip(out.mem, out_j.mem):
        _close(got, want)


# --- the reference's L-BFGS oracle (tests/test_algs.py:71-75) -------------
A_LOG = np.array([[-0.560501, 0.0], [0.0, 1.85278],
                  [-0.0192918, -0.827763], [0.128064, 0.110096],
                  [0.0, -0.251176]])
Y_LOG = np.array([-1.0, -1.0, -1.0, 1.0, -1.0])
X0_LOG = np.array([0.5908446386657102, 0.7667970365022592])


def _f_reg_t(A, y, x):
    return torch.sum(torch.log1p(torch.exp(-y * (A @ x)))) / 5.0


def _f_reg_j(A, y, x):
    return jnp.sum(jnp.log1p(jnp.exp(-y * (A @ x)))) / 5.0


@pytest.mark.parametrize("reg_name", ["l1", "l2"])
def test_lbfgs_oracle(reg_name):
    pt = st.Problem(A_LOG, Y_LOG, X0_LOG, _f_reg_t, 1.0,
                    dtype=torch.float64, device="cpu")
    assert pt.grad_fx is None  # ∇f by autograd through f
    s = st.iterate(st.ProxLQNSCORE(), pt, reg_name,
                   st.PHuberSmootherL1L2(1.0), verbose=0)
    assert float(s.rel[-1]) <= 1e-6 and float(s.objrel[-1]) <= 1e-6
    pj = scso.Problem(A_LOG, Y_LOG, X0_LOG, _f_reg_j, 1.0, dtype=np.float64)
    sj = scso.iterate(scso.ProxLQNSCORE(), pj, reg_name,
                      scso.PHuberSmootherL1L2(1.0), verbose=0)
    assert s.epochs == sj.epochs
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)


# (m, n, pad, alpha, stats_every, default method)
SOLVES = [(512, 256, False, None, 1, True), (512, 256, False, 1.0, 4, False),
          (384, 200, True, None, 4, False), (384, 200, True, 1.0, 1, True)]


@pytest.mark.parametrize("m,n,pad,alpha,K,default", SOLVES)
def test_lbfgs_solve_matches(m, n, pad, alpha, K, default):
    pj, pt = _logreg(m, n, pad)
    kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=60, verbose=0,
              stats_every=K, alpha=alpha)
    sj = scso.iterate(None if default else scso.ProxLQNSCORE(kernels="xla"),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(None if default else st.ProxLQNSCORE(), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs and s.cg_info is None
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.fval.numpy(), np.asarray(sj.fval), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)
    assert tuple(s.x.shape) == (n,)
    state = s.state
    assert int(state.mem.count) == int(sj.state.mem.count)
    assert state.mem.S.shape == (10, pt.x0.shape[-1])
