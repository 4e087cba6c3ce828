"""The port's multinomial (multi-output GGN-CG) path against scso_tpu.

Same numpy inputs, float64, through each JAX function and its port:
  * the spec's fields and the multinomial losses, rtol 1e-12;
  * `make_multinomial_data`, bit-identical;
  * K5's plain version against the Pallas kernel in interpret mode
    (rtol 1e-10, atol 1e-12, as tests/test_multioutput.py holds the
    kernel) and against the JAX two-matmul form at odd shapes;
  * the cache prime and the dual-candidate prep, 1e-12;
  * one `ggn_step` from a JAX-primed cache, 1e-10;
  * a damped solve (greedy off): epochs, CG iterations and objective
    history to rtol 1e-9, against scso.iterate(kernels='xla');
  * a greedy solve: the fixed point, final objective to rel 1e-8 (the
    accept test turns last-ulp differences into other trajectories);
  * an uncached solve with a bfloat16 copy of A and cg_lp_tol: the
    JAX package never reads the copy there, and neither does the port
    (the same trajectory, to the damped solve's bounds, and bit for bit
    the port's solve without the copy);
  * the validation that raises, and the cached path's lp options
    (auto_lp=True, cg_lp_tol with a bfloat16 copy) against scso.iterate.
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
from scso_tpu.ops.lbfgs_core import init_memory
from scso_tpu.ops.pallas.mglm_matvec import fused_mglm_matvec
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_matvec, mglm_matvec_torch
from scso_tpu_torch.utils.convert import (
    moglm_cache_from_numpy, problem_from_numpy)

torch.set_num_threads(1)

# λ = 1e-2: at the bench's 1e-3 the softmax's flat direction (adding a
# constant to every class) leaves the CG systems so ill-conditioned at
# this size that the iteration counts follow last-ulp differences
# (objectives still agree to 2e-11)
M, P, K = 256, 32, 4
LAM = 1e-2
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
          stats_every=4, alpha=1.0)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _problems(m=M, p=P, k=K, seed=11):
    A, y, x0, _ = jsynth.make_multinomial_data(m, p, k, seed=seed,
                                               dtype=np.float64)
    pj = scso.Problem(A, y, x0, jlosses.multinom_f, LAM,
                      grad_fx=jlosses.multinom_grad,
                      mglm=jlosses.multinom_mglm(k), dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.multinom_f, LAM,
                    grad_fx=losses.multinom_grad,
                    mglm=losses.multinom_mglm(k), dtype=torch.float64,
                    device="cpu")
    return pj, pt


def _inputs(m, p, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, p))
    y = np.eye(k)[rng.integers(0, k, m)]
    W = 0.3 * rng.standard_normal((p, k))
    V = rng.standard_normal((p, k))
    return A, y, A @ W, V, W


@pytest.mark.parametrize("field", ["gres", "quad", "qdiag_w", "loss_z",
                                   "loss_sample", "multinom_f",
                                   "multinom_grad"])
def test_losses_and_spec_fields_match(field):
    A, y, Z, _, W = _inputs(40, 6, 5, 0)
    Z = 4.0 * Z  # some saturated rows
    jspec, spec = jlosses.multinom_mglm(5), losses.multinom_mglm(5)
    if field == "quad":
        U = Z[::-1].copy()
        want = jspec.quad(jnp.asarray(y), jnp.asarray(Z), jnp.asarray(U))
        got = spec.quad(_t(y), _t(Z), _t(U))
    elif field.startswith("multinom_"):
        x = W.reshape(-1)
        want = getattr(jlosses, field)(jnp.asarray(A), jnp.asarray(y),
                                       jnp.asarray(x))
        got = getattr(losses, field)(_t(A), _t(y), _t(x))
    else:
        want = getattr(jspec, field)(jnp.asarray(y), jnp.asarray(Z))
        got = getattr(spec, field)(_t(y), _t(Z))
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)
    assert spec.kind == "multinomial" and spec.n_out == jspec.n_out == 5
    assert spec.sample_normalized == jspec.sample_normalized


@pytest.mark.parametrize("kw", [
    dict(m=300, p=20, k=4, seed=11),
    dict(m=64, p=7, k=11, seed=3, dtype=np.float64, scale=0.5),
])
def test_multinomial_data_is_bit_identical(kw):
    for a, b in zip(jsynth.make_multinomial_data(**kw),
                    synthetic.make_multinomial_data(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("m,p,k", [(512, 128, 8), (700, 256, 4),
                                   (130, 128, 3)])
def test_plain_matvec_matches_pallas(m, p, k):
    A, y, Z, V, _ = _inputs(m, p, k, m)
    want = fused_mglm_matvec(jnp.asarray(A), jnp.asarray(y), jnp.asarray(Z),
                             jnp.asarray(V), jlosses.multinom_mglm(k).quad)
    got = mglm_matvec_torch(_t(A), _t(y), _t(Z), _t(V),
                            losses.multinom_mglm(k))
    _close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m,p,k", [(16, 1, 2), (33, 5, 7), (8, 12, 2),
                                   (64, 4, 11)])
def test_plain_matvec_matches_two_matmuls(m, p, k):
    A, y, Z, V, _ = _inputs(m, p, k, m + p + k)
    Aj = jnp.asarray(A)
    want = Aj.T @ jlosses.multinom_mglm(k).quad(
        jnp.asarray(y), jnp.asarray(Z), Aj @ jnp.asarray(V))
    counters.reset()
    got = mglm_matvec(_t(A), _t(y), _t(Z), _t(V), losses.multinom_mglm(k))
    assert counters.snapshot()["mglm_matvec"] == 0  # plain on the CPU
    _close(got, want, rtol=1e-10, atol=1e-12)


def test_prime_and_pair_prep_match():
    pj, pt = _problems()
    rng = np.random.default_rng(5)
    xt, xd = (0.2 * rng.standard_normal(P * K) for _ in range(2))
    mj = scso.ProxGGNSCORE(solver="cg", kernels="xla")
    want = jsteps.prime_glm_cache(mj, pj, jnp.asarray(xt))
    got = steps.prime_glm_cache(st.ProxGGNSCORE(solver="cg"), pt, _t(xt))
    assert isinstance(got, steps.MOGLMCache)
    for g, w in zip(got, want):
        _close(g, w)
    pair_j = jsteps._moglm_pair_prep(pj.A, pj.y, pj.mglm, jnp.asarray(xt),
                                     jnp.asarray(xd))
    pair_t = steps._moglm_pair_prep(pt.A, pt.y, pt.mglm, _t(xt), _t(xd))
    for cand_t, cand_j in zip(pair_t, pair_j):
        for g, w in zip(cand_t, cand_j):
            _close(g, w)


@pytest.mark.parametrize("greedy", [False, True])
def test_one_step_from_the_jax_primed_cache(greedy):
    pj, _ = _problems(seed=3)
    mj = scso.ProxGGNSCORE(solver="cg", kernels="xla", greedy_alpha=greedy)
    x0 = pj.x0
    cache = jsteps.prime_glm_cache(mj, pj, x0)
    out_j = jsteps.ggn_step(
        mj, pj, "l1", scso.PHuberSmootherL1L2(1.0), pj.A, pj.y, x0, x0,
        jnp.zeros_like(x0), jnp.int32(1), init_memory(P * K, 1, np.float64),
        d_prev=jnp.zeros_like(x0), bnorm_prev=jnp.asarray(jnp.nan),
        fcache=cache)

    pt = problem_from_numpy(np.asarray(pj.A), np.asarray(pj.y),
                            np.asarray(x0), np.asarray(pj.lam),
                            glm="multinomial", n_out=K, device="cpu")
    ct = moglm_cache_from_numpy(*(np.asarray(f) for f in cache),
                                device="cpu")
    mt = st.ProxGGNSCORE(solver="cg", greedy_alpha=greedy, kernels="torch")
    xt = pt.x0
    out = steps.ggn_step(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), pt.A,
                         pt.y, xt, xt, 1, d_prev=torch.zeros_like(xt),
                         bnorm_prev=None, fcache=ct)
    assert out.cg_iters == int(out_j.cg_iters)
    for got, want in ((out.x_new, out_j.x_new), (out.d, out_j.d),
                      (out.dx, out_j.dx),
                      (out.pri_res_norm, out_j.pri_res_norm)):
        _close(got, want, rtol=1e-10, atol=1e-12)
    assert isinstance(out.fcache, steps.MOGLMCache)
    for got, want in zip(out.fcache, out_j.fcache):
        _close(got, want, rtol=1e-10, atol=1e-12)


def _solve(pj, pt, greedy):
    sj = scso.iterate(scso.ProxGGNSCORE(solver="cg", kernels="xla",
                                        greedy_alpha=greedy),
                      pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(solver="cg", greedy_alpha=greedy),
                   pt, "l1", st.PHuberSmootherL1L2(1.0), **KW)
    return sj, s


def test_damped_trajectory_matches():
    sj, s = _solve(*_problems(), greedy=False)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-9, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)


def test_greedy_fixed_point_matches():
    sj, s = _solve(*_problems(), greedy=True)
    assert float(s.obj[-1]) == pytest.approx(float(sj.obj[-1]), rel=1e-8)


def test_uncached_solve_ignores_the_lp_copy_as_jax():
    pj, pt = _problems()
    pj = scso.with_lp_copy(pj)
    pt = replace(pt, A_lp=torch.tensor(np.asarray(pj.A_lp, np.float32)).to(
        torch.bfloat16))
    kw = dict(solver="cg", greedy_alpha=False, epoch_cache=False,
              cg_lp_tol=1e-3)
    sj = scso.iterate(scso.ProxGGNSCORE(kernels="xla", **kw), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(**kw), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-9, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)
    kw.pop("cg_lp_tol")
    no_copy = st.iterate(st.ProxGGNSCORE(**kw), replace(pt, A_lp=None), "l1",
                         st.PHuberSmootherL1L2(1.0), **KW)
    assert torch.equal(s.x, no_copy.x)


def test_cache_predicate_solver_and_greedy_rule():
    _, pt = _problems(64, 8, 3)
    on = st.ProxGGNSCORE(solver="cg")
    assert steps.epoch_cache_enabled(on, pt, "l1", True)
    assert steps._resolve_ggn_solver(st.ProxGGNSCORE(), pt, pt.x0) == "cg"
    assert not steps.epoch_cache_enabled(
        on, replace(pt, mglm=replace(pt.mglm, loss_sample=None)), "l1",
        True)
    # AUTO greedy: on at n >= 4096 with a loss_z (the JAX package's rule)
    assert steps.use_greedy(on, 4096, pt) == jsteps.use_greedy(
        scso.ProxGGNSCORE(solver="cg"), 4096, _problems(64, 8, 3)[0])
    assert not steps.use_greedy(
        on, 4096, replace(pt, mglm=replace(pt.mglm, loss_z=None)))


def test_validation_raises():
    A, y, x0, _ = synthetic.make_multinomial_data(8, 6, 3, seed=0,
                                                  dtype=np.float64)
    with pytest.raises(ValueError, match="mglm"):
        st.Problem(A, y, x0, losses.multinom_f, LAM,
                   mglm=losses.multinom_mglm(3), dtype=torch.float64,
                   pad_features=True, device="cpu")
    pj, pt = _problems(24, 6, 3)
    # n = 18 is not divisible by 5 (both packages raise), and the
    # n_out = 0 placeholder
    with pytest.raises(ValueError, match="n_out"):
        jsteps._mo_shapes(jlosses.multinom_mglm(5), pj.x0)
    for spec_bad in (losses.multinom_mglm(5), losses.MULTINOM_MGLM):
        with pytest.raises(ValueError, match="n_out"):
            steps.prime_glm_cache(st.ProxGGNSCORE(solver="cg"),
                                  replace(pt, mglm=spec_bad), pt.x0)
    with pytest.raises(ValueError, match="n_out"):
        problem_from_numpy(A, y, x0, LAM, glm="multinomial",
                           device="cpu")


@pytest.mark.parametrize("fields", [
    dict(solver="cg", auto_lp=True),
    dict(solver="cg", cg_lp_tol=1e-3),
], ids=["auto_lp", "cg_lp_tol"])
def test_unported_parts_raise(fields):
    """The cached path's lp options run and match scso_tpu: auto_lp=True
    (no copy on a float64 problem, in both packages) and cg_lp_tol with a
    bfloat16 copy (the JAX package's, carried over bit for bit)."""
    pj, pt = _problems(64, 8, 3)
    if "cg_lp_tol" in fields:  # the cached lp product, with a copy
        pj = scso.with_lp_copy(pj)
        pt = replace(pt, A_lp=torch.tensor(
            np.asarray(pj.A_lp, np.float32)).to(torch.bfloat16))
    kw = dict(verbose=0, max_epoch=8)
    sj = scso.iterate(scso.ProxGGNSCORE(kernels="xla", **fields), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(st.ProxGGNSCORE(**fields), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs and s.cg_info == sj.cg_info
    _close(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10, atol=0)
    _close(s.x.numpy(), np.asarray(sj.x), rtol=0, atol=1e-9)
