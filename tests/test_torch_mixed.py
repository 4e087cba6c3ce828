"""The port's bfloat16-A paths against scso_tpu: `iterate_mixed`, K2, K2s
and K5 with A in bfloat16, and the cached multi-output lp product.

Same numpy inputs through each JAX function and its port:
  * the plain K2 (both flavours), K2s and K5 with A in bfloat16 (the
    same bits in both packages) against the Pallas kernels in interpret
    mode: float32 rtol 2e-5, atol 3e-5·max(1, max|ref|) (sums in another
    order); float64 rtol 1e-12, atol 1e-12·max(1, max|ref|) for K2 and
    K2s, whose TPU kernels accumulate in x's dtype. K5's TPU kernel
    accumulates a bfloat16 tile in float32 whatever V's dtype
    (mglm_matvec.py, acc_dtype), as K1's does: in float64 the plain K5
    is held to the JAX two-matmul form (bf16 @ f64 promotes, 1e-12) and
    to the kernel at float32's tolerance;
  * the bfloat16 casts of both packages, from float32 and float64, give
    the same bits for every value in float32's normal range, ties and
    double-rounding traps included; they differ only in the bits of a
    NaN (both NaN) and, from float64, below float32's normal range,
    where XLA's CPU conversion flushes to zero (both stated below);
  * `st.iterate_mixed` against `scso.iterate_mixed` with
    kernels='xla', float64, greedy off, x* from a prior solve so that
    the coarse phase stops at its gap: cached and uncached GGN-CG,
    Newton-CG, L-BFGS and multinomial — equal coarse and fine epochs and
    CG iterations, objective histories to 1e-10 relative, x to 1e-9;
    greedy on: the final objective to 1e-8 (the accept test turns
    last-ulp differences into other trajectories);
  * a problem without data takes the plain `iterate`, with the same
    arguments;
  * on a one-rank gloo group the row-sharded problem runs the same two
    phases: bit for bit the unsharded solve;
  * the multi-output Jacobi term on a bfloat16 A whose squares bfloat16
    cannot hold (A squared after the upcast) against the JAX cache
    prime, 1e-12;
  * `prep_grid`/`mglm_grid` with A in bfloat16: the forms switch exactly
    at the limits, every row and 16-byte chunk is covered once;
  * the cached multinomial solve with the JAX package's bfloat16 copy
    and cg_lp_tol against `scso.iterate(kernels='xla')` (equal epochs
    and CG iterations, histories to 1e-10), and `_auto_lp`'s
    multi-output gates against scso_tpu's.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu._src.struct import replace as jreplace
from scso_tpu.algorithms import steps as jsteps
from scso_tpu.algorithms.iterate import Options as JOptions
from scso_tpu.algorithms.iterate import _auto_lp as j_auto_lp
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops.pallas.glm_prep import (
    _fused_glm_prep, _fused_glm_prep_pair)
from scso_tpu.ops.pallas.mglm_matvec import _fused_mglm_matvec
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import iterate as it_mod
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda.glm_prep import (
    cluster_max_n, glm_prep_pair_torch, glm_prep_torch, max_n, prep_grid)
from scso_tpu_torch.ops.cuda.mglm_matvec import (
    mglm_grid, mglm_matvec_torch, tc_blocks_per_sm, tc_geometry,
    tc_smem_bytes)
from scso_tpu_torch.parallel import distributed_init, make_mesh, shard_problem

from _torch_ranks import file_init

torch.set_num_threads(1)

BF16 = torch.bfloat16
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)
TOL = {np.float32: (2e-5, 3e-5), np.float64: (1e-12, 1e-12)}


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=atol_rel * max(1.0, top))


def _bf16(A):
    """A in bfloat16 in both packages, the same bits: (jax, torch)."""
    Aj = jnp.asarray(A, jnp.float32).astype(jnp.bfloat16)
    return Aj, torch.tensor(np.asarray(Aj, np.float32)).to(BF16)


# ---------------------------------------------------------------------------
# the kernels' plain versions with A in bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("flavour", ["ggn", "newton"])
@pytest.mark.parametrize("m,n", [(37, 128), (500, 256)])
def test_k2_with_a_bf16_matches_pallas(dtype, flavour, m, n):
    rng = np.random.default_rng(m + n)
    Aj, At = _bf16(rng.standard_normal((m, n)) * 0.3)
    y = (rng.random(m) > 0.5).astype(dtype)
    xt = (rng.standard_normal(n) * 0.3).astype(dtype)
    xd = (rng.standard_normal(n) * 0.3).astype(dtype)
    rw_fn, w_fn, loss_fn = jsteps._glm_kernel_fns(jlosses.LOGISTIC01_GLM, m,
                                                  flavour)
    want = _fused_glm_prep_pair(Aj, jnp.asarray(y), jnp.asarray(xt),
                                jnp.asarray(xd), rw_fn, w_fn, loss_fn,
                                interpret=True)
    got = glm_prep_pair_torch(At, torch.tensor(y), torch.tensor(xt),
                              torch.tensor(xd), losses.LOGISTIC01_GLM,
                              flavour=flavour)
    for f, g, w_ in zip(got._fields, got, want):
        assert g.dtype == torch.tensor(xt).dtype, f
        assert tuple(g.shape) == tuple(w_.shape), f
        _close(g, w_, *TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(37, 128), (500, 256)])
def test_k2s_with_a_bf16_matches_pallas(dtype, m, n):
    rng = np.random.default_rng(3 * m + n)
    Aj, At = _bf16(rng.standard_normal((m, n)) * 0.3)
    y = (rng.random(m) > 0.5).astype(dtype)
    x = (rng.standard_normal(n) * 0.3).astype(dtype)
    rw_fn, w_fn, _ = jsteps._glm_kernel_fns(jlosses.LOGISTIC01_GLM, m)
    want = _fused_glm_prep(Aj, jnp.asarray(y), jnp.asarray(x), rw_fn, w_fn,
                           interpret=True)
    got = glm_prep_torch(At, torch.tensor(y), torch.tensor(x),
                         losses.LOGISTIC01_GLM)[:3]
    for g, w_ in zip(got, want):
        _close(g, np.asarray(w_).reshape(g.shape), *TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,p,k", [(512, 128, 8), (130, 128, 3)])
def test_k5_with_a_bf16_matches_pallas(dtype, m, p, k):
    rng = np.random.default_rng(m + p + k)
    Aj, At = _bf16(rng.standard_normal((m, p)))
    y = np.eye(k, dtype=dtype)[rng.integers(0, k, m)]
    Z = (rng.standard_normal((m, k))).astype(dtype)
    V = rng.standard_normal((p, k)).astype(dtype)
    spec = losses.multinom_mglm(k)
    got = mglm_matvec_torch(At, torch.tensor(y), torch.tensor(Z),
                            torch.tensor(V), spec)
    assert got.dtype == torch.tensor(V).dtype
    quad = jlosses.multinom_mglm(k).quad
    want = _fused_mglm_matvec(Aj, jnp.asarray(y), jnp.asarray(Z),
                              jnp.asarray(V), quad, m, interpret=True)
    # the TPU kernel accumulates in float32 for a bfloat16 A
    _close(got, want, *TOL[np.float32])
    if dtype == np.float64:
        xla = Aj.T @ quad(jnp.asarray(y), jnp.asarray(Z), Aj @ jnp.asarray(V))
        assert xla.dtype == jnp.float64
        _close(got, xla, *TOL[np.float64])


# values at and next to bfloat16's rounding ties: 1 + 2⁻⁸ is halfway
# between two bfloat16 values; ± 2⁻⁴⁰ and ± 2⁻³⁰ sit within float32's
# rounding of the tie (a double rounding from float64) or past it
_E = 2.0 ** -8
_TIES = [1 + _E, 1 + 3 * _E, 1 + _E + 2.0 ** -40, 1 + _E - 2.0 ** -40,
         1 + _E + 2.0 ** -30, 1 + _E - 2.0 ** -30, -(1 + _E), 3 * (1 + _E),
         (1 + _E) * 2.0 ** -120, (1 + _E) * 2.0 ** 120, 0.0, -0.0, 3e38,
         np.inf, -np.inf]


@pytest.mark.parametrize("src", [np.float32, np.float64])
def test_bf16_casts_give_the_same_bits(src):
    rng = np.random.default_rng(5)
    vals = np.concatenate([np.asarray(_TIES),
                           rng.standard_normal(4096) * 10.0 ** rng.integers(
                               -30, 30, 4096)]).astype(src)
    vals = vals[np.abs(vals) >= np.finfo(np.float32).tiny * (vals != 0)]
    bits_t = torch.tensor(vals).to(BF16).view(torch.int16).numpy()
    bits_j = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)).view(
        np.int16)
    assert np.array_equal(bits_t, bits_j)
    # the port's coarse phase casts as st.iterate_mixed does
    assert np.array_equal(
        torch.tensor(vals).to(BF16).float().numpy(),
        np.asarray(jnp.asarray(vals).astype(jnp.bfloat16), np.float32))


def test_bf16_casts_differ_only_in_nan_bits_and_flushed_subnormals():
    nan = np.array([np.nan], np.float32)
    t = torch.tensor(nan).to(BF16).float().numpy()
    j = np.asarray(jnp.asarray(nan).astype(jnp.bfloat16), np.float32)
    assert np.isnan(t).all() and np.isnan(j).all()
    # a float64 value below float32's normal range: torch rounds it to a
    # bfloat16 subnormal, XLA on the CPU flushes it to zero
    tiny = np.array([1e-40], np.float64)
    assert float(torch.tensor(tiny).to(BF16)) > 0.0
    assert np.asarray(jnp.asarray(tiny).astype(jnp.bfloat16),
                      np.float32)[0] == 0.0


# ---------------------------------------------------------------------------
# iterate_mixed against scso.iterate_mixed
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _logreg_data():
    return jsynth.make_sparse_logreg_data(
        384, 128, density=0.2, n_active=8, seed=7, dtype=np.float64,
        label01=True)[:3]


@functools.lru_cache(maxsize=None)
def _mglm_data():
    return jsynth.make_multinomial_data(256, 32, 4, seed=11,
                                        dtype=np.float64)[:3]


def _problems(kind, lam=1e-2, sol=None):
    """(JAX problem, port problem), float64, x* ``sol`` (zeros: None)."""
    if kind == "mglm":
        A, y, x0 = _mglm_data()
        pj = scso.Problem(A, y, x0, jlosses.multinom_f, 1e-2,
                          grad_fx=jlosses.multinom_grad,
                          mglm=jlosses.multinom_mglm(4), sol=sol,
                          dtype=np.float64)
        pt = st.Problem(A, y, x0, losses.multinom_f, 1e-2,
                        grad_fx=losses.multinom_grad,
                        mglm=losses.multinom_mglm(4), sol=sol,
                        dtype=torch.float64, device="cpu")
        return pj, pt
    A, y, x0 = _logreg_data()
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, sol=sol, dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, sol=sol, dtype=torch.float64,
                    device="cpu")
    return pj, pt


# name → (method class name, its fields, problem kind, λ); Newton-CG at
# λ = 0.1 (test_torch_newton.py: at 0.01 damped Newton runs away here)
PATHS = {
    "ggn_cached": ("ProxGGNSCORE", dict(solver="cg", greedy_alpha=False),
                   "logreg", 1e-2),
    "ggn_uncached": ("ProxGGNSCORE", dict(solver="cg", greedy_alpha=False,
                                          epoch_cache=False),
                     "logreg", 1e-2),
    "newton_cg": ("ProxNSCORE", dict(solver="cg", greedy_alpha=False),
                  "logreg", 0.1),
    "lbfgs": ("ProxLQNSCORE", dict(), "logreg", 1e-2),
    "multinomial": ("ProxGGNSCORE", dict(solver="cg", greedy_alpha=False),
                    "mglm", 1e-2),
}


@functools.lru_cache(maxsize=None)
def _sol(name):
    """x* of PATHS[name]: its own method's fixed point (a prior solve),
    so that the coarse phase can reach its gap."""
    cls, fields, kind, lam = PATHS[name]
    return st.iterate(getattr(st, cls)(**fields), _problems(kind, lam)[1],
                      "l1", st.PHuberSmootherL1L2(1.0), x_tol=1e-14,
                      f_tol=1e-14, max_epoch=300, verbose=0).x.numpy()


def _both(name, **extra):
    """The solve of PATHS[name] through both packages' iterate_mixed."""
    cls, fields, kind, lam = PATHS[name]
    fields = dict(fields, **extra)
    pj, pt = _problems(kind, lam, _sol(name))
    sm_j, sm_t = scso.PHuberSmootherL1L2(1.0), st.PHuberSmootherL1L2(1.0)
    sj = scso.iterate_mixed(getattr(scso, cls)(kernels="xla", **fields), pj,
                            "l1", sm_j, **KW)
    s = st.iterate_mixed(getattr(st, cls)(**fields), pt, "l1", sm_t, **KW)
    return s, sj


def _info(sol):
    return {k: v for k, v in (sol.cg_info or {}).items()
            if k != "coarse_time_s"}


@pytest.mark.parametrize("name", list(PATHS))
def test_iterate_mixed_matches_jax(name):
    s, sj = _both(name)
    assert s.cg_info["coarse_epochs"] == sj.cg_info["coarse_epochs"]
    # the coarse phase stopped at its gap, and the fine phase ran
    assert 0 < s.cg_info["coarse_epochs"] < 50 and s.epochs > 0
    assert s.epochs == sj.epochs
    assert _info(s) == _info(sj)
    assert s.cg_info["coarse_time_s"] > 0.0
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-9)
    assert s.x.dtype == torch.float64


def test_iterate_mixed_greedy_matches_jax_at_its_fixed_point():
    s, sj = _both("ggn_cached", greedy_alpha=True)
    obj, obj_j = float(s.obj[-1]), float(sj.obj[-1])
    assert abs(obj - obj_j) <= 1e-8 * abs(obj_j)


def test_iterate_mixed_keeps_a_copy_and_casts_only_a(monkeypatch):
    """The coarse problem is the model with A cast (x0, y, A_lp kept);
    the fine one the model from the coarse iterate."""
    _, pt = _problems("logreg", sol=_sol("ggn_cached"))
    pt = st.with_lp_copy(pt)
    seen = []
    real = it_mod.iterate

    def spy(method, prob, *a, **kw):
        seen.append((prob, kw))
        return real(method, prob, *a, **kw)

    monkeypatch.setattr(it_mod, "iterate", spy)
    st.iterate_mixed(st.ProxGGNSCORE(solver="cg", greedy_alpha=False), pt,
                     "l1", st.PHuberSmootherL1L2(1.0), coarse_max_epoch=3,
                     **KW)
    (coarse, ckw), (fine, fkw) = seen
    assert coarse.A.dtype == BF16 and fine.A is pt.A
    assert coarse.A_lp is pt.A_lp and coarse.y is pt.y
    assert coarse.x0 is pt.x0 and fine.x0.dtype == pt.x0.dtype
    assert ckw == dict(KW, f_tol=1e-3, max_epoch=3) and fkw == KW


def test_iterate_mixed_without_data_is_the_plain_iterate(monkeypatch):
    bare = st.Problem(np.zeros(3), lambda x: torch.sum((x - 1.0) ** 2), 0.1,
                      dtype=torch.float64, device="cpu")
    assert not bare.has_data
    method, sm = st.ProxNSCORE(), st.PHuberSmootherL1L2(1.0)
    # a problem without data: iterate_mixed is the plain iterate
    a, b = (fn(method, bare, "l1", sm, max_epoch=3, verbose=0, alpha=1.0)
            for fn in (st.iterate, st.iterate_mixed))
    assert a.epochs == b.epochs
    assert torch.equal(a.x, b.x) and torch.equal(a.obj, b.obj)
    seen = []
    monkeypatch.setattr(it_mod, "iterate",
                        lambda *a, **kw: seen.append((a, kw)) or "plain")
    assert st.iterate_mixed(method, bare, "l1", sm, max_epoch=3,
                            coarse_max_epoch=7) == "plain"
    assert seen == [((method, bare, "l1", sm), dict(max_epoch=3))]


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, and its mesh."""
    distributed_init("gloo", init_method=file_init(tmp_path),
                     world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


def test_iterate_mixed_on_one_rank_is_the_unsharded_solve(one_rank):
    _, pt = _problems("logreg", sol=_sol("ggn_cached"))
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    sm = st.PHuberSmootherL1L2(1.0)
    s = st.iterate_mixed(method, shard_problem(pt, one_rank), "l1", sm, **KW)
    base = st.iterate_mixed(method, pt, "l1", sm, **KW)
    assert _info(s) == _info(base) and s.epochs == base.epochs
    assert torch.equal(s.x, base.x) and torch.equal(s.obj, base.obj)


# ---------------------------------------------------------------------------
# the multi-output path with A in bfloat16
# ---------------------------------------------------------------------------


def test_mglm_jacobi_term_squares_after_the_upcast():
    A, y, x0, _ = jsynth.make_multinomial_data(64, 8, 3, seed=2,
                                               dtype=np.float64)
    # 1 + 2⁻⁷ is a bfloat16 value; its square 1 + 2⁻⁶ + 2⁻¹⁴ is not
    A = np.where(np.abs(A) > 0.5, np.sign(A) * (1 + 2.0 ** -7), A)
    Aj, At = _bf16(A)
    assert not torch.equal(torch.square(At).double(),
                           torch.square(At.double()))
    pj = scso.Problem(np.asarray(Aj, np.float64), y, x0, jlosses.multinom_f,
                      1e-2, mglm=jlosses.multinom_mglm(3), dtype=np.float64)
    pj = jreplace(pj, A=Aj)
    pt = st.Problem(At.double(), y, x0, losses.multinom_f, 1e-2,
                    mglm=losses.multinom_mglm(3), dtype=torch.float64,
                    device="cpu")
    pt = replace(pt, A=At)
    want = jsteps._prime_moglm(pj, pj.x0 + 0.1, pj.A, pj.y)
    got = steps._prime_moglm(pt, pt.x0 + 0.1, pt.A, pt.y)
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-12, 1e-12)


@pytest.mark.parametrize("candidates", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prep_grid_with_a_bf16_switches_at_the_limit(candidates, dtype):
    limit = max_n(dtype, candidates, BF16)
    # the accumulators stay in dtype: the same limit as A in dtype
    assert limit == max_n(dtype, candidates)
    # K2 in float32 runs the cluster form from n = 1025 up to the same n
    # (K2s's limit is past the cluster form's)
    below = ("cluster" if (candidates, dtype) == (2, torch.float32)
             else "one_pass")
    if below == "cluster":
        assert cluster_max_n() == limit
    for n in (limit - 8, limit - 1, limit):
        assert prep_grid(1031, n, dtype, candidates, 132,
                         a_dtype=BF16).form == below
    for n in (limit + 1, limit + 8, 2 * limit):
        assert prep_grid(1031, n, dtype, candidates, 132,
                         a_dtype=BF16).form == "wide"
    assert prep_grid(1031, limit, dtype, candidates, 132, covered=False,
                     a_dtype=BF16).form == "split"


@pytest.mark.parametrize("candidates", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,sms", [
    (1, 256, 132), (5, 1001, 132), (1000, 10112, 132),
    (196608, 10112, 132), (524288, 1024, 132), (999, 1001, 114),
    (3, 64, 1), (65536, 7170, 132), (4099, 28672, 132)])
def test_prep_grid_with_a_bf16_covers_rows_and_chunks_once(candidates, dtype,
                                                           m, n, sms):
    g = prep_grid(m, n, dtype, candidates, sms, a_dtype=BF16)
    assert g.blocks * g.rows_per_block >= m
    assert (g.blocks - 1) * g.rows_per_block < m
    if g.form == "wide":
        assert n > max_n(dtype, candidates, BF16)
        return
    if g.form == "cluster":  # float32: tests/test_torch_bf16_forms.py
        assert dtype == torch.float32
        assert g.cluster * (g.threads - 64) * 8 >= n
        assert g.smem_bytes <= 224 * 1024
        return
    nc = -(-n // 8)  # 16-byte chunks of 8 bfloat16 values
    assert g.smem_bytes == 2 * candidates * nc * 8 * dtype.itemsize
    assert g.smem_bytes <= 224 * 1024
    # the buckets glm_prep_bf16.cu instantiates
    top = {(2, torch.float32): 4, (2, torch.float64): 2,
           (1, torch.float32): 7, (1, torch.float64): 4}[candidates, dtype]
    assert 1 <= g.chunks_per_thread <= top
    assert g.threads * g.chunks_per_thread >= nc
    assert (g.threads - 32) * g.chunks_per_thread < nc
    per_sm = -(-g.blocks // sms)
    assert per_sm * g.threads * 128 <= 65536
    assert per_sm * (g.smem_bytes + 2048) <= 228 * 1024


def test_main_shape_with_a_bf16_runs_the_one_pass_form():
    # K2s past the cluster form's limit, 196608×20224: 2,528 chunks of 8
    # values, 5 a thread, 512 threads; the accumulators in float32 as
    # with A in float32 (in float32 K2 and K2s take the cluster form at
    # the main shape: tests/test_torch_bf16_forms.py)
    g = prep_grid(196608, 20224, torch.float32, 1, 132, a_dtype=BF16)
    assert (g.form, g.chunks_per_thread, g.threads, g.smem_bytes) == (
        "one_pass", 5, 512, 161792)
    # K2 in float64 at its one-pass limit, 896 chunks: 2 a thread
    g = prep_grid(196608, 7168, torch.float64, 2, 132, a_dtype=BF16)
    assert (g.form, g.chunks_per_thread, g.threads) == ("one_pass", 2, 448)
    for c in (1, 2):
        assert prep_grid(196608, 10112, torch.float32, c, 132,
                         a_dtype=BF16).form == "cluster"


@pytest.mark.parametrize("p,k", [(1024, 16), (1025, 16), (1024, 17),
                                 (77, 9), (128, 8), (512, 3)])
def test_mglm_grid_with_a_bf16(p, k):
    for dtype in (torch.float32, torch.float64):
        g = mglm_grid(3001, p, k, dtype, 132, a_dtype=BF16)
        want = mglm_grid(3001, p, k, dtype, 132)
        assert g.form == want.form
        assert g.blocks * g.rows_per_block >= 3001
        if g.form == "tensor":
            # the bfloat16 form's ring, V's and QU's three pieces, and as
            # many blocks an SM as its registers take (3001 rows: at most
            # one a 16-row tile)
            assert g.smem_bytes == tc_smem_bytes(p, k, BF16)
            assert g.threads == want.threads
            per_sm = tc_blocks_per_sm(p, k)
            assert g.blocks <= min(per_sm * 132, -(-3001 // 16))
            assert g.rows_per_block % 16 == 0
        else:
            assert g == want
    # 196608×1024×16: three stages of 16 padded rows beside V's pieces
    assert mglm_grid(196608, 1024, 16, torch.float32, 132,
                     a_dtype=BF16).smem_bytes == 215320


def test_cached_mglm_solve_with_a_bf16_copy_matches_jax():
    pj, pt = _problems("mglm", sol=_sol("multinomial"))
    pj = scso.with_lp_copy(pj)
    pt = replace(pt, A_lp=torch.tensor(np.asarray(pj.A_lp, np.float32)).to(
        BF16))
    kw = dict(solver="cg", greedy_alpha=False, cg_adaptive=True,
              cg_lp_tol=1e-2)
    sj = scso.iterate(scso.ProxGGNSCORE(kernels="xla", **kw), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(**kw), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    assert s.epochs == sj.epochs and s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), atol=1e-9)
    # the copy acted: without it the solve takes another path
    base = st.iterate(st.ProxGGNSCORE(**dict(kw, cg_lp_tol=0.0)),
                      replace(pt, A_lp=None), "l1",
                      st.PHuberSmootherL1L2(1.0), **KW)
    assert not torch.equal(base.x, s.x)


# (ProxGGNSCORE fields, float32 data?) — _auto_lp's gates on a
# multi-output problem, auto_lp=True
MGLM_GATES = [
    (dict(), True),
    (dict(epoch_cache=False), True),
    (dict(ss_type=2), True),
    (dict(cg_adaptive=True), True),
    (dict(), False),
    (dict(auto_lp=False), True),
]


@pytest.mark.parametrize("fields,f32", MGLM_GATES,
                         ids=["open", "uncached", "ss_type2", "cg_adaptive",
                              "float64", "off"])
def test_auto_lp_mglm_gates_decide_as_jax(fields, f32):
    A, y, x0, _ = jsynth.make_multinomial_data(
        64, 8, 3, seed=1, dtype=np.float32 if f32 else np.float64)
    kw = dict(dict(solver="cg", auto_lp=True), **fields)
    pt = st.Problem(A, y, x0, losses.multinom_f, 1e-2,
                    mglm=losses.multinom_mglm(3), device="cpu")
    pj = scso.Problem(A, y, x0, jlosses.multinom_f, 1e-2,
                      mglm=jlosses.multinom_mglm(3))
    m_t, p_t = it_mod._auto_lp(st.ProxGGNSCORE(**kw), pt)
    m_j, p_j = j_auto_lp(scso.ProxGGNSCORE(**kw), pj, JOptions())
    attached = getattr(p_j, "A_lp", None) is not None
    assert (p_t.A_lp is not None) == attached
    assert m_t.cg_lp_tol == m_j.cg_lp_tol
    if attached:
        assert np.array_equal(p_t.A_lp.float().numpy(),
                              np.asarray(p_j.A_lp, np.float32))


def test_auto_lp_none_on_mglm_needs_the_card(monkeypatch):
    """auto_lp=None on a multi-output problem attaches no copy while
    _AUTO_LP_MIN_BYTES_MGLM is None (the copy did not win clearly on the
    H100), and once it is set only for A on a CUDA device: a CPU problem
    gets none, whatever its size."""
    A, y, x0, _ = jsynth.make_multinomial_data(64, 8, 3, seed=1,
                                               dtype=np.float32)
    pt = st.Problem(A, y, x0, losses.multinom_f, 1e-2,
                    mglm=losses.multinom_mglm(3), device="cpu")
    method = st.ProxGGNSCORE(solver="cg")
    assert it_mod._AUTO_LP_MIN_BYTES_MGLM is None
    for threshold in (None, 0):
        monkeypatch.setattr(it_mod, "_AUTO_LP_MIN_BYTES_MGLM", threshold)
        m2, p2 = it_mod._auto_lp(method, pt)
        assert p2.A_lp is None and m2.cg_lp_tol == 0.0


def test_coarse_phase_with_a_bf16_a_takes_itself_as_the_copy():
    """In the coarse phase A is already bfloat16: auto_lp attaches A
    itself, and the solve takes the same epochs and CG iterations with
    it as without it."""
    A, y, x0 = _logreg_data()
    pt = st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                    device="cpu")
    coarse = replace(pt, A=pt.A.to(BF16))
    m_on, p_on = it_mod._auto_lp(st.ProxGGNSCORE(solver="cg", auto_lp=True),
                                 coarse)
    assert p_on.A_lp is coarse.A
    run = lambda auto: st.iterate(
        st.ProxGGNSCORE(solver="cg", auto_lp=auto), coarse, "l1",
        st.PHuberSmootherL1L2(1.0), f_tol=1e-3, max_epoch=50, verbose=0)
    on, off = run(True), run(False)
    assert on.epochs == off.epochs and on.cg_info == off.cg_info
    assert torch.equal(on.x, off.x)

