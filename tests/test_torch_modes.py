"""The solve loop's two modes against scso_tpu, and the device-loop helper.

Same numpy inputs, float64, on the CPU (kernels resolve to 'torch', the
plain versions; the JAX package runs ``kernels='xla'``):
  * ``mode='timed'`` (the JAX package's `_solve_python`) for
    ProxGGNSCORE(solver='cg'), ProxNSCORE(solver='cg') and ProxLQNSCORE:
    the same epochs, obj, fval and rel histories to 1e-10 relative, one
    time a record and the times non-decreasing;
  * ``mode='fused'`` for the same methods with stats_every 1 and 4, each
    to convergence and to the max_epoch exit: the same epochs, records
    (the JAX package's n_rec) and CG iterations, the histories to 1e-10
    relative;
  * the device form of `cg_solve` (with and without a warm start and a
    preconditioner, and at its iteration cap) and of the Armijo line
    search against `scso_tpu.ops.linalg`: the same iteration counts, x
    to 1e-12;
  * the helper's plain form (`ops/cuda/graph.py`): `device_if`,
    `device_cond` and `device_loop`, the batches of replays, and
    a fused loop whose rounds past the end change nothing.
The captured form runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it bit for bit against the eager form there.
"""

import functools

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.ops import linalg as jlinalg
from scso_tpu_torch.algorithms import iterate as titerate
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops import linalg
from scso_tpu_torch.ops.cuda import graph

torch.set_num_threads(1)

M, N = 256, 64


def _problems(lam=0.1, sol=None):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        M, N, density=0.05, n_active=8, seed=5, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, sol=sol, dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, sol=sol, dtype=torch.float64,
                    device="cpu")
    return pj, pt


@functools.lru_cache(maxsize=None)
def _lbfgs_anchor():
    """x* for the L-BFGS problem: 300 epochs of the JAX package's solve.
    Its steps never shrink below x_tol here, so its converged exit is the
    f_tol test against this anchor, at a loose gap (``LBFGS_F_TOL``;
    λ = 0.01: at λ = 0.1 the BB steps turn last-ulp differences into
    other trajectories in both packages)."""
    pj, _ = _problems(lam=0.01)
    sj = scso.iterate(scso.ProxLQNSCORE(m=5, kernels="xla"), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), x_tol=0.0, f_tol=0.0,
                      max_epoch=300, verbose=0)
    return np.asarray(sj.x)


METHODS = {
    "ggn": (lambda pkg, **kw: pkg.ProxGGNSCORE(solver="cg",
                                               greedy_alpha=False, **kw)),
    "newton": (lambda pkg, **kw: pkg.ProxNSCORE(solver="cg",
                                                greedy_alpha=False, **kw)),
    "lbfgs": (lambda pkg, **kw: pkg.ProxLQNSCORE(m=5, **kw)),
}
#: a converged exit, and the max_epoch exit (no test can fire)
EXITS = {"converged": dict(x_tol=1e-6, f_tol=1e-8, max_epoch=200),
         "max_epoch": dict(x_tol=0.0, f_tol=0.0, max_epoch=7)}
LBFGS_F_TOL = 3e-2


def _close(got, want, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=0)


def _both(name, mode, **kw):
    if name == "lbfgs":
        pj, pt = _problems(lam=0.01, sol=_lbfgs_anchor())
        if kw["f_tol"] > 0:
            kw = dict(kw, f_tol=LBFGS_F_TOL)
    else:
        pj, pt = _problems()
    # L-BFGS takes BB steps (no L, no alpha): a unit step oscillates here
    kw = dict(kw, verbose=0, alpha=None if name == "lbfgs" else 1.0,
              mode=mode)
    sj = scso.iterate(METHODS[name](scso, kernels="xla"), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **kw)
    return sj, s


def _same_histories(s, sj):
    assert s.epochs == sj.epochs
    assert len(s.obj) == len(sj.obj)
    for field in ("obj", "fval", "rel"):
        _close(getattr(s, field).numpy(), getattr(sj, field))


@pytest.mark.parametrize("name", list(METHODS))
def test_timed_matches(name):
    sj, s = _both(name, "timed", **EXITS["converged"])
    _same_histories(s, sj)
    pri = np.asarray(sj.pri_res_norm)[1:]
    np.testing.assert_allclose(s.pri_res_norm[1:].numpy(), pri, rtol=1e-10,
                               atol=1e-12 * np.abs(pri).max())
    assert len(s.times) == len(s.obj)
    assert bool((s.times[1:] >= s.times[:-1]).all())
    assert s.cg_info is None  # as the JAX timed mode
    # unlike the JAX timed mode, the port's returns the carry it resumes
    # from (tests/test_torch_resume.py)
    assert s.state is not None and int(s.state.k) == s.epochs


@pytest.mark.parametrize("exit_", list(EXITS))
@pytest.mark.parametrize("stats_every", [1, 4])
@pytest.mark.parametrize("name", list(METHODS))
def test_fused_matches(name, stats_every, exit_):
    sj, s = _both(name, "fused", stats_every=stats_every, **EXITS[exit_])
    _same_histories(s, sj)
    assert s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-9)
    if exit_ == "max_epoch":
        assert s.epochs == EXITS[exit_]["max_epoch"]
    else:
        assert s.epochs < EXITS[exit_]["max_epoch"]
    assert len(s.times) == len(s.obj) and float(s.times[-1]) > 0


def test_timed_verbose_prints(capsys):
    _, pt = _problems()
    st.iterate(METHODS["ggn"](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
               mode="timed", verbose=2, max_epoch=2, alpha=1.0)
    out = capsys.readouterr().out
    assert out.count("Optimizer = ") == 3 and "Δtime = " in out
    assert "maximum number of epochs (2)" in out


def test_fused_prints_nothing_per_epoch(capsys):
    _, pt = _problems()
    st.iterate(METHODS["ggn"](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
               verbose=2, max_epoch=3, alpha=1.0)
    assert "Optimizer" not in capsys.readouterr().out


def test_unknown_mode_raises():
    _, pt = _problems()
    with pytest.raises(ValueError, match="mode"):
        st.iterate(None, pt, "l1", st.PHuberSmootherL1L2(1.0),
                   mode="jit", verbose=0)


# ---------------------------------------------------------------------------
# CG and Armijo in their device form
# ---------------------------------------------------------------------------


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    H = Q @ Q.T / n + np.diag(rng.uniform(0.1, 2.0, n))
    b = rng.standard_normal(n)
    return H, b, rng.standard_normal(n)


@pytest.mark.parametrize("warm,precond,maxiter", [
    (False, False, 100), (True, False, 100), (True, True, 100),
    (False, True, 5)])
def test_cg_matches(warm, precond, maxiter):
    H, b, x0 = _spd(40, 3)
    d = np.diag(H)
    import jax.numpy as jnp
    jr = jlinalg.cg_solve(lambda v: jnp.asarray(H) @ v, jnp.asarray(b),
                          jnp.asarray(x0) if warm else None, tol=1e-10,
                          maxiter=maxiter,
                          M_inv=(lambda v: v / jnp.asarray(d)) if precond
                          else None)
    t = lambda a: torch.tensor(a)
    r = linalg.cg_solve(lambda v: t(H) @ v, t(b), t(x0) if warm else None,
                        tol=1e-10, maxiter=maxiter,
                        M_inv=(lambda v: v / t(d)) if precond else None)
    assert r.iters.dtype == torch.int32 and r.iters.ndim == 0
    assert int(r.iters) == int(jr.iters)
    assert maxiter > 5 or int(r.iters) == 5
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(jr.x).max()))
    # the residual sits at rounding level once converged
    np.testing.assert_allclose(float(r.res_norm_sq), float(jr.res_norm_sq),
                               rtol=1e-9, atol=1e-12 * float(b @ b))


@pytest.mark.parametrize("scale", [1.0, 1e3, 1e12])
def test_armijo_matches(scale):
    import jax.numpy as jnp
    H, b, x = _spd(20, 4)
    f = lambda v, xp: 0.5 * v @ (xp.asarray(H) @ v) - xp.asarray(b) @ v
    g = lambda v, xp: xp.asarray(H) @ v - xp.asarray(b)
    d = -scale * g(x, np)
    ja = jlinalg.armijo_linesearch(jnp.asarray(x), jnp.asarray(d),
                                   lambda v: f(v, jnp), lambda v: g(v, jnp))
    ta = linalg.armijo_linesearch(torch.tensor(x), torch.tensor(d),
                                  lambda v: f(v, torch), lambda v: g(v, torch))
    assert float(ta) == float(ja)


# ---------------------------------------------------------------------------
# the helper's plain form
# ---------------------------------------------------------------------------


def test_device_if_plain_form():
    ran = []
    graph.device_if(torch.tensor(True), lambda: ran.append(1))
    graph.device_if(torch.tensor(False), lambda: ran.append(2))
    assert ran == [1]
    with pytest.raises(ValueError, match="one bool"):
        graph.device_if(torch.tensor(1), lambda: None)
    with pytest.raises(ValueError, match="not supported"):
        graph.device_if(torch.tensor(True, device="meta"), lambda: None)


def test_device_cond_plain_form():
    one = lambda: (torch.ones(3), torch.tensor(1))
    two = lambda: (torch.full((3,), 2.0), torch.tensor(2))
    assert int(graph.device_cond(torch.tensor(True), one, two)[1]) == 1
    assert int(graph.device_cond(torch.tensor(False), one, two)[1]) == 2


@pytest.mark.parametrize("stop,count,want", [(3, 10, 3), (20, 10, 10),
                                             (0, 10, 0)])
def test_device_loop_plain_form(stop, count, want):
    k = torch.zeros((), dtype=torch.int32)
    live = k < stop

    def body():
        k.add_(1)
        live.copy_(k < stop)

    graph.device_loop(live, count, body)
    assert int(k) == want


@pytest.mark.parametrize("ends_after,count,want", [(1, 100, 4), (5, 100, 12),
                                                   (13, 100, 28),
                                                   (50, 10, 10)])
def test_replays_in_doubling_batches(ends_after, count, want):
    """The host reads ``live`` after 4, then 8, 16, ... replays."""
    n = [0]
    reads = [0]

    def live():
        reads[0] += 1
        return torch.tensor(n[0] < ends_after)

    titerate._replays(lambda: n.__setitem__(0, n[0] + 1), live, count)
    assert n[0] == want
    assert reads[0] == {4: 1, 12: 2, 28: 3, 10: 2}[want]


@pytest.mark.parametrize("stats_every", [1, 4])
def test_rounds_past_the_end_change_nothing(stats_every):
    """A replay after the solve ended skips its body: extra rounds leave
    the carry and the records as they were, and the loop's result is
    `iterate`'s."""
    _, pt = _problems()
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                             kernels="torch")
    opts = titerate.Options(x_tol=1e-6, f_tol=1e-8, max_epoch=200,
                            stats_every=stats_every, verbose=0)
    prob = titerate._effective_L(pt, 1.0)
    sm = st.PHuberSmootherL1L2(1.0)
    loop = titerate._Fused(method, "l1", sm, opts)
    loop.load(prob, sm)
    rounds = 0
    while bool(loop.live()):
        loop.round(prob)
        rounds += 1
    before = [t.clone() for t in titerate._leaves((loop.carry, loop.hist))]
    for _ in range(3):
        loop.round(prob)
    after = titerate._leaves((loop.carry, loop.hist))
    for a, b in zip(before, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    sol = loop.finish(prob, 0.0)
    want = st.iterate(method, pt, "l1", st.PHuberSmootherL1L2(1.0),
                      x_tol=1e-6, f_tol=1e-8, max_epoch=200,
                      stats_every=stats_every, verbose=0, alpha=1.0)
    assert sol.epochs == want.epochs and torch.equal(sol.obj, want.obj)
    assert rounds == -(-sol.epochs // stats_every)


@pytest.mark.parametrize("backend,size,raises", [
    ("nccl", 1, False), ("nccl", 4, False), ("gloo", 1, True)])
def test_which_sharded_solves_capture(monkeypatch, backend, size, raises):
    """A fused solve on a row shard: NCCL ranks capture — several of
    them where the mesh was made under NCCL_GRAPH_MIXING_SUPPORT=0
    (``Mesh.captures``; without it they raise:
    tests/test_torch_sharded_methods.py); over gloo (a host round trip)
    nothing raises any more: on the card the fused program runs
    uncaptured (``_uncaptured``), on the CPU as every CPU solve.
    ``raises`` marks the case that raised (naming A11) before."""
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.parallel.sharding import Mesh

    monkeypatch.setattr(titerate.dist, "get_backend", lambda group: backend)
    _, pt = _problems()
    prob = replace(pt, mesh=Mesh(group=object(), axis_names=("data",),
                                 size=size, rank=0, captures=size > 1))
    titerate._check_capturable(prob)
    on_card = replace(prob, device=torch.device("cuda", 0))
    assert titerate._uncaptured(on_card) == raises
    assert not titerate._uncaptured(prob)
