"""The port's instance-parallel solves against scso_tpu (float64, CPU).

`scso_tpu_torch.parallel.sweep` — λ/μ paths and fleets as one batched
solve (`algorithms.batched`) — against the JAX package's vmapped
`sweep` / `solve_fleet` (on conftest's 8-device CPU mesh, its XLA
products as its sweep forces them), and against the port's own scalar
`iterate`, instance by instance: x to 1e-9 absolute, the final objective
to 1e-10 relative, epochs and records equal (the JAX tests' own
tolerances). Problems: test_parallel.py's ``make_logreg(m=32, n=8)``
(dense Newton through ``hess_fx``) and bench.py's logistic01 problem cut
to 256×32 with B = 8. Methods: ProxNSCORE (dense, and CG with Armijo),
ProxGGNSCORE(solver='cg') (the epoch cache), ProxLQNSCORE on a μ grid.
Then the batch options (``stats_every``, path waves, plans, the 'gl'
two-λ and μ-homotopy waves, the ``x0_grid`` polish), `_resolve_plan`'s
rule at the port's constants, `solve_fleet` / `stack_problems`, one A
read per product (the products of a batched CG iteration counted), the
JAX validation errors, and two gloo ranks splitting the batch axis
(this file re-run as worker processes).
"""

import functools
import importlib
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scso_tpu_torch as st  # noqa: E402
from scso_tpu_torch._src.struct import replace  # noqa: E402
from scso_tpu_torch.models import losses, synthetic  # noqa: E402
from scso_tpu_torch.parallel import (  # noqa: E402
    distributed_init, make_mesh, solve_fleet, stack_problems, sweep)

torch.set_num_threads(1)
LAM4 = np.array([1e-3, 1e-2, 1e-1, 1.0])
LAM8 = np.logspace(-3, -0.5, 8)


def _logreg_data(m=32, n=8, seed=0):
    return synthetic.make_sparse_logreg_data(
        m, n, density=0.3, n_active=4, seed=seed, dtype=np.float64)


def _port_logreg(m=32, n=8, seed=0):
    A, y, x0, _ = _logreg_data(m, n, seed)
    return st.Problem(A, y, x0, losses.logistic_f, 1e-2,
                      grad_fx=losses.logistic_grad,
                      hess_fx=losses.logistic_hess, dtype=torch.float64,
                      device="cpu")


def _rank_main(port, rank, world, out):
    """One rank of the batch axis: the 8-point path over ``world``
    gloo ranks, saved."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    n = distributed_init("gloo", init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank)
    assert n == world
    mesh = make_mesh(axis_names=("batch",))
    res = sweep(st.ProxNSCORE(), _port_logreg(), "l1",
                st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                opts=st.Options(max_epoch=100, verbose=0), mesh=mesh)
    waves = sweep(st.ProxNSCORE(), _port_logreg(), "l1",
                  st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                  opts=st.Options(max_epoch=100, verbose=0), mesh=mesh,
                  path_waves=2)
    np.savez(os.path.join(out, f"rank{rank}.npz"), x=res.x.numpy(),
             obj=res.obj.numpy(), epochs=res.epochs.numpy(),
             wx=waves.x.numpy(), wepochs=waves.epochs.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import scso_tpu as scso  # noqa: E402
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.parallel import solve_fleet as jsolve_fleet  # noqa: E402
from scso_tpu.parallel import stack_problems as jstack  # noqa: E402
from scso_tpu.parallel import sweep as jsweep  # noqa: E402

SWEEP = importlib.import_module("scso_tpu_torch.parallel.sweep")


def _jax_logreg(m=32, n=8, seed=0):
    A, y, x0, _ = _logreg_data(m, n, seed)
    return scso.Problem(A, y, x0, jlosses.logistic_f, 1e-2,
                        grad_fx=jlosses.logistic_grad,
                        hess_fx=jlosses.logistic_hess, dtype=np.float64)


def _log01(pkg):
    """bench.py's family_sweep problem, cut to 256×32, in float64."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        256, 32, density=0.1, n_active=16, seed=7, dtype=np.float64,
        label01=True)
    L = jlosses if pkg is scso else losses
    kw = {} if pkg is scso else dict(device="cpu")
    return pkg.Problem(A, y, x0, L.logistic01_f, 0.01,
                       grad_fx=L.logistic01_grad, hvp_w=L.logistic01_hvp_w,
                       hess_fx=L.logistic01_hess, glm=L.LOGISTIC01_GLM,
                       dtype=np.float64 if pkg is scso else torch.float64,
                       **kw)


def _problem(pkg, name):
    if name == "logreg":
        return _jax_logreg() if pkg is scso else _port_logreg()
    return _log01(pkg)


#: (problem, method, grid, options)
CASES = {
    "newton-logreg": ("logreg", lambda p: p.ProxNSCORE(),
                      dict(lam_grid=LAM4), dict(max_epoch=100)),
    "newton-logreg-stats4": ("logreg", lambda p: p.ProxNSCORE(),
                             dict(lam_grid=LAM4),
                             dict(max_epoch=100, stats_every=4)),
    "newton_cg-logreg": ("logreg",
                         lambda p: p.ProxNSCORE(solver="cg", ss_type=3),
                         dict(lam_grid=LAM4), dict(max_epoch=100)),
    "lbfgs_mu-logreg": ("logreg", lambda p: p.ProxLQNSCORE(),
                        dict(mu_grid=np.array([0.5, 1.0, 2.0])),
                        dict(max_epoch=200)),
    "newton_cg-log01": ("log01",
                        lambda p: p.ProxNSCORE(solver="cg", ss_type=3),
                        dict(lam_grid=LAM8),
                        dict(max_epoch=60, stats_every=4, x_tol=1e-6)),
    "ggn_cg-log01": ("log01", lambda p: p.ProxGGNSCORE(solver="cg"),
                     dict(lam_grid=LAM8), dict(max_epoch=60)),
    "newton-log01": ("log01", lambda p: p.ProxNSCORE(),
                     dict(lam_grid=LAM8), dict(max_epoch=60)),
    "lbfgs_mu-log01": ("log01", lambda p: p.ProxLQNSCORE(),
                       dict(mu_grid=np.array([0.5, 1.0, 2.0, 4.0])),
                       dict(max_epoch=100)),
}


@functools.lru_cache(maxsize=None)
def _jax_case(name, **kw):
    prob, meth, grid, opts = CASES[name]
    return jsweep(meth(scso), _problem(scso, prob), "l1",
                  scso.PHuberSmootherL1L2(1.0),
                  opts=scso.Options(verbose=0, **dict(opts, **kw)), **grid)


def _port_case(name, **kw):
    prob, meth, grid, opts = CASES[name]
    return sweep(meth(st), _problem(st, prob), "l1",
                 st.PHuberSmootherL1L2(1.0),
                 opts=st.Options(verbose=0, **dict(opts, **kw)), **grid)


def _same(res, ref, atol=1e-9, rtol=1e-10, hist=True):
    """A port SweepResult against a JAX one, instance by instance: x, the
    final objective, epochs and records at the JAX tests' tolerances;
    the objective histories at 1e-8 (an intermediate record sits where
    the iterates differ by up to ``atol``; ``hist=False`` leaves them
    out where a transient blows them up to 1e117, as in the fleet)."""
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(res.obj.numpy(), np.asarray(ref.obj),
                               rtol=rtol)
    np.testing.assert_array_equal(res.epochs.numpy(), np.asarray(ref.epochs))
    np.testing.assert_array_equal(res.n_rec.numpy(), np.asarray(ref.n_rec))
    assert tuple(res.obj_hist.shape) == np.asarray(ref.obj_hist).shape
    if hist:
        np.testing.assert_allclose(res.obj_hist.numpy(),
                                   np.asarray(ref.obj_hist), rtol=1e-8,
                                   atol=1e-14)


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_jax_and_the_scalar_solves(name):
    prob_name, meth, grid, opts = CASES[name]
    res = _port_case(name)
    assert res.batch_size == len(next(iter(grid.values())))
    _same(res, _jax_case(name))
    # instance by instance, the port's own scalar solve
    prob = _problem(st, prob_name)
    for i in range(res.batch_size):
        p, sm = prob, st.PHuberSmootherL1L2(1.0)
        if "lam_grid" in grid:
            p = replace(prob, lam=torch.tensor(grid["lam_grid"][i],
                                               dtype=torch.float64))
        else:
            sm = st.PHuberSmootherL1L2(float(grid["mu_grid"][i]))
        ref = st.iterate(meth(st), p, "l1", sm, verbose=0, **opts)
        np.testing.assert_allclose(res.x[i].numpy(), ref.x.numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(float(res.obj[i]), float(ref.obj[-1]),
                                   rtol=1e-10)
        assert int(res.epochs[i]) == ref.epochs
        assert int(res.n_rec[i]) == len(ref.obj)


def test_vmap_safe_scalar_solve_is_the_same():
    """Options.vmap_safe is accepted and leaves a scalar solve's result
    as it is, and matches the JAX package's vmap_safe solve."""
    p = _port_logreg()
    kw = dict(max_epoch=100, verbose=0, stats_every=4)
    sm = st.PHuberSmootherL1L2(1.0)
    for meth in (st.ProxNSCORE(), st.ProxNSCORE(solver="cg", ss_type=3)):
        a = st.iterate(meth, p, "l1", sm, **kw)
        b = st.iterate(meth, p, "l1", sm, vmap_safe=True, **kw)
        assert torch.equal(a.x, b.x) and a.epochs == b.epochs
        assert torch.equal(a.obj, b.obj)
    j = scso.iterate(scso.ProxNSCORE(), _jax_logreg(), "l1",
                     scso.PHuberSmootherL1L2(1.0), vmap_safe=True, **kw)
    b = st.iterate(st.ProxNSCORE(), p, "l1", sm, vmap_safe=True, **kw)
    np.testing.assert_allclose(b.x.numpy(), np.asarray(j.x), atol=1e-9)
    assert b.epochs == j.epochs


@functools.lru_cache(maxsize=None)
def _jax_waves(**kw):
    return jsweep(scso.ProxNSCORE(), _jax_logreg(), "l1",
                  scso.PHuberSmootherL1L2(1.0), lam_grid=np.logspace(-3, 0, 8),
                  opts=scso.Options(max_epoch=300, verbose=0), **kw)


def _port_waves(**kw):
    return sweep(st.ProxNSCORE(), _port_logreg(), "l1",
                 st.PHuberSmootherL1L2(1.0), lam_grid=np.logspace(-3, 0, 8),
                 opts=st.Options(max_epoch=300, verbose=0), **kw)


@pytest.mark.parametrize("waves,cap", [(2, 100), (4, 75), (4, None)])
def test_path_waves_match_jax(waves, cap):
    res = _port_waves(path_waves=waves, wave_max_epoch=cap)
    _same(res, _jax_waves(path_waves=waves, wave_max_epoch=cap))


def test_plans():
    """'throughput' is the cold sweep bit for bit, 'quality' the explicit
    waves (W = 8, the warm cap 300 / 4) bit for bit, and both match
    the JAX package."""
    cold = _port_waves()
    planned = _port_waves(plan="throughput")
    assert torch.equal(planned.x, cold.x)
    assert torch.equal(planned.epochs, cold.epochs)
    _same(planned, _jax_waves())
    q = _port_waves(plan="quality")
    explicit = _port_waves(path_waves=8, wave_max_epoch=75)
    assert torch.equal(q.x, explicit.x) and torch.equal(q.epochs,
                                                        explicit.epochs)
    _same(q, _jax_waves(path_waves=8, wave_max_epoch=75))


def _gl_problems():
    A, y, x_true, x0, groups = synthetic.make_group_lasso_problem(
        90, 30, 6, p_active=0.3, noise_std=0.05, seed=5, dtype=np.float64)
    seg = groups.segment_ids.numpy()
    w = groups.weights.numpy()
    pj = scso.Problem(A, y, x0, jlosses.lsq_f, [1e-8, 1.0],
                      grad_fx=jlosses.lsq_grad, hess_fx=jlosses.lsq_hess,
                      sol=x_true, groups=scso.make_groups(seg, w),
                      dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.lsq_f, [1e-8, 1.0],
                    grad_fx=losses.lsq_grad, hess_fx=losses.lsq_hess,
                    sol=x_true, groups=st.make_groups(seg, w),
                    dtype=torch.float64, device="cpu")
    return pj, pt


@pytest.mark.parametrize("waves", [0, 4])
def test_group_lasso_two_lambda_waves_match_jax(waves):
    """Multi-λ grids sort their waves by the total penalty and come back
    in grid order (test_parallel.py's smooth 'gl' problem)."""
    pj, pt = _gl_problems()
    lam2s = np.logspace(-2, 1, 8)
    grid = np.stack([np.full_like(lam2s, 1e-8), lam2s], axis=1)
    kw = dict(lam_grid=grid, path_waves=waves)
    j = jsweep(scso.ProxNSCORE(use_prox=False), pj, "gl",
               scso.PHuberSmootherGL(1e-2, pj),
               opts=scso.Options(max_epoch=300, verbose=0), **kw)
    r = sweep(st.ProxNSCORE(use_prox=False), pt, "gl",
              st.PHuberSmootherGL(1e-2, pt),
              opts=st.Options(max_epoch=300, verbose=0), **kw)
    _same(r, j)


def test_mu_homotopy_waves_and_polish_match_jax():
    """μ-only waves run smoothest first; an x0_grid polish from the wave
    solutions (and the cap of the warm waves) as the JAX package's."""
    pj, pt = _jax_logreg(), _port_logreg()
    mu = np.array([0.25, 0.5, 1.0, 2.0])
    jo = scso.Options(max_epoch=300, verbose=0)
    to = st.Options(max_epoch=300, verbose=0)
    for kw in (dict(path_waves=2), dict(path_waves=2, wave_max_epoch=100)):
        j = jsweep(scso.ProxNSCORE(use_prox=False), pj, "l1",
                   scso.PHuberSmootherL1L2(1.0), mu_grid=mu, opts=jo, **kw)
        r = sweep(st.ProxNSCORE(use_prox=False), pt, "l1",
                  st.PHuberSmootherL1L2(1.0), mu_grid=mu, opts=to, **kw)
        _same(r, j)
    lam = np.logspace(-3, -1, 8)
    jw = jsweep(scso.ProxNSCORE(use_prox=False), pj, "l1",
                scso.PHuberSmootherL1L2(1.0), lam_grid=lam, opts=jo,
                path_waves=2, wave_max_epoch=30)
    tw = sweep(st.ProxNSCORE(use_prox=False), pt, "l1",
               st.PHuberSmootherL1L2(1.0), lam_grid=lam, opts=to,
               path_waves=2, wave_max_epoch=30)
    _same(tw, jw)
    j = jsweep(scso.ProxNSCORE(use_prox=False), pj, "l1",
               scso.PHuberSmootherL1L2(1.0), lam_grid=lam, opts=jo,
               x0_grid=np.asarray(jw.x))
    r = sweep(st.ProxNSCORE(use_prox=False), pt, "l1",
              st.PHuberSmootherL1L2(1.0), lam_grid=lam, opts=to,
              x0_grid=tw.x)
    _same(r, j)


def test_plan_resolution_rule(monkeypatch):
    """The auto rule at the port's constants, the latency stubbed: a
    wave's estimated compute above 4x the latency takes waves."""
    p = _port_logreg()
    opts = st.Options(max_epoch=300, verbose=0)
    monkeypatch.setattr(SWEEP, "_dispatch_latency_s", lambda dev: 1e-3)
    # 10 epochs x 3 passes x 32·8·8 bytes at 20 GB/s: far under 4 ms
    assert SWEEP._resolve_plan("auto", p, 16, opts, 1) == (0, None)
    monkeypatch.setattr(SWEEP, "_dispatch_latency_s", lambda dev: 1e-9)
    assert SWEEP._resolve_plan("auto", p, 16, opts, 1) == (16, 75)
    # the threshold itself: t_wave = 10 x max(bytes term, flops term)
    m, n, Bw = 32, 8, 1
    t_wave = 10 * max(3 * m * n * 8 / SWEEP._PLAN_BW_BYTES_S["cpu"],
                      3 * 2.0 * m * n * Bw / SWEEP._PLAN_FLOPS_S["cpu"])
    for lat, want in ((t_wave / 4.0 * 1.01, (0, None)),
                      (t_wave / 4.0 * 0.99, (16, 75))):
        monkeypatch.setattr(SWEEP, "_dispatch_latency_s", lambda dev: lat)
        assert SWEEP._resolve_plan("auto", p, 16, opts, 1) == want
    assert SWEEP._PLAN_BW_BYTES_S["cuda"] == 3.35e12
    assert SWEEP._PLAN_FLOPS_S["cuda"] == 67e12
    assert SWEEP._resolve_plan("quality", p, 16, opts, 1) == (16, 75)
    assert SWEEP._resolve_plan("throughput", p, 16, opts, 1) == (0, None)
    assert SWEEP._largest_wave_count(16, ndev=8) == 2
    assert SWEEP._largest_wave_count(7) == 7
    assert SWEEP._largest_wave_count(13, cap=8) == 0
    monkeypatch.undo()
    # measured once a process: the same inputs pick the same plan
    lat = SWEEP._dispatch_latency_s(torch.device("cpu"))
    assert lat > 0
    assert SWEEP._dispatch_latency_s("cpu") == lat
    picks = {SWEEP._resolve_plan("auto", p, 16, opts, 1) for _ in range(3)}
    assert len(picks) == 1


def test_fleet_matches_jax_and_the_scalar_solves():
    seeds = range(4)
    sm = st.PHuberSmootherL1L2(1.0)
    probs = [_port_logreg(seed=s) for s in seeds]
    batched = stack_problems(probs)
    assert tuple(batched.A.shape) == (4, 32, 8)
    assert batched.m_total == 32
    sms = stack_problems([sm] * 4)
    assert tuple(sms.mu.shape) == (4,)
    res = solve_fleet(st.ProxNSCORE(), batched, "l1", sms,
                      opts=st.Options(max_epoch=100, verbose=0))
    jp = [_jax_logreg(seed=s) for s in seeds]
    jsm = scso.PHuberSmootherL1L2(1.0)
    j = jsolve_fleet(scso.ProxNSCORE(), jstack(jp), "l1", jstack([jsm] * 4),
                     opts=scso.Options(max_epoch=100, verbose=0))
    _same(res, j, hist=False)
    for i, p in enumerate(probs):
        ref = st.iterate(st.ProxNSCORE(), p, "l1", sm, max_epoch=100,
                         verbose=0)
        np.testing.assert_allclose(res.x[i].numpy(), ref.x.numpy(), atol=1e-9)
        assert int(res.epochs[i]) == ref.epochs
    # one smoother for all instances: the same result (seed 1's dense
    # Newton runs to NaN at ss_type 1 in both packages and in the
    # scalar solve)
    one = solve_fleet(st.ProxNSCORE(), batched, "l1", sm,
                      opts=st.Options(max_epoch=100, verbose=0))
    torch.testing.assert_close(one.x, res.x, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(one.epochs, res.epochs)
    with pytest.raises(ValueError, match="differs"):
        stack_problems([probs[0], replace(probs[1], f=losses.lsq_f)])


class _Products:
    """The matrix products (aten mm/mv/bmm) below vmap, by shape."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                if any(k in name for k in ("aten.mm", "aten.mv",
                                           "aten.bmm", "aten.addmm")):
                    rec.ops.append((name, [tuple(a.shape) for a in args
                                           if isinstance(a, torch.Tensor)]))
                return func(*args, **(kwargs or {}))

        self.ops, self.mode = [], Mode()


def test_one_read_of_a_a_product(monkeypatch):
    """With a shared A, a CG iteration of the batched solve is ONE call
    of the product helper and two matrix products over all B instances
    (A·Vᵀ and Aᵀ·(W∘Z)), not B of each."""
    steps = importlib.import_module("scso_tpu_torch.algorithms.steps")
    real = steps.normal_matvec_torch
    calls = []

    def counted(A, w, v):
        rec = _Products()
        with rec.mode:
            out = real(A, w, v)
        calls.append(rec.ops)
        return out

    monkeypatch.setattr(steps, "normal_matvec_torch", counted)
    B, kw = 8, dict(max_epoch=3, x_tol=0.0, f_tol=-1.0)
    meth = st.ProxNSCORE(solver="cg", ss_type=3)
    p = _log01(st)
    res = sweep(meth, p, "l1", st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                opts=st.Options(verbose=0, **kw))
    batched_calls = len(calls)
    assert batched_calls > 0
    for ops in calls:
        assert [name for name, _ in ops] == ["aten.mm.default"] * 2, ops
        assert all(B in shape for _, shapes in ops for shape in shapes
                   if shape != tuple(p.A.shape) and shape != tuple(p.A.T.shape))
    # the scalar solves make one call an instance's CG iteration
    calls.clear()
    for i in range(B):
        st.iterate(meth, replace(p, lam=torch.tensor(LAM8[i],
                                                     dtype=torch.float64)),
                   "l1", st.PHuberSmootherL1L2(1.0), verbose=0, **kw)
    assert all([n for n, _ in ops] == ["aten.mv.default"] * 2
               for ops in calls)
    assert len(calls) > batched_calls
    assert int(res.epochs.min()) == 3


def test_validation_errors():
    p = _port_logreg()
    sm = st.PHuberSmootherL1L2(1.0)
    grid = np.logspace(-3, 0, 8)
    with pytest.raises(ValueError, match="provide lam_grid"):
        sweep(st.ProxNSCORE(), p, "l1", sm)
    with pytest.raises(ValueError, match="differ"):
        sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=np.ones(3),
              mu_grid=np.ones(4))
    with pytest.raises(ValueError, match="x0_grid shape"):
        sweep(st.ProxLQNSCORE(), p, "l1", sm, lam_grid=grid[:4],
              x0_grid=np.zeros((4, 9)))
    with pytest.raises(ValueError, match="path_waves"):
        sweep(st.ProxLQNSCORE(), p, "l1", sm, lam_grid=grid[:4],
              x0_grid=np.zeros((4, 8)), path_waves=2)
    with pytest.raises(ValueError, match="path_waves"):
        sweep(st.ProxLQNSCORE(), p, "l1", sm, lam_grid=grid[:4],
              wave_max_epoch=50)
    with pytest.raises(ValueError, match="divide"):
        sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=grid[:6],
              path_waves=4)
    with pytest.raises(ValueError, match="choose"):
        sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=grid, plan="fastest")
    with pytest.raises(ValueError, match="not both"):
        sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=grid, plan="quality",
              path_waves=4)
    with pytest.raises(ValueError, match="chosen by the plan"):
        sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=grid, plan="quality",
              wave_max_epoch=5)
    # mini-batches run inside the batched solve (their parity with the
    # scalar solves: tests/test_torch_mesh2d_batch.py)
    res = sweep(st.ProxNSCORE(), p, "l1", sm, lam_grid=grid,
                opts=st.Options(batch_size=8, max_epoch=3, verbose=0))
    assert tuple(res.x.shape) == (len(grid), 8)
    assert bool(torch.all(res.epochs <= 3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_split_the_batch_axis():
    """Each of two ranks solves its 4 instances; the gathered result is
    every rank's, bit for bit, and the one-process result (x to 1e-12,
    epochs equal), for a cold sweep and for two waves."""
    world = 2
    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(r),
             str(world), out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log}"
        ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                 for r in range(world)]
    for r in ranks[1:]:
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k]), k
    one = sweep(st.ProxNSCORE(), _port_logreg(), "l1",
                st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                opts=st.Options(max_epoch=100, verbose=0))
    np.testing.assert_allclose(ranks[0]["x"], one.x.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(ranks[0]["epochs"], one.epochs.numpy())
    waves = sweep(st.ProxNSCORE(), _port_logreg(), "l1",
                  st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                  opts=st.Options(max_epoch=100, verbose=0), path_waves=2)
    np.testing.assert_allclose(ranks[0]["wx"], waves.x.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(ranks[0]["wepochs"],
                                  waves.epochs.numpy())


def test_indivisible_batch_axis_refused():
    """B must divide the batch axis: one rank can't show it, so a mesh
    of two ranks is given by hand (refused before any collective)."""
    from scso_tpu_torch.parallel import Mesh

    mesh = Mesh(group=None, axis_names=("batch",), size=2, rank=0)
    with pytest.raises(ValueError, match="divisible"):
        sweep(st.ProxNSCORE(), _port_logreg(), "l1",
              st.PHuberSmootherL1L2(1.0), lam_grid=LAM8[:3],
              opts=st.Options(max_epoch=5, verbose=0), mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        sweep(st.ProxNSCORE(), _port_logreg(), "l1",
              st.PHuberSmootherL1L2(1.0), lam_grid=LAM8[:6],
              opts=st.Options(max_epoch=5, verbose=0), mesh=mesh,
              path_waves=2)
    with pytest.raises(ValueError, match="not in the mesh"):
        sweep(st.ProxNSCORE(), _port_logreg(), "l1",
              st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
              opts=st.Options(max_epoch=5, verbose=0), mesh=mesh,
              batch_axis="data")


def test_parallel_exports_the_jax_surface():
    """Every name of scso_tpu.parallel's ``__all__`` is exported by the
    port's parallel package, the instance-parallel ones the callables."""
    import scso_tpu.parallel as jpar
    import scso_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in ("sweep", "solve_fleet", "stack_problems", "SweepResult",
                 "federated_solve", "split_clients", "FederatedResult"):
        assert callable(getattr(tpar, name)), name
