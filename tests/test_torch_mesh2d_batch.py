"""Meshes of several axes and batched solves of row-sharded problems,
against scso_tpu (float64, CPU).

This file re-runs itself as worker ranks over gloo (``if __name__ ==
"__main__"``). Four ranks build a 2×2 ('batch', 'data') mesh, a 1×4 one
and a ('data',) mesh of four: the axis groups (a sum over each), and
`replicate`; then on the 2×2 mesh (the problem's rows over 'data', the
instances over 'batch') and on the ('data',) mesh (the batch not split)
a λ sweep in the throughput and the quality plan, path waves, a Newton
sweep with Armijo (a row sum a trial inside the masked loop), a μ sweep
of L-BFGS, a fleet of stacked row shards and federated rounds of a
row-sharded problem, held to the JAX package's sweep, fleet and rounds
on conftest's 8-device CPU mesh (the sweeps row-sharded on its
('batch', 'data') (2, 4) layout, or ('data',) 8 where the batch is not
split) at tests/test_torch_sweep.py's and test_torch_federated.py's
tolerances: equal epochs, x within 1e-9 (greedy off), objectives within
1e-10. Mini-batches inside a batched solve (one seed for every
instance) are held to the port's own scalar row-sharded solve of each
instance, which tests/test_torch_sharded_methods.py holds to the JAX
package: equal epochs, x within 1e-9. Every rank holds the same result
bit for bit.

Two ranks show C11 repaired: with `_dispatch_latency_s` patched to
disagree (0 on one rank, 10 s on the other), plan='auto' is agreed over
the mesh and both finish with the same result; on the parent the ranks
chose different plans and their gathers no longer matched (gloo:
"Is there a distributed collective mismatch in your code?").
"""

import importlib
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu_torch as st
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.parallel import (
    distributed_init, federated_solve, make_mesh, replicate, shard_problem,
    solve_fleet, stack_problems, sweep)

LAM8 = np.logspace(-3, -1, 8)
BATCH_LAMS = np.array([0.02, 0.05, 0.1, 0.2])
BATCH_KW = dict(max_epoch=6, x_tol=1e-12, f_tol=1e-12, verbose=0,
                batch_size=96)
FED_KW = dict(n_clients=4, comm_rounds=3, local_epochs=4)


def log01(pkg, L, dtype, m=256, n=32, seed=7, lam=0.01, **dev):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        m, n, density=0.1, n_active=16, seed=seed, dtype=np.float64,
        label01=True)
    return pkg.Problem(A, y, x0, L.logistic01_f, lam,
                       grad_fx=L.logistic01_grad, hvp_w=L.logistic01_hvp_w,
                       glm=L.LOGISTIC01_GLM, dtype=dtype, **dev)


def batch_problem(pkg, L, dtype, lam=0.05, **dev):
    """tests/test_torch_sharded_methods.py's mini-batch problem."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        400, 16, density=0.3, n_active=5, seed=5, dtype=np.float64,
        label01=True)
    return pkg.Problem(A, y, x0, L.logistic01_f, lam,
                       grad_fx=L.logistic01_grad, glm=L.LOGISTIC01_GLM,
                       dtype=dtype, **dev)


def fed_problem(pkg, L, dtype, **dev):
    """tests/test_torch_federated.py's problem."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 24, density=0.25, n_active=6, seed=11, dtype=np.float64)
    return pkg.Problem(A, y, x0, L.logistic_f, 1e-2, grad_fx=L.logistic_grad,
                       hess_fx=L.logistic_hess, dtype=dtype, **dev)


#: name → (method, sweep kwargs, options)
SWEEPS = {
    "throughput": (lambda p: p.ProxGGNSCORE(solver="cg"),
                   dict(lam_grid=LAM8, plan="throughput"),
                   dict(max_epoch=60)),
    "quality": (lambda p: p.ProxGGNSCORE(solver="cg"),
                dict(lam_grid=LAM8, plan="quality"), dict(max_epoch=60)),
    "waves": (lambda p: p.ProxGGNSCORE(solver="cg"),
              dict(lam_grid=LAM8, path_waves=2), dict(max_epoch=60)),
    "newton_armijo": (lambda p: p.ProxNSCORE(solver="cg", ss_type=3),
                      dict(lam_grid=LAM8, plan="throughput"),
                      dict(max_epoch=60, stats_every=4, x_tol=1e-6)),
    "lbfgs_mu": (lambda p: p.ProxLQNSCORE(),
                 dict(mu_grid=np.array([0.5, 1.0, 2.0, 4.0])),
                 dict(max_epoch=100)),
}
BATCH_METHODS = {
    "ggn": lambda p: p.ProxGGNSCORE(solver="cg"),
    "newton": lambda p: p.ProxNSCORE(solver="cg"),
    "lbfgs": lambda p: p.ProxLQNSCORE(),
}
#: the meshes of a four-rank run: name → (shape, axis names, the sweep's
#: mesh is the problem's)
MESHES = {"grid": ((2, 2), ("batch", "data"), True),
          "data4": ((4,), ("data",), False)}
#: the worker runs: four ranks, a launch for each of their meshes, and
#: two (C11)
PARTS4 = (*MESHES, "one4")
JOBS = tuple((4, part) for part in PARTS4) + (2,)


def _save(res, key, r, fields=("x", "obj", "epochs")):
    for f in fields:
        res[f"{key}.{f}"] = torch.as_tensor(getattr(r, f)).numpy()


def _four(res, rank, part):
    """The four-rank run on the mesh ``part`` (of MESHES, or 'one4')."""
    sm = lambda: st.PHuberSmootherL1L2(1.0)
    dt = torch.float64
    for mname, (shape, names, _) in dict(
            MESHES, one4=((1, 4), ("batch", "data"), True)).items():
        if mname != part:
            continue
        mesh = make_mesh(shape, names)
        res[f"{mname}.coords"] = np.array(mesh.coords)
        for ax in names:
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=mesh.axis_group(ax))
            res[f"{mname}.sum_{ax}"] = t.numpy()
        rep = replicate({"a": torch.full((3,), float(rank)),
                         "b": (7, torch.arange(2) + rank)}, mesh)
        res[f"{mname}.rep_a"] = rep["a"].numpy()
        res[f"{mname}.rep_b"] = rep["b"][1].numpy()
        try:  # shapes that differ between ranks: refused on every rank
            replicate({"a": torch.zeros(1 + rank)}, mesh)
            res[f"{mname}.rep_refused"] = "no error"
        except ValueError as e:
            res[f"{mname}.rep_refused"] = str(e)
        if mname == "one4":
            continue
        bmesh = mesh if "batch" in names else None
        sp = shard_problem(log01(st, losses, dt, device="cpu"), mesh)
        for name, (meth, grid, opts) in SWEEPS.items():
            r = sweep(meth(st), sp, "l1", sm(), opts=st.Options(
                verbose=0, **opts), mesh=bmesh, **grid)
            _save(res, f"{mname}.{name}", r)
        probs = [shard_problem(log01(st, losses, dt, seed=s, device="cpu"),
                               mesh) for s in range(4)]
        r = solve_fleet(st.ProxGGNSCORE(solver="cg"), stack_problems(probs),
                        "l1", sm(), opts=st.Options(max_epoch=60, verbose=0),
                        mesh=bmesh)
        _save(res, f"{mname}.fleet", r)
        f = federated_solve(st.ProxNSCORE(solver="dense", ss_type=3),
                            shard_problem(fed_problem(st, losses, dt,
                                                      device="cpu"), mesh),
                            "l1", sm(), mesh=bmesh, **FED_KW)
        _save(res, f"{mname}.federated", f, ("x", "obj", "client_epochs"))
        bp = shard_problem(batch_problem(st, losses, dt, device="cpu"), mesh)
        for name, meth in BATCH_METHODS.items():
            r = sweep(meth(st), bp, "l1", sm(), lam_grid=BATCH_LAMS,
                      opts=st.Options(**BATCH_KW), mesh=bmesh, rng_seed=3)
            _save(res, f"{mname}.batches_{name}", r)
            for i, lam in enumerate(BATCH_LAMS):
                s = st.iterate(meth(st), replace(bp, lam=torch.tensor(
                    lam, dtype=dt)), "l1", sm(), rng_seed=3, **BATCH_KW)
                res[f"{mname}.batches_{name}.scalar{i}.x"] = s.x.numpy()
                res[f"{mname}.batches_{name}.scalar{i}.epochs"] = s.epochs


def _two(res, rank):
    """C11: the two ranks' launch latencies disagree; plan='auto'."""
    swp = importlib.import_module("scso_tpu_torch.parallel.sweep")
    lat = 0.0 if rank == 0 else 10.0
    swp._dispatch_latency_s = lambda device: lat
    prob = fed_problem(st, losses, torch.float64, device="cpu")
    r = sweep(st.ProxNSCORE(), prob, "l1", st.PHuberSmootherL1L2(1.0),
              lam_grid=LAM8, opts=st.Options(max_epoch=50, verbose=0),
              mesh=make_mesh(axis_names=("batch",)), plan="auto")
    _save(res, "c11", r)


def _rank_main(init, rank, world, workdir, part=None):
    from _torch_ranks import result_path

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    assert distributed_init("gloo", init_method=init,
                            world_size=world, rank=rank) == world
    res = {}
    if world == 4:
        _four(res, rank, part)
    else:
        _two(res, rank)
    np.savez(result_path(workdir, rank, world, part), **res)
    dist.destroy_process_group()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import scso_tpu as scso  # noqa: E402  (the worker ranks above need neither)
from _torch_ranks import launch, saved  # noqa: E402
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.parallel import federated_solve as jfederated  # noqa: E402
from scso_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from scso_tpu.parallel import shard_problem as jshard_problem  # noqa: E402
from scso_tpu.parallel import solve_fleet as jsolve_fleet  # noqa: E402
from scso_tpu.parallel import stack_problems as jstack  # noqa: E402
from scso_tpu.parallel import sweep as jsweep  # noqa: E402


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as workdir:
        launch(__file__, JOBS, workdir)
        yield {4: saved(workdir, 4, PARTS4), 2: saved(workdir, 2)}


def _every_rank_alike(got, prefix):
    for r in got[1:]:
        for k in got[0]:
            if k.startswith(prefix + "."):
                assert np.array_equal(r[k], got[0][k]), k


_JAX = {}


def _jax(key, make):
    if key not in _JAX:
        _JAX[key] = make()
    return _JAX[key]


def _jax_sweep(name, mesh):
    """The JAX package's sweep of a case, the problem row-sharded on
    conftest's 8 devices: ('batch', 'data') (2, 4) with the batch split
    for the 2×2 mesh, ('data',) 8 for the ('data',) one. Only the
    quality plan depends on the layout (its wave count on the batch
    axis's size)."""
    split = MESHES[mesh][2]
    key = (name, split if name == "quality" else True)

    def make():
        meth, grid, opts = SWEEPS[name]
        p = log01(scso, jlosses, np.float64)
        if key[1]:
            jm = jmake_mesh((2, 4), ("batch", "data"))
            kw = dict(mesh=jm, batch_axis="batch")
        else:
            jm, kw = jmake_mesh(), {}
        return jsweep(meth(scso), jshard_problem(p, jm), "l1",
                      scso.PHuberSmootherL1L2(1.0),
                      opts=scso.Options(verbose=0, **opts), **grid, **kw)

    return _jax(key, make)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(SWEEPS))
def test_row_sharded_sweep_matches_jax(ranks, mesh, name):
    got = ranks[4]
    _every_rank_alike(got, f"{mesh}.{name}")
    r = got[0]
    ref = _jax_sweep(name, mesh)
    key = f"{mesh}.{name}"
    np.testing.assert_array_equal(r[f"{key}.epochs"], np.asarray(ref.epochs))
    np.testing.assert_allclose(r[f"{key}.x"], np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(r[f"{key}.obj"], np.asarray(ref.obj),
                               rtol=1e-10)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fleet_of_row_shards_matches_jax(ranks, mesh):
    got = ranks[4]
    _every_rank_alike(got, f"{mesh}.fleet")

    def make():
        probs = [log01(scso, jlosses, np.float64, seed=s) for s in range(4)]
        sm = scso.PHuberSmootherL1L2(1.0)
        return jsolve_fleet(scso.ProxGGNSCORE(solver="cg"), jstack(probs),
                            "l1", jstack([sm] * 4),
                            opts=scso.Options(max_epoch=60, verbose=0),
                            mesh=jmake_mesh((2, 4), ("batch", "data")))

    ref = _jax("fleet", make)
    r = got[0]
    np.testing.assert_array_equal(r[f"{mesh}.fleet.epochs"],
                                  np.asarray(ref.epochs))
    np.testing.assert_allclose(r[f"{mesh}.fleet.x"], np.asarray(ref.x),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(r[f"{mesh}.fleet.obj"], np.asarray(ref.obj),
                               rtol=1e-10)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_federated_rounds_of_a_row_shard_match_jax(ranks, mesh):
    got = ranks[4]
    _every_rank_alike(got, f"{mesh}.federated")
    ref = _jax("federated", lambda: jfederated(
        scso.ProxNSCORE(solver="dense", ss_type=3),
        fed_problem(scso, jlosses, np.float64), "l1",
        scso.PHuberSmootherL1L2(1.0), **FED_KW))
    r = got[0]
    np.testing.assert_allclose(r[f"{mesh}.federated.obj"],
                               np.asarray(ref.obj), rtol=1e-10)
    np.testing.assert_array_equal(r[f"{mesh}.federated.client_epochs"],
                                  np.asarray(ref.client_epochs))
    np.testing.assert_allclose(r[f"{mesh}.federated.x"], np.asarray(ref.x),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(BATCH_METHODS))
def test_mini_batches_in_a_batched_solve(ranks, mesh, name):
    """Every instance of a batched mini-batch solve on a row shard
    against the port's scalar row-sharded solve of it (one seed: the
    same batches)."""
    got = ranks[4]
    key = f"{mesh}.batches_{name}"
    _every_rank_alike(got, key)
    r = got[0]
    assert np.all(np.isfinite(r[f"{key}.x"]))
    for i in range(len(BATCH_LAMS)):
        assert int(r[f"{key}.epochs"][i]) == int(
            r[f"{key}.scalar{i}.epochs"])
        np.testing.assert_allclose(r[f"{key}.x"][i], r[f"{key}.scalar{i}.x"],
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("mesh", ["grid", "one4", "data4"])
def test_mesh_axes_and_replicate(ranks, mesh):
    """Ranks laid out rank-major as np.arange(4).reshape(shape); each axis
    group sums the ranks of its line; `replicate` gives every rank the
    first rank's tensors and keeps the other leaves."""
    shape, names = {"grid": ((2, 2), ("batch", "data")),
                    "one4": ((1, 4), ("batch", "data")),
                    "data4": ((4,), ("data",))}[mesh]
    grid = np.arange(4).reshape(shape)
    for rank, r in enumerate(ranks[4]):
        coords = tuple(int(c) for c in np.unravel_index(rank, shape))
        assert tuple(r[f"{mesh}.coords"]) == coords
        for a, ax in enumerate(names):
            line = np.moveaxis(grid, a, -1)[tuple(
                c for i, c in enumerate(coords) if i != a)]
            assert float(r[f"{mesh}.sum_{ax}"][0]) == float(line.sum())
        assert np.array_equal(r[f"{mesh}.rep_a"], np.zeros(3))
        assert np.array_equal(r[f"{mesh}.rep_b"], np.arange(2))
        assert "other shapes" in str(r[f"{mesh}.rep_refused"])


def test_ranks_that_measure_different_latencies_agree_on_the_plan(ranks):
    """C11: both ranks finish and hold the same result, the plan the
    larger latency picks (no waves: the throughput plan's result)."""
    got = ranks[2]
    _every_rank_alike(got, "c11")
    one = sweep(st.ProxNSCORE(), fed_problem(st, losses, torch.float64,
                                             device="cpu"),
                "l1", st.PHuberSmootherL1L2(1.0), lam_grid=LAM8,
                opts=st.Options(max_epoch=50, verbose=0), plan="throughput")
    assert np.array_equal(got[0]["c11.epochs"], one.epochs.numpy())
    np.testing.assert_allclose(got[0]["c11.x"], one.x.numpy(), rtol=0,
                               atol=1e-12)
