"""Serving and exporting a row-sharded problem (`scso_tpu_torch.utils.
deploy`) over two gloo ranks on the CPU, float64.

One launch of two worker ranks (this file re-run, `tests/_torch_ranks.
py`). Each rank takes its rows of a 64×16 logistic01 problem (and of a
second, fresh one), solved by ``ProxGGNSCORE(solver='cg',
greedy_alpha=False)`` with 'l1' for 30 epochs:
  * ``make_serving_fn`` on the row shard, called with this rank's rows,
    equals the port's sharded ``iterate`` bit for bit (x, epochs, final
    objective), on the template's data and on the fresh data;
  * the artifact rank 0 exports, loaded on both ranks, gives the same
    bits on both data sets;
  * a column shard (`shard_problem_features` over a ('model',) mesh of
    the two ranks) is served with the bits of its ``iterate`` too;
  * a process whose groups do not match the artifact's (none, or a group
    of one rank) refuses to load it;
  * the served x agrees with the JAX package's ``make_serving_fn`` on
    ``shard_problem(prob, make_mesh((2,)))`` over conftest's CPU
    devices: equal epochs, x within 1e-10 absolute, the objective within
    1e-10 relative (tests/test_torch_sharding.py's tolerance).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.parallel import (
    distributed_init, distributed_shutdown, make_mesh, shard_problem,
    shard_problem_features)
from scso_tpu_torch.utils import export_solver, load_solver, make_serving_fn

SHAPE = (64, 16)
SEEDS = {"template": 3, "fresh": 5}
KW = dict(max_epoch=30, verbose=0)
TOL = 1e-10  # the served x against the JAX package's served sharded x
ARTIFACT = "solver.pt2"


def _data(seed):
    return synthetic.make_sparse_logreg_data(
        *SHAPE, density=0.3, n_active=4, seed=seed, dtype=np.float64,
        label01=True)[:3]


def _problem(seed):
    A, y, x0 = _data(seed)
    return st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device="cpu")


METHOD = lambda pkg: pkg.ProxGGNSCORE(solver="cg", greedy_alpha=False)
SM = lambda pkg: pkg.PHuberSmootherL1L2(1.0)


def _rank_main(init, rank, world, workdir):
    """One rank: serve, check nothing, export on rank 0, load, save."""
    from _torch_ranks import result_path

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    assert distributed_init("gloo", init_method=init, world_size=world,
                            rank=rank) == world
    mesh = make_mesh()
    shards = {name: shard_problem(_problem(seed), mesh)
              for name, seed in SEEDS.items()}
    method, sm = METHOD(st), SM(st)
    serve = make_serving_fn(method, shards["template"], "l1", sm,
                            st.Options(**KW))
    res = {}

    def keep(tag, x, k, obj):
        res[f"{tag}.x"] = x.numpy()
        res[f"{tag}.epochs"] = int(k)
        res[f"{tag}.obj"] = float(obj)

    for name, p in shards.items():
        ref = st.iterate(method, p, "l1", sm, **KW)
        keep(f"{name}.iterate", ref.x, ref.epochs, ref.obj[-1])
        keep(f"{name}.served", *serve(p.A, p.y, p.x0))
    cols = shard_problem_features(_problem(SEEDS["template"]),
                                  make_mesh(axis_names=("model",)))
    ref = st.iterate(method, cols, "l1", sm, **KW)
    keep("columns.iterate", ref.x, ref.epochs, ref.obj[-1])
    keep("columns.served", *make_serving_fn(method, cols, "l1", sm,
                                            st.Options(**KW))(
        cols.A, cols.y, cols.x0))
    path = os.path.join(workdir, ARTIFACT)
    if rank == 0:
        blob = export_solver(method, shards["template"], "l1", sm,
                             st.Options(**KW))
        with open(path + ".tmp", "wb") as fh:
            fh.write(blob)
        os.replace(path + ".tmp", path)
    dist.barrier()
    with open(path, "rb") as fh:
        loaded = load_solver(fh.read())
    for name, p in shards.items():
        keep(f"{name}.loaded", *loaded(p.A, p.y, p.x0))
    np.savez(result_path(workdir, rank, world), **res)
    distributed_shutdown()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import jax  # noqa: E402  (the worker ranks above need neither)

import scso_tpu as scso  # noqa: E402
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from scso_tpu.parallel import shard_problem as jshard_problem  # noqa: E402
from scso_tpu.utils import make_serving_fn as jmake_serving_fn  # noqa: E402

from _torch_ranks import file_init, launch, saved  # noqa: E402


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("deploy_sharded")
    launch(__file__, (2,), workdir, timeout=120)
    return saved(workdir, 2), workdir


def _same(got, want, where):
    assert got[f"{where}.epochs"] == want[f"{where}.epochs"]
    assert np.array_equal(got[f"{where}.x"], want[f"{where}.x"])
    assert got[f"{where}.obj"] == want[f"{where}.obj"]


@pytest.mark.parametrize("name,route", [
    (name, route) for name in sorted(SEEDS) for route in ("served", "loaded")
] + [("columns", "served")])
def test_a_sharded_serve_or_artifact_gives_iterates_bits(two_ranks, route,
                                                         name):
    """On each rank the served call, and the artifact rank 0 exported,
    equal the port's sharded ``iterate`` bit for bit; x is the same on
    both ranks. A column shard is served alike."""
    ranks, _ = two_ranks
    for r in ranks:
        got = {f"{name}.iterate.{f}": r[f"{name}.{route}.{f}"]
               for f in ("x", "epochs", "obj")}
        _same(got, r, f"{name}.iterate")
    assert np.array_equal(ranks[0][f"{name}.{route}.x"],
                          ranks[1][f"{name}.{route}.x"])


def test_the_artifact_records_its_groups(two_ranks):
    from scso_tpu_torch.utils.deploy import META_FILE, _extra

    _, workdir = two_ranks
    with open(os.path.join(workdir, ARTIFACT), "rb") as fh:
        meta = json.loads(_extra(fh.read(), META_FILE))
    assert meta["sharded"] == {
        "world_size": 2, "mesh_shape": [2], "axis_names": ["data"],
        "group": {"name": "0", "ranks": [0, 1]},
        "axis_groups": [{"name": "0", "ranks": [0, 1]}]}
    assert meta["batches"] is None


@pytest.mark.parametrize("group", ["none", "one_rank"])
def test_a_loader_whose_groups_differ_raises(two_ranks, tmp_path, group):
    """A process without a group, or with a group of one rank, refuses
    the two-rank artifact: it never solves one rank's rows alone."""
    _, workdir = two_ranks
    with open(os.path.join(workdir, ARTIFACT), "rb") as fh:
        blob = fh.read()
    if group == "none":
        with pytest.raises(ValueError, match="no process group"):
            load_solver(blob)
        return
    distributed_init("gloo", init_method=file_init(tmp_path),
                     world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="exported over 2 ranks"):
            load_solver(blob)
    finally:
        distributed_shutdown()


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_the_served_shard_matches_the_jax_served_shard(two_ranks, name):
    """The JAX package's serving function on its row shard over two CPU
    devices, against the port's served x on rank 0: equal epochs, x to
    1e-10 absolute, the objective to 1e-10 relative."""
    ranks, _ = two_ranks
    A, y, x0 = _data(SEEDS[name])
    jprob = jshard_problem(
        scso.Problem(A, y, x0, jlosses.logistic01_f, 1e-2,
                     grad_fx=jlosses.logistic01_grad,
                     glm=jlosses.LOGISTIC01_GLM, dtype=np.float64),
        jmake_mesh((2,)))
    serve = jax.jit(jmake_serving_fn(METHOD(scso), jprob, "l1", SM(scso),
                                     scso.Options(**KW)))
    x, k, obj = serve(jprob.A, jprob.y, jprob.x0)
    got = ranks[0]
    assert got[f"{name}.served.epochs"] == int(k)
    np.testing.assert_allclose(got[f"{name}.served.x"], np.asarray(x),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got[f"{name}.served.obj"], float(obj),
                               rtol=TOL)
