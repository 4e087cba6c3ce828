"""Feature (column) sharding of the port, against scso_tpu's
`shard_problem_features` solve (float64, CPU).

`scso_tpu_torch.parallel.shard_problem_features` keeps each rank's block
of A's columns (on a 2-D ('data', 'model') mesh, of its rows too); x and
every n-vector stay replicated, and the products of `ops.dense` sum or
gather over the 'model' axis. This file re-runs itself as 2 and 4 worker
ranks over gloo (``if __name__ == "__main__"``): two ranks solve every
case on a ('model',) mesh of two, four ranks on a ('model',) mesh of
four and on a 2×2 ('data', 'model') mesh. The JAX package solves the
same numpy problems feature-sharded over conftest's 8-device CPU mesh
laid out ('data', 'model') (2, 4), its products through XLA. Held to:
  * greedy off (the GLM paths: cached and uncached GGN-CG, Newton-CG,
    L-BFGS, multinomial, a test set): equal epochs and CG iterations,
    the objective history (and the test loss) within 1e-10, x within
    tests/test_parallel.py's 1e-8;
  * the dense Newton solve with user hooks and Newton-CG through them
    (tests/test_parallel.py's feature-sharding problem: logistic f, ∇f
    and ∇²f by hand, its ∇²f·v by autograd through the products' sums),
    and the dense Newton solve by autograd alone: x within 1e-8;
  * every rank holds the same x bit for bit, and a fused solve equals
    the timed one bit for bit;
  * mini-batches (each rank gathers its columns of a batch's rows) and
    a λ sweep (one batched solve): the port's unsharded solves, x within
    1e-10;
  * a hook that uses A other than through `ops.dense` raises the same
    ValueError on every rank, naming the contract.
"""

import os
import socket
import subprocess
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
    distributed_init, make_mesh, shard_problem, shard_problem_features,
    sweep)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=30, verbose=0, alpha=1.0)
GGN = dict(solver="cg", greedy_alpha=False)


def _glm(m, n, seed, label01=True):
    return synthetic.make_sparse_logreg_data(
        m, n, density=0.1, n_active=8, seed=seed, dtype=np.float64,
        label01=label01)[:3]


def problems(pkg, L, dtype, **dev):
    """name → problem, built alike by both packages."""
    P = lambda *a, **k: pkg.Problem(*a, dtype=dtype, **dev, **k)
    glm = lambda data, lam, **k: P(*data, L.logistic01_f, lam,
                                   grad_fx=L.logistic01_grad,
                                   glm=L.LOGISTIC01_GLM, **k)
    At, yt = _glm(64, 64, 9)[:2]
    # tests/test_parallel.py::make_logreg(m=64, n=16): ±1 labels
    A, y, x0 = synthetic.make_sparse_logreg_data(
        64, 16, density=0.3, n_active=4, seed=0, dtype=np.float64)[:3]
    Am, Ym, xm = synthetic.make_multinomial_data(128, 16, 3, seed=1,
                                                 dtype=np.float64)[:3]
    return {
        "glm": glm(_glm(256, 64, 7), 1e-2),
        "newton": glm(_glm(256, 64, 11), 0.1),
        "test": glm(_glm(256, 64, 7), 1e-2, Atest=At, ytest=yt),
        "hooks": P(A, y, x0, L.logistic_f, 1e-2, grad_fx=L.logistic_grad,
                   hess_fx=L.logistic_hess),
        "autograd": P(A, y, x0, L.logistic_f, 1e-2),
        "mglm": P(Am, Ym, xm, L.multinom_f, 0.05, mglm=L.multinom_mglm(3)),
        # tests/test_torch_sharded_methods.py's mini-batch problem
        "batch": glm(synthetic.make_sparse_logreg_data(
            400, 16, density=0.3, n_active=5, seed=5, dtype=np.float64,
            label01=True)[:3], 0.05),
    }


#: name → (problem, method class, method fields, iterate kwargs, gate)
CASES = {
    "cached": ("glm", "ProxGGNSCORE", GGN, KW, "traj"),
    "uncached": ("glm", "ProxGGNSCORE", dict(GGN, epoch_cache=False), KW,
                 "traj"),
    "newton_cg": ("newton", "ProxNSCORE", GGN, KW, "traj"),
    "lbfgs": ("glm", "ProxLQNSCORE", {}, dict(KW, alpha=None), "traj"),
    "mglm": ("mglm", "ProxGGNSCORE", GGN, KW, "traj"),
    "test_set": ("test", "ProxGGNSCORE", dict(GGN, epoch_cache=False), KW,
                 "traj"),
    "newton_dense_hooks": ("hooks", "ProxNSCORE", {}, dict(verbose=0),
                           "dense"),
    "newton_cg_hooks": ("hooks", "ProxNSCORE",
                        dict(solver="cg", cg_tol=1e-12), dict(verbose=0),
                        "dense"),
    "newton_dense_autograd": ("autograd", "ProxNSCORE", {},
                              dict(verbose=0), "dense"),
    # mini-batches: held to the port's unsharded solve (numpy
    # permutations, as its row shard's, held to the JAX package's timed
    # mode in tests/test_torch_sharded_methods.py)
    "batches": ("batch", "ProxGGNSCORE", dict(solver="cg"),
                dict(max_epoch=6, x_tol=1e-12, f_tol=1e-12, verbose=0,
                     rng_seed=3, batch_size=96), "port"),
}
#: a λ sweep (one batched solve) on each feature shard
SWEEP_LAMS = np.logspace(-3, -1, 4)
#: the cases also solved in timed mode (bitwise the fused solve)
TIMED = ("cached", "uncached", "lbfgs", "mglm", "batches")
#: meshes a world solves on: name → (shape, axis names, rows sharded)
MESHES = {2: {"model2": ((2,), ("model",), False)},
          4: {"model4": ((4,), ("model",), False),
              "data_model": ((2, 2), ("data", "model"), True)}}
WORLDS = tuple(MESHES)


def _bad_f(A, y, x):
    return torch.mean(torch.log1p(torch.exp(-y * (A @ x))))


def _rank_main(port, rank, world, workdir):
    """One rank: every case on each mesh of its world; save."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    assert distributed_init("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank) == world
    sm = lambda: st.PHuberSmootherL1L2(1.0)
    res = {}
    for mname, (shape, names, rows) in MESHES[world].items():
        mesh = make_mesh(shape, names)
        place = lambda p: shard_problem_features(
            shard_problem(p, mesh) if rows else p, mesh)
        probs = {k: place(p) for k, p in problems(
            st, losses, torch.float64, device="cpu").items()}
        for name, (pk, cls, fields, kw, _) in CASES.items():
            method = getattr(st, cls)(**fields)
            runs = {"": "fused", ".timed": "timed"} if name in TIMED else {
                "": "fused"}
            for tag, mode in runs.items():
                s = st.iterate(method, probs[pk], "l1", sm(),
                               **dict(kw, mode=mode))
                key = f"{mname}.{name}{tag}"
                res[f"{key}.x"] = s.x.numpy()
                res[f"{key}.obj"] = s.obj.numpy()
                res[f"{key}.fvaltest"] = s.fvaltest.numpy()
                res[f"{key}.epochs"] = s.epochs
                res[f"{key}.cg"] = (s.cg_info or {}).get("total_cg_iters", 0)
        sw = sweep(st.ProxGGNSCORE(solver="cg"), probs["glm"], "l1", sm(),
                   lam_grid=SWEEP_LAMS, opts=st.Options(max_epoch=40,
                                                         verbose=0))
        res[f"{mname}.sweep.x"] = sw.x.numpy()
        res[f"{mname}.sweep.epochs"] = sw.epochs.numpy()
        bad = replace(probs["hooks"], f=_bad_f, grad_fx=None)
        try:
            st.iterate(st.ProxLQNSCORE(), bad, "l1", sm(), max_epoch=2,
                       verbose=0)
            res[f"{mname}.contract"] = "no error"
        except ValueError as e:
            res[f"{mname}.contract"] = str(e)
        # the ranks still agree after the refusal: one more collective
        t = torch.ones(1)
        dist.all_reduce(t)
        res[f"{mname}.after"] = t.numpy()
    np.savez(os.path.join(workdir, f"rank{rank}_of{world}.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import scso_tpu as scso  # noqa: E402  (the worker ranks above need neither)
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from scso_tpu.parallel import shard_problem as jshard_problem  # noqa: E402
from scso_tpu.parallel import (  # noqa: E402
    shard_problem_features as jshard_features)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(worlds, workdir, timeout=300):
    """Run each world's worker ranks of this file, all at once; their
    saved results, by world."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {}
    for world in worlds:
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(r),
             str(world), workdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
            for r in range(world)]
    outs = {}
    try:
        for world, ps in procs.items():
            outs[world] = [p.communicate(timeout=timeout)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for world, ps in procs.items():
        for r, (p, out) in enumerate(zip(ps, outs[world])):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    return {world: [dict(np.load(os.path.join(
        workdir, f"rank{r}_of{world}.npz"))) for r in range(world)]
        for world in worlds}


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as workdir:
        yield _launch(WORLDS, workdir)


_JAX = {}


def _jax_solve(name):
    """The JAX package's feature-sharded solve of a case on the
    ('data', 'model') (2, 4) CPU mesh (cached a module)."""
    if name not in _JAX:
        pk, cls, fields, kw, _ = CASES[name]
        prob = problems(scso, jlosses, np.float64)[pk]
        mesh = jmake_mesh((2, 4), ("data", "model"))
        sp = jshard_features(jshard_problem(prob, mesh), mesh)
        method = getattr(scso, cls)(kernels="xla", **fields)
        _JAX[name] = scso.iterate(method, sp, "l1",
                                  scso.PHuberSmootherL1L2(1.0), **kw)
    return _JAX[name]


def _mesh_ids():
    return [(world, m) for world, ms in MESHES.items() for m in ms]


@pytest.mark.parametrize("world,mesh", _mesh_ids())
@pytest.mark.parametrize("name", [k for k in CASES
                                  if CASES[k][-1] != "port"])
def test_feature_sharded_solve_matches_jax(ranks, world, mesh, name):
    got = ranks[world]
    key = f"{mesh}.{name}"
    for r in got[1:]:
        assert np.array_equal(r[f"{key}.x"], got[0][f"{key}.x"]), key
    r = got[0]
    sj = _jax_solve(name)
    x = r[f"{key}.x"]
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(r[f"{key}.obj"]))
    np.testing.assert_allclose(x, np.asarray(sj.x), rtol=0, atol=1e-8)
    if CASES[name][-1] == "dense":
        assert int(r[f"{key}.epochs"]) == sj.epochs
        return
    assert int(r[f"{key}.epochs"]) == sj.epochs
    if sj.cg_info is not None:
        assert int(r[f"{key}.cg"]) == sj.cg_info["total_cg_iters"]
    np.testing.assert_allclose(r[f"{key}.obj"], np.asarray(sj.obj),
                               rtol=1e-10)
    if sj.fvaltest is not None and len(sj.fvaltest):
        np.testing.assert_allclose(r[f"{key}.fvaltest"],
                                   np.asarray(sj.fvaltest), rtol=1e-10)


@pytest.mark.parametrize("world,mesh", _mesh_ids())
def test_mini_batches_on_a_feature_shard(ranks, world, mesh):
    """Each rank gathers its columns of every batch's rows (on the 2-D
    mesh its rows of them, padded): the port's unsharded solve."""
    got = ranks[world]
    key = f"{mesh}.batches"
    for r in got[1:]:
        assert np.array_equal(r[f"{key}.x"], got[0][f"{key}.x"]), key
    pk, cls, fields, kw, _ = CASES["batches"]
    want = st.iterate(getattr(st, cls)(**fields), problems(
        st, losses, torch.float64, device="cpu")[pk], "l1",
        st.PHuberSmootherL1L2(1.0), **kw)
    r = got[0]
    assert int(r[f"{key}.epochs"]) == want.epochs
    np.testing.assert_allclose(r[f"{key}.obj"], want.obj.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(r[f"{key}.x"], want.x.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("world,mesh", _mesh_ids())
def test_sweep_on_a_feature_shard(ranks, world, mesh):
    """A batched solve on a feature shard: its products' collectives
    batch under vmap (one a product for every instance); the port's
    unsharded sweep (held to the JAX package in test_torch_sweep.py)."""
    got = ranks[world]
    for r in got[1:]:
        assert np.array_equal(r[f"{mesh}.sweep.x"], got[0][f"{mesh}.sweep.x"])
    want = sweep(st.ProxGGNSCORE(solver="cg"), problems(
        st, losses, torch.float64, device="cpu")["glm"], "l1",
        st.PHuberSmootherL1L2(1.0), lam_grid=SWEEP_LAMS,
        opts=st.Options(max_epoch=40, verbose=0))
    np.testing.assert_array_equal(got[0][f"{mesh}.sweep.epochs"],
                                  want.epochs.numpy())
    np.testing.assert_allclose(got[0][f"{mesh}.sweep.x"], want.x.numpy(),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("world,mesh", _mesh_ids())
@pytest.mark.parametrize("name", TIMED)
def test_fused_is_the_timed_solve(ranks, world, mesh, name):
    r = ranks[world][0]
    key = f"{mesh}.{name}"
    assert int(r[f"{key}.timed.epochs"]) == int(r[f"{key}.epochs"])
    assert np.array_equal(r[f"{key}.timed.x"], r[f"{key}.x"])
    assert np.array_equal(r[f"{key}.timed.obj"], r[f"{key}.obj"])


@pytest.mark.parametrize("world,mesh", _mesh_ids())
def test_contract_breach_fails_alike_on_every_rank(ranks, world, mesh):
    msgs = [str(r[f"{mesh}.contract"]) for r in ranks[world]]
    assert len(set(msgs)) == 1, msgs
    assert "ops.dense" in msgs[0] and "column-sharded" in msgs[0]
    for r in ranks[world]:
        assert float(r[f"{mesh}.after"][0]) == world


def test_layout_and_refusals():
    """The block a rank keeps, and what shard_problem_features
    refuses (one rank: the shapes only)."""
    from scso_tpu_torch.ops.dense import ColShard

    prob = problems(st, losses, torch.float64, device="cpu")["glm"]
    A = ColShard(prob.A, mesh=None, axis="model", group=None, rank=1,
                 size=4)
    assert tuple(A.shape) == (256, 64) and A.lo == 16 and A.width == 16
    assert torch.equal(A.block, prob.A[:, 16:32])
    rows = A[3:7]
    assert tuple(rows.shape) == (4, 64) and torch.equal(
        rows.block, prob.A[3:7, 16:32])
    for use in (lambda: A @ prob.x0, lambda: A.T, lambda: torch.sum(A),
                lambda: A * 2.0):
        with pytest.raises(ValueError, match="ops.dense"):
            use()
    # n must divide the model axis (checked before any collective)
    from scso_tpu_torch.parallel import Mesh

    four = Mesh(group=object(), axis_names=("model",), size=4, rank=0)
    with pytest.raises(ValueError, match="not divisible"):
        shard_problem_features(st.Problem(
            np.ones((8, 6)), np.ones(8), np.zeros(6), losses.lsq_f, 0.1,
            dtype=torch.float64, device="cpu"), four)
    with pytest.raises(ValueError, match="already sharded"):
        shard_problem_features(replace(prob, A=A), four)
