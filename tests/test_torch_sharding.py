"""The port's row-sharded cached GGN-CG path against scso_tpu.

`scso_tpu_torch.parallel` solves SPMD over torch.distributed (gloo on
the CPU here), one process per rank; the JAX package solves the same
numpy problem row-sharded over conftest's 8-device CPU mesh. float64:
  * K1s's plain version under a one-rank gloo group against
    `fused_normal_matvec_sharded` at 256×128 (rtol 1e-12) and in the
    overlapped form (overlap_chunks=3) at 512×384 (rtol 1e-10), the
    shapes of tests/test_parallel.py;
  * the shard-local pair prep normalized by m_total against the Pallas
    pair kernel in interpret mode with `_glm_kernel_fns(g, m_total)`
    (1e-12), and its sums over the shards against the unsharded prep
    (1e-13);
  * solves with two and four ranks (this file re-run as its own worker
    processes, one per rank) against the JAX sharded kernels='pallas'
    solve of test_torch_slice.py's 512×256 problem: greedy off, the
    trajectory to 1e-10 with equal epochs and CG iterations; greedy on,
    the fixed point to 1e-8 (the accept test turns last-ulp differences,
    such as another order of the sums over ranks, into other
    trajectories). Not test_parallel.py's 64×128 problem: there (m < n,
    λ = 1e-2) CG runs past n iterations every epoch, another order of
    the sums over rows changes the CG counts, and test_parallel.py
    itself holds the JAX sharded solves to each other only at 1e-7;
    comm_overlap_chunks=2 against the plain sharded solve to 1e-9 with
    equal epochs; precision-adaptive CG (the JAX package's bfloat16
    copy of A, each rank holding its rows of it, cg_adaptive=True,
    cg_lp_tol=1e-2, greedy off) against the JAX sharded solve with the
    same copy, the trajectory to 1e-10 with equal epochs and CG
    iterations; tests/_dist_launch.py's data loaded rank by rank with
    `load_problem_rows_sharded` against tests/test_distributed.py's
    single-process solve to 1e-10. Every rank must hold the same x,
    bit for bit;
  * `shard_problem` taking this rank's rows of the copy with A's;
  * the validation of `shard_problem`, `pad_rows` and `make_mesh`, and
    the paths that raised on a shard before every method was ported
    there (L-BFGS, uncached, BB, multinomial, f(x) off the cache)
    running on one rank as unsharded, bit for bit.
"""

import os
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
    distributed_init, load_problem_rows_sharded, make_mesh, pad_rows,
    replicate, save_problem_data, shard_problem, shard_problem_features)

LAM = 1e-2
# (m, n, density, n_active, seed): test_torch_slice.py's parity problem
# and test_parallel.py's comm-overlap problem, with their solve options
TRAJ = (512, 256, 0.05, 8, 7)
OVERLAP = (256, 128, 0.1, 8, 13)
TRAJ_KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0,
               stats_every=4, alpha=1.0)
OVERLAP_KW = dict(max_epoch=30, verbose=0)
# precision-adaptive CG on the TRAJ problem (float64: the EW regime)
LP_METHOD = dict(solver="cg", greedy_alpha=False, cg_adaptive=True,
                 cg_lp_tol=1e-2)
# tests/test_distributed.py's solve of tests/_dist_launch.py's data
DIST_LAM = 0.05
DIST_KW = dict(max_epoch=25, x_tol=1e-12, f_tol=0.0, verbose=0)
DIST_METHOD = dict(solver="cg", cg_tol=1e-10, cg_maxiter=50)


def _data(m, n, density, n_active, seed):
    return synthetic.make_sparse_logreg_data(
        m, n, density=density, n_active=n_active, seed=seed,
        dtype=np.float64, label01=True)[:3]


def _port_problem(spec, lam=LAM):
    A, y, x0 = _data(*spec)
    return st.Problem(A, y, x0, losses.logistic01_f, lam,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device="cpu")


def _solves(mesh, workdir):
    """Every solve of a worker rank: name → Solution."""
    sm = st.PHuberSmootherL1L2(1.0)
    run = lambda method, prob, kw: st.iterate(
        method, shard_problem(prob, mesh), "l1", sm, **kw)
    traj, over = _port_problem(TRAJ), _port_problem(OVERLAP)
    # the JAX package's bfloat16 copy of TRAJ's A, saved as float32
    A_lp = torch.tensor(np.load(os.path.join(workdir, "traj_lp.npy")))
    out = {
        "lp": run(st.ProxGGNSCORE(**LP_METHOD),
                  replace(traj, A_lp=A_lp.to(torch.bfloat16)), TRAJ_KW),
        "greedy_off": run(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                          traj, TRAJ_KW),
        "greedy_on": run(st.ProxGGNSCORE(solver="cg", greedy_alpha=True),
                         traj, TRAJ_KW),
        "timed": run(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                     traj, dict(TRAJ_KW, mode="timed")),
        "overlap_1": run(st.ProxGGNSCORE(solver="cg"), over, OVERLAP_KW),
        "overlap_2": run(st.ProxGGNSCORE(solver="cg", comm_overlap_chunks=2),
                         over, OVERLAP_KW),
    }
    prob = load_problem_rows_sharded(
        os.path.join(workdir, "data"), np.load(os.path.join(workdir,
                                                            "x0.npy")),
        losses.logistic01_f, DIST_LAM, mesh, grad_fx=losses.logistic01_grad,
        glm=losses.LOGISTIC01_GLM, device="cpu")
    assert prob.m_total == 64 and prob.A.shape[0] == 64 // mesh.size
    out["dataio"] = st.iterate(st.ProxGGNSCORE(**DIST_METHOD), prob, "l1",
                               sm, **DIST_KW)
    return out


def _rank_main(init, rank, world, workdir):
    """One rank of a multi-rank run: join the gloo group, solve, save."""
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    n = distributed_init("gloo", init_method=init,
                         world_size=world, rank=rank)
    assert n == world
    res = {}
    for name, s in _solves(make_mesh(), workdir).items():
        res[f"{name}.x"] = s.x.numpy()
        res[f"{name}.obj"] = s.obj.numpy()
        res[f"{name}.epochs"] = s.epochs
        res[f"{name}.cg"] = (s.cg_info or {}).get("total_cg_iters", 0)
    np.savez(os.path.join(workdir, f"rank{rank}_of{world}.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import jax  # noqa: E402  (the worker ranks above need neither)
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import scso_tpu as scso  # noqa: E402
from scso_tpu.algorithms.steps import _glm_kernel_fns  # noqa: E402
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.ops.pallas.glm_prep import _fused_glm_prep_pair  # noqa: E402
from scso_tpu.ops.pallas.matvec import (  # noqa: E402
    fused_normal_matvec_sharded)
from scso_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from scso_tpu.parallel import shard_problem as jshard_problem  # noqa: E402
from scso_tpu_torch.algorithms.iterate import _stats  # noqa: E402
from scso_tpu_torch.ops.cuda.glm_prep import glm_prep_pair  # noqa: E402
from scso_tpu_torch.ops.cuda.matvec import (  # noqa: E402
    normal_matvec_sharded)

from _dist_launch import make_data  # noqa: E402
from _torch_ranks import file_init, launch, saved  # noqa: E402

torch.set_num_threads(1)
_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def dist_data():
    with tempfile.TemporaryDirectory() as workdir:
        A, y, x0 = make_data(workdir)
        np.save(os.path.join(workdir, "traj_lp.npy"),
                np.asarray(_jax_problem(TRAJ, lp=True).A_lp, np.float32))
        yield workdir, (A, y, x0)


@pytest.fixture(scope="module")
def two_ranks(dist_data):
    launch(__file__, (2,), dist_data[0], timeout=120)
    return saved(dist_data[0], 2)


@pytest.fixture(scope="module")
def four_ranks(dist_data):
    launch(__file__, (4,), dist_data[0], timeout=120)
    return saved(dist_data[0], 4)


def _jax_problem(spec, lp=False):
    A, y, x0 = _data(*spec)
    prob = scso.Problem(A, y, x0, jlosses.logistic01_f, LAM,
                        grad_fx=jlosses.logistic01_grad,
                        glm=jlosses.LOGISTIC01_GLM, dtype=np.float64)
    return scso.with_lp_copy(prob) if lp else prob


def _jax_solve(spec, greedy, kw, lp=False, **method_kw):
    return scso.iterate(
        scso.ProxGGNSCORE(solver="cg", kernels="pallas",
                          greedy_alpha=greedy, **method_kw),
        jshard_problem(_jax_problem(spec, lp), jmake_mesh()), "l1",
        scso.PHuberSmootherL1L2(1.0), **kw)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, and its mesh."""
    distributed_init("gloo", init_method=file_init(tmp_path),
                     world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("m,n,chunks,rtol", [(256, 128, 1, 1e-12),
                                             (512, 384, 3, 1e-10)])
def test_sharded_matvec_matches_jax(one_rank, m, n, chunks, rtol):
    rng = np.random.default_rng(0 if chunks == 1 else 21)
    A = rng.standard_normal((m, n))
    w = rng.random(m)
    v = rng.standard_normal(n)
    jm = jmake_mesh()
    put = lambda a, spec: jax.device_put(jnp.asarray(a),
                                         NamedSharding(jm, spec))
    want = np.asarray(fused_normal_matvec_sharded(
        put(A, P("data", None)), put(w, P("data")), put(v, P()), jm,
        overlap_chunks=chunks))
    got = normal_matvec_sharded(_t(A), _t(w), _t(v), one_rank,
                                overlap_chunks=chunks)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    np.testing.assert_allclose(got.numpy(), A.T @ (w * (A @ v)), rtol=rtol)


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_local_pair_prep_matches_jax(shards):
    rng = np.random.default_rng(shards)
    m, n = 256, 128
    A = rng.standard_normal((m, n)) * 0.1
    y = (rng.random(m) < 0.5).astype(np.float64)
    xt, xd = rng.standard_normal(n) * 0.3, rng.standard_normal(n) * 0.3
    fns = _glm_kernel_fns(jlosses.LOGISTIC01_GLM, m)
    parts = []
    for r in range(shards):
        rows = slice(r * m // shards, (r + 1) * m // shards)
        want = _fused_glm_prep_pair(
            *(jnp.asarray(a) for a in (A[rows], y[rows], xt, xd)), *fns,
            interpret=True)
        got = glm_prep_pair(_t(A[rows]), _t(y[rows]), _t(xt), _t(xd),
                            losses.LOGISTIC01_GLM, m_norm=m)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                       rtol=1e-12, atol=1e-15)
        parts.append(got)
    whole = glm_prep_pair(_t(A), _t(y), _t(xt), _t(xd),
                          losses.LOGISTIC01_GLM)
    for f in ("w_t", "w_d"):
        got = torch.cat([getattr(p, f) for p in parts])
        np.testing.assert_allclose(got.numpy(), getattr(whole, f).numpy(),
                                   rtol=1e-13)
    for f in ("b_t", "b_d", "hd_t", "hd_d", "loss_t", "loss_d"):
        got = sum(getattr(p, f) for p in parts)
        np.testing.assert_allclose(got.numpy(), getattr(whole, f).numpy(),
                                   rtol=1e-13, atol=1e-16)


def _same_x_on_every_rank(ranks, name):
    for r in ranks[1:]:
        assert np.array_equal(r[f"{name}.x"], ranks[0][f"{name}.x"])


@pytest.mark.parametrize("world", [2, 4])
def test_greedy_off_trajectory_matches_jax(request, world):
    ranks = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    _same_x_on_every_rank(ranks, "greedy_off")
    sj = _jax_solve(TRAJ, False, TRAJ_KW)
    got = ranks[0]
    assert int(got["greedy_off.epochs"]) == sj.epochs
    assert int(got["greedy_off.cg"]) == sj.cg_info["total_cg_iters"]
    np.testing.assert_allclose(got["greedy_off.obj"], np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(got["greedy_off.x"], np.asarray(sj.x),
                               atol=1e-10)


@pytest.mark.parametrize("world", [2, 4])
def test_timed_mode_runs_the_cached_sharded_step(request, world):
    """Timed mode is a row shard's public mode: the cached GGN-CG step,
    uncaptured, a record every epoch. It takes the fused solve's epochs
    to its x, and its records at the fused solve's record epochs (every
    4th, then the last) are the fused solve's."""
    ranks = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    _same_x_on_every_rank(ranks, "timed")
    got = ranks[0]
    epochs = int(got["timed.epochs"])
    assert epochs == int(got["greedy_off.epochs"])
    assert got["timed.obj"].shape == (epochs + 1,)
    at = sorted(set(range(0, epochs, TRAJ_KW["stats_every"])) | {epochs})
    np.testing.assert_allclose(got["timed.obj"][at], got["greedy_off.obj"],
                               rtol=1e-13)
    np.testing.assert_allclose(got["timed.x"], got["greedy_off.x"],
                               atol=1e-13)


def test_lp_copy_trajectory_matches_jax(two_ranks):
    _same_x_on_every_rank(two_ranks, "lp")
    method_kw = {k: v for k, v in LP_METHOD.items()
                 if k not in ("solver", "greedy_alpha")}
    sj = _jax_solve(TRAJ, False, TRAJ_KW, lp=True, **method_kw)
    got = two_ranks[0]
    assert int(got["lp.epochs"]) == sj.epochs
    assert int(got["lp.cg"]) == sj.cg_info["total_cg_iters"]
    np.testing.assert_allclose(got["lp.obj"], np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(got["lp.x"], np.asarray(sj.x), atol=1e-10)


def test_greedy_on_fixed_point_matches_jax(two_ranks):
    _same_x_on_every_rank(two_ranks, "greedy_on")
    sj = _jax_solve(TRAJ, True, TRAJ_KW)
    assert float(two_ranks[0]["greedy_on.obj"][-1]) == pytest.approx(
        float(sj.obj[-1]), rel=1e-8)


def test_comm_overlap_solve_matches_plain(two_ranks):
    got = two_ranks[0]
    for name in ("overlap_1", "overlap_2"):
        _same_x_on_every_rank(two_ranks, name)
    assert int(got["overlap_2.epochs"]) == int(got["overlap_1.epochs"])
    np.testing.assert_allclose(got["overlap_2.x"], got["overlap_1.x"],
                               atol=1e-9)


def test_rows_from_disk_match_the_single_process_solve(two_ranks,
                                                       dist_data):
    _same_x_on_every_rank(two_ranks, "dataio")
    A, y, x0 = dist_data[1]
    prob = scso.Problem(A, y, x0, jlosses.logistic01_f, DIST_LAM,
                        grad_fx=jlosses.logistic01_grad,
                        glm=jlosses.LOGISTIC01_GLM, dtype=np.float64)
    sj = scso.iterate(scso.ProxGGNSCORE(**DIST_METHOD), prob, "l1",
                      scso.PHuberSmootherL1L2(1.0), **DIST_KW)
    np.testing.assert_allclose(two_ranks[0]["dataio.x"], np.asarray(sj.x),
                               rtol=0, atol=1e-10)


def test_shard_problem_keeps_its_rows(one_rank):
    prob = _port_problem(TRAJ)
    assert prob.mesh is None and prob.m_total == 512
    sp = shard_problem(prob, one_rank)
    assert sp.mesh is one_rank and sp.data_axis == "data"
    assert sp.m_total == 512 and sp.A is prob.A  # one rank: no copy
    with pytest.raises(ValueError, match="already sharded"):
        shard_problem(sp, one_rank)
    with pytest.raises(ValueError, match="axis"):
        shard_problem(prob, one_rank, data_axis="model")


def test_shard_problem_takes_the_copys_rows(one_rank):
    from scso_tpu_torch.parallel.sharding import Mesh

    prob = st.with_lp_copy(_port_problem(TRAJ))
    assert shard_problem(prob, one_rank).A_lp is prob.A_lp  # no copy
    second = Mesh(group=one_rank.group, axis_names=("data",), size=2,
                  rank=1)
    sp = shard_problem(prob, second)
    assert sp.A_lp.dtype == torch.bfloat16
    assert torch.equal(sp.A_lp, prob.A_lp[256:])
    assert torch.equal(sp.A, prob.A[256:])
    assert shard_problem(_port_problem(TRAJ), one_rank).A_lp is None


def test_shard_problem_refuses_what_it_cannot_split(one_rank):
    from scso_tpu_torch.parallel.sharding import Mesh

    three = Mesh(group=one_rank.group, axis_names=("data",), size=3,
                 rank=0)
    with pytest.raises(ValueError, match="pad_rows"):
        shard_problem(_port_problem(TRAJ), three)
    with pytest.raises(ValueError, match="data problem"):
        shard_problem(st.CompositeProblem(
            x0=torch.zeros(3), lam=torch.tensor(0.1), A=None, y=None,
            x_star=torch.zeros(3), f=None, dtype=torch.float64,
            device=torch.device("cpu")), one_rank)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_rows(as_tensor):
    A, y = np.ones((10, 3)), np.ones(10)
    if as_tensor:
        A, y = torch.ones((10, 3)), torch.ones(10)
    Ap, yp, m = pad_rows(A, y, 4)
    assert m == 10 and tuple(Ap.shape) == (12, 3) and tuple(yp.shape) == (12,)
    assert float(Ap[10:].sum()) == 0 and float(Ap[:10].sum()) == 30
    assert type(Ap) is type(A)
    Ap, yp, m = pad_rows(A, y, 5)
    assert Ap is A and m == 10


def test_mesh_and_init_validation(one_rank, monkeypatch):
    """One-axis and two-axis meshes, `replicate` and feature sharding on
    the one-rank group (their parity on 2 and 4 ranks:
    tests/test_torch_mesh2d_*.py)."""
    assert one_rank.shape == {"data": 1} and one_rank.rank == 0
    grid = make_mesh((1, 1), ("batch", "data"))
    assert grid.shape == {"batch": 1, "data": 1} and grid.coords == (0, 0)
    assert grid.axis_size("data") == 1 and grid.axis_rank("batch") == 0
    assert len(grid.groups) == 2
    with pytest.raises(ValueError, match="2 ranks"):
        make_mesh((2,))
    with pytest.raises(ValueError, match="names"):
        make_mesh((1, 1), ("data",))
    tree = {"a": torch.arange(3.0), "b": (2, torch.ones(2))}
    got = replicate(tree, grid)
    assert torch.equal(got["a"], tree["a"]) and got["b"][0] == 2
    assert replicate(None, one_rank) is None
    cols = shard_problem_features(_port_problem(TRAJ),
                                  make_mesh((1,), ("model",)))
    assert tuple(cols.A.shape) == tuple(_port_problem(TRAJ).A.shape)
    assert cols.A_lp is None and cols.comm_mesh is not None
    assert distributed_init("gloo") == 1  # the group exists: a no-op


def test_distributed_init_warns_instead_of_hiding_failures(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(UserWarning, match="did not complete"):
        assert distributed_init("gloo") == 1
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        make_mesh()


def test_rows_round_trip_through_disk(one_rank, tmp_path):
    A, y, x0 = _data(*OVERLAP)
    save_problem_data(str(tmp_path), _t(A), y)
    prob = load_problem_rows_sharded(
        str(tmp_path), x0, losses.logistic01_f, LAM, one_rank,
        glm=losses.LOGISTIC01_GLM, device="cpu", chunk_bytes=1000)
    assert prob.mesh is one_rank and prob.m_total == 256
    assert prob.dtype == torch.float64
    assert np.array_equal(prob.A.numpy(), A)
    assert np.array_equal(prob.y.numpy(), y)


@pytest.mark.parametrize("method,problem", [
    (st.ProxLQNSCORE(), "logistic"),
    (st.ProxGGNSCORE(solver="cg", epoch_cache=False), "logistic"),
    (st.ProxGGNSCORE(solver="cg", ss_type=2), "logistic"),
    (st.ProxGGNSCORE(solver="cg"), "multinomial"),
], ids=["lbfgs", "uncached", "ss_type2", "mglm"])
def test_unported_sharded_paths_raise_before_any_collective(
        one_rank, monkeypatch, method, problem):
    """These paths raised on a row shard until every method was ported
    there: each now runs, sums over the ranks (the one-rank group's
    all_reduce, recorded here, is the identity) and gives the unsharded
    solve bit for bit. tests/test_torch_sharded_methods.py holds them to
    the JAX package on 2 and 4 ranks."""
    calls = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda *a, **k: calls.append(a))
    if problem == "logistic":
        prob = _port_problem(TRAJ)
    else:
        A, Y, x0, _ = synthetic.make_multinomial_data(64, 8, 3, seed=1,
                                                      dtype=np.float64)
        prob = st.Problem(A, Y, x0, losses.multinom_f, LAM,
                          mglm=losses.multinom_mglm(3), dtype=torch.float64,
                          device="cpu")
    sm = st.PHuberSmootherL1L2(1.0)
    got = st.iterate(method, shard_problem(prob, one_rank), "l1", sm,
                     verbose=0, max_epoch=2)
    assert calls
    want = st.iterate(method, prob, "l1", sm, verbose=0, max_epoch=2)
    assert got.epochs == want.epochs
    assert torch.equal(got.x, want.x) and torch.equal(got.obj, want.obj)


def test_sharded_stats_need_the_cached_loss(one_rank):
    """Off the epoch cache a record's f(x) on a row shard is this rank's
    share summed over the ranks: on one rank the unsharded record."""
    prob = _port_problem(TRAJ)
    sp = shard_problem(prob, one_rank)
    star = torch.tensor(1.0, dtype=torch.float64)
    got = _stats(sp, "l1", sp.x0, star, 1e-10, 1e-10)
    want = _stats(prob, "l1", prob.x0, star, 1e-10, 1e-10)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
