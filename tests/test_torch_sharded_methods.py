"""Every single-instance method of the port on a row shard, against
scso_tpu's row-sharded solve (float64, CPU).

`scso_tpu_torch` solves SPMD over torch.distributed (gloo here), one
process per rank: this file re-runs itself as 2 and 4 worker ranks
(``if __name__ == "__main__"``), each launch solving every case once.
The JAX package solves the same numpy problems row-sharded over
conftest's 8-device CPU mesh (`scso_tpu.parallel.shard_problem`), its
products through XLA. Held to:
  * greedy off: the trajectory (objective history) to 1e-10 and x to
    1e-10, with equal epochs and CG iterations — f(x) off the epoch
    cache (the uncached path's records), the uncached GGN-CG path with
    ss_type 1, 2 (BB) and 3 (Armijo), the generic GGN-CG branch (no
    spec: J by jvp/vjp of out_fn, and through the ggn_w hook), a test
    set (``fvaltest``), Newton-CG cached and uncached, L-BFGS on a GLM
    problem and on a problem given only f, ∇f and ∇²f
    (tests/test_parallel.py's), multinomial cached and uncached;
  * greedy on: the fixed point to 1e-8 (Newton-CG, multinomial, the
    uncached path's loss_z trial);
  * the dense solves: ProxNSCORE() on the f-only problem and the dense
    dual and primal GGN systems, to tests/test_parallel.py's 1e-9;
  * mini-batches (400 rows in batches of 96: four full batches and one
    of 16 rows; each rank holds a varying share of each, padded): the
    JAX package's timed mode (numpy permutations, as the port's both
    modes) to 1e-10, fused and timed mode in the port bit for bit;
  * iterate_mixed and iterate_continuation on a shard: the port's own
    unsharded solves (held to scso_tpu in test_torch_mixed.py and
    test_torch_continuation.py) to 1e-10;
  * every rank holds the same x, bit for bit.
Besides: which NCCL meshes a fused solve captures (`Mesh.captures`,
NCCL_GRAPH_MIXING_SUPPORT=0), and the per-row shares that the sharded
steps rest on.
"""

import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.parallel import distributed_init, make_mesh, shard_problem

# (m, n, density, n_active, seed, λ) of each GLM problem
TRAJ = (512, 256, 0.05, 8, 7, 1e-2)      # test_torch_sharding.py's
NEWTON = (512, 64, 0.2, 8, 11, 0.1)      # damped Newton needs λ ≥ 0.1
BATCH = (400, 16, 0.3, 5, 5, 0.05)       # test_torch_batches.py's
TEST_ROWS = 128
KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)
BATCH_KW = dict(max_epoch=6, x_tol=1e-12, f_tol=1e-12, verbose=0,
                rng_seed=3, batch_size=96)


def _glm_data(spec):
    m, n, density, n_active, seed, _ = spec
    return synthetic.make_sparse_logreg_data(
        m, n, density=density, n_active=n_active, seed=seed,
        dtype=np.float64, label01=True)[:3]


def _test_rows():
    A, y = _glm_data((TEST_ROWS, 256, 0.05, 8, 8, 0))[:2]
    return A, y


def _f_only_data():
    # tests/test_parallel.py::make_logreg: ±1 labels, f/∇f/∇²f only
    return synthetic.make_sparse_logreg_data(
        64, 12, density=0.3, n_active=4, seed=0, dtype=np.float64)[:3]


def _generic_data(m, n, density=0.2, seed=3):
    return synthetic.make_sparse_logreg_data(
        m, n, density=density, n_active=8, seed=seed, dtype=np.float64,
        label01=True)[:3]


def _mglm_data():
    return synthetic.make_multinomial_data(256, 16, 3, seed=1,
                                           dtype=np.float64)[:3]


def problems(pkg, L, dtype, **dev):
    """name → problem, built alike by both packages: ``pkg`` is scso or
    st, ``L`` its losses module."""
    P = lambda *a, **k: pkg.Problem(*a, dtype=dtype, **dev, **k)
    glm = lambda spec, **k: P(*_glm_data(spec), L.logistic01_f, spec[-1],
                              grad_fx=L.logistic01_grad,
                              glm=L.LOGISTIC01_GLM, **k)
    At, yt = _test_rows()
    generic = dict(out_fn=L.sigmoid_out, grad_fy=L.logistic_ggn_residual,
                   hess_fy_diag=L.logistic_ggn_qdiag,
                   loss_fn=L.logistic_loss_01)
    A, y, x0 = _f_only_data()
    Am, Ym, xm = _mglm_data()
    return {
        "traj": glm(TRAJ),
        "newton": glm(NEWTON),
        "batch": glm(BATCH),
        "test": glm(TRAJ, Atest=At, ytest=yt),
        "f_only": P(A, y, x0, L.logistic_f, 1e-2, grad_fx=L.logistic_grad,
                    hess_fx=L.logistic_hess),
        "f_only_autograd": P(A, y, x0, L.logistic_f, 1e-2),
        "generic": P(*_generic_data(512, 32, 0.3, 4), L.logistic01_f, 0.05,
                     **generic),
        "generic_w": P(*_generic_data(320, 40), L.logistic01_f, 0.02,
                       ggn_w=L.logistic_ggn_w, **generic),
        "dense": P(*_generic_data(32, 48), L.logistic01_f, 0.05,
                   out_fn=L.sigmoid_out, loss_fn=L.logistic_loss_01),
        "mglm": P(Am, Ym, xm, L.multinom_f, 0.05, mglm=L.multinom_mglm(3)),
    }


#: name → (problem, method class, method fields, iterate kwargs, gate):
#: gate 'traj' (greedy off), 'fixed' (greedy on) or 'dense'
CASES = {
    "uncached": ("traj", "ProxGGNSCORE",
                 dict(solver="cg", epoch_cache=False, greedy_alpha=False),
                 KW, "traj"),
    "uncached_greedy": ("traj", "ProxGGNSCORE",
                        dict(solver="cg", epoch_cache=False,
                             greedy_alpha=True), KW, "fixed"),
    "ss_type2": ("traj", "ProxGGNSCORE", dict(solver="cg", ss_type=2),
                 dict(KW, alpha=None), "traj"),
    "ss_type3": ("traj", "ProxGGNSCORE", dict(solver="cg", ss_type=3),
                 dict(KW, alpha=None), "traj"),
    "test_set": ("test", "ProxGGNSCORE",
                 dict(solver="cg", greedy_alpha=False), KW, "traj"),
    "test_set_uncached": ("test", "ProxGGNSCORE",
                          dict(solver="cg", epoch_cache=False,
                               greedy_alpha=False), KW, "traj"),
    # cg_tol 1e-9: at the default floor (√eps) the JAX package's own
    # solves of this problem on 1, 2, 4 and 8 devices keep equal CG
    # counts but part at 4e-10 in their objectives (on 320×40 at λ =
    # 0.02 they end CG at other iterations: 324 against 326)
    "generic": ("generic", "ProxGGNSCORE", dict(solver="cg", cg_tol=1e-9),
                dict(KW, max_epoch=30), "traj"),
    "generic_w": ("generic_w", "ProxGGNSCORE", dict(solver="cg"),
                  dict(KW, max_epoch=30), "traj"),
    "newton_cg": ("newton", "ProxNSCORE",
                  dict(solver="cg", greedy_alpha=False), KW, "traj"),
    "newton_cg_greedy": ("newton", "ProxNSCORE",
                         dict(solver="cg", greedy_alpha=True), KW, "fixed"),
    "newton_cg_uncached": ("newton", "ProxNSCORE",
                           dict(solver="cg", epoch_cache=False,
                                greedy_alpha=False), KW, "traj"),
    "newton_dense": ("f_only", "ProxNSCORE", {}, dict(verbose=0), "dense"),
    "newton_dense_autograd": ("f_only_autograd", "ProxNSCORE", {},
                              dict(verbose=0), "dense"),
    "ggn_dense_dual": ("dense", "ProxGGNSCORE", dict(solver="auto"),
                       dict(verbose=0, max_epoch=30), "dense"),
    "ggn_dense_primal": ("dense", "ProxGGNSCORE",
                         dict(solver="dense_primal"),
                         dict(verbose=0, max_epoch=30), "dense"),
    "lbfgs": ("traj", "ProxLQNSCORE", {}, dict(KW, alpha=None), "traj"),
    "lbfgs_f_only": ("f_only", "ProxLQNSCORE", {},
                     dict(KW, alpha=None, max_epoch=30), "traj"),
    "mglm": ("mglm", "ProxGGNSCORE", dict(solver="cg", greedy_alpha=False),
             KW, "traj"),
    "mglm_greedy": ("mglm", "ProxGGNSCORE",
                    dict(solver="cg", greedy_alpha=True), KW, "fixed"),
    "mglm_uncached": ("mglm", "ProxGGNSCORE",
                      dict(solver="cg", epoch_cache=False,
                           greedy_alpha=False), KW, "traj"),
    "batches_ggn": ("batch", "ProxGGNSCORE", dict(solver="cg"),
                    BATCH_KW, "traj"),
    "batches_newton": ("batch", "ProxNSCORE", dict(solver="cg"),
                       BATCH_KW, "traj"),
    "batches_lbfgs": ("batch", "ProxLQNSCORE", {}, BATCH_KW, "traj"),
}
# the cases whose fused mode is also run in timed mode (bitwise)
TIMED = ("batches_ggn", "batches_newton", "batches_lbfgs", "uncached",
         "lbfgs", "mglm_uncached")


def _port_solves(mesh, half):
    """The solves of a worker rank in half ``half`` (0 or 1) of the
    cases: name → Solution."""
    sm = lambda: st.PHuberSmootherL1L2(1.0)
    probs = problems(st, losses, torch.float64, device="cpu")
    sharded = {k: shard_problem(p, mesh) for k, p in probs.items()}
    out = {}
    for i, (name, (pk, cls, fields, kw, _)) in enumerate(CASES.items()):
        if i % 2 != half:
            continue
        method = getattr(st, cls)(**fields)
        kw = {k: v for k, v in kw.items() if v is not None}
        out[name] = st.iterate(method, sharded[pk], "l1", sm(), **kw)
        if name in TIMED:
            out[name + ".timed"] = st.iterate(
                method, sharded[pk], "l1", sm(), **dict(kw, mode="timed"))
    ggn = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    if half == 0:
        out["mixed"] = st.iterate_mixed(ggn, sharded["traj"], "l1", sm(),
                                        **KW)
    else:
        out["continuation"] = st.iterate_continuation(
            ggn, sharded["traj"], "l1", sm(), mu_schedule=[4.0, 2.0],
            stage_epochs=4, max_epoch=30, verbose=0, x_tol=1e-12,
            f_tol=1e-10)
    return out


def _rank_main(init, rank, world, workdir, part):
    """One rank of a multi-rank run: join the gloo group, solve its half
    ``part`` of the cases, save."""
    from _torch_ranks import result_path

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    n = distributed_init("gloo", init_method=init,
                         world_size=world, rank=rank)
    assert n == world
    res = {}
    for name, s in _port_solves(make_mesh(), int(part)).items():
        res[f"{name}.x"] = s.x.numpy()
        res[f"{name}.obj"] = s.obj.numpy()
        res[f"{name}.fvaltest"] = s.fvaltest.numpy()
        res[f"{name}.epochs"] = s.epochs
        res[f"{name}.cg"] = (s.cg_info or {}).get("total_cg_iters", 0)
    np.savez(result_path(workdir, rank, world, part), **res)
    dist.destroy_process_group()


if __name__ == "__main__":  # a worker rank (PYTHONPATH is the repo)
    _rank_main(*sys.argv[1:])
    sys.exit(0)

import scso_tpu as scso  # noqa: E402  (the worker ranks above need neither)
from _torch_ranks import file_init, launch, saved  # noqa: E402
from scso_tpu.models import losses as jlosses  # noqa: E402
from scso_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from scso_tpu.parallel import shard_problem as jshard_problem  # noqa: E402
from scso_tpu_torch._src.struct import replace  # noqa: E402
from scso_tpu_torch.algorithms import iterate as titerate  # noqa: E402
from scso_tpu_torch.parallel import sharding  # noqa: E402
from scso_tpu_torch.problems import RowSet  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as workdir:
        # each world's ranks once for each half of the cases (a launch's
        # time follows the load on the machine)
        launch(__file__, [(w, h) for w in (2, 4) for h in ("0", "1")],
               workdir)
        yield {w: saved(workdir, w, ("0", "1")) for w in (2, 4)}


_JAX = {}


def _jax_solve(name):
    """The JAX package's row-sharded solve of a case (cached a module)."""
    if name not in _JAX:
        pk, cls, fields, kw, _ = CASES[name]
        prob = problems(scso, jlosses, np.float64)[pk]
        method = getattr(scso, cls)(kernels="xla", **fields)
        kw = {k: v for k, v in kw.items() if v is not None}
        if "batch_size" in kw:
            kw["mode"] = "timed"  # numpy permutations, as in the port
        _JAX[name] = scso.iterate(
            method, jshard_problem(prob, jmake_mesh()), "l1",
            scso.PHuberSmootherL1L2(1.0), **kw)
    return _JAX[name]


def _same_x_on_every_rank(got, name):
    for r in got[1:]:
        assert np.array_equal(r[f"{name}.x"], got[0][f"{name}.x"]), name


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_method_matches_jax(ranks, world, name):
    got = ranks[world]
    _same_x_on_every_rank(got, name)
    r = got[0]
    sj = _jax_solve(name)
    gate = CASES[name][-1]
    x = r[f"{name}.x"]
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(r[f"{name}.obj"]))
    if gate == "fixed":
        assert float(r[f"{name}.obj"][-1]) == pytest.approx(
            float(sj.obj[-1]), rel=1e-8)
        return
    if gate == "dense":
        assert int(r[f"{name}.epochs"]) == sj.epochs
        np.testing.assert_allclose(x, np.asarray(sj.x), rtol=0, atol=1e-9)
        np.testing.assert_allclose(r[f"{name}.obj"][-1], sj.obj[-1],
                                   rtol=1e-9)
        return
    assert int(r[f"{name}.epochs"]) == sj.epochs
    if sj.cg_info is not None:  # the JAX package's timed mode has none
        assert int(r[f"{name}.cg"]) == sj.cg_info["total_cg_iters"]
    np.testing.assert_allclose(r[f"{name}.obj"], np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(x, np.asarray(sj.x), rtol=0, atol=1e-10)
    if sj.fvaltest is not None and len(sj.fvaltest):
        np.testing.assert_allclose(r[f"{name}.fvaltest"],
                                   np.asarray(sj.fvaltest), rtol=1e-10)
        assert len(r[f"{name}.fvaltest"]) == len(sj.fvaltest)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", TIMED)
def test_timed_mode_is_the_fused_solve(ranks, world, name):
    """Off the epoch cache both modes take the same steps in the same
    order on a shard (mini-batches: the same host-drawn permutations):
    their x, objectives and epochs are equal, bit for bit."""
    r = ranks[world][0]
    _same_x_on_every_rank(ranks[world], name + ".timed")
    assert int(r[f"{name}.timed.epochs"]) == int(r[f"{name}.epochs"])
    assert np.array_equal(r[f"{name}.timed.x"], r[f"{name}.x"])
    assert np.array_equal(r[f"{name}.timed.obj"][-1:], r[f"{name}.obj"][-1:])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["mixed", "continuation"])
def test_mixed_and_continuation_on_a_shard(ranks, world, name):
    """`iterate_mixed` and `iterate_continuation` reach the shard through
    `iterate`: the port's unsharded solve of the same problem."""
    _same_x_on_every_rank(ranks[world], name)
    r = ranks[world][0]
    prob = problems(st, losses, torch.float64, device="cpu")["traj"]
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    sm = st.PHuberSmootherL1L2(1.0)
    if name == "mixed":
        want = st.iterate_mixed(method, prob, "l1", sm, **KW)
    else:
        want = st.iterate_continuation(
            method, prob, "l1", sm, mu_schedule=[4.0, 2.0], stage_epochs=4,
            max_epoch=30, verbose=0, x_tol=1e-12, f_tol=1e-10)
    assert int(r[f"{name}.epochs"]) == want.epochs
    np.testing.assert_allclose(r[f"{name}.obj"], want.obj.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(r[f"{name}.x"], want.x.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("backend,size,captures,raises", [
    ("nccl", 4, True, None), ("nccl", 4, False, "NCCL_GRAPH_MIXING_SUPPORT"),
    ("nccl", 1, False, None), ("gloo", 4, True, "gloo")])
def test_which_meshes_a_fused_solve_captures(monkeypatch, backend, size,
                                             captures, raises):
    """Four NCCL ranks capture when the mesh was made under
    NCCL_GRAPH_MIXING_SUPPORT=0 (``Mesh.captures``) and raise naming the
    variable and timed mode without it (a RuntimeError: a setting to
    make, not a part of the port left out); one NCCL rank always
    captures. Over gloo a fused solve on the card runs its program
    uncaptured (``_uncaptured``: gloo reduces CUDA tensors through the
    host) and nothing raises; on the CPU it runs as every CPU solve."""
    monkeypatch.setattr(titerate.dist, "get_backend", lambda group: backend)
    prob = problems(st, losses, torch.float64, device="cpu")["traj"]
    mesh = sharding.Mesh(group=object(), axis_names=("data",), size=size,
                         rank=0, captures=captures)
    prob = replace(prob, mesh=mesh)
    on_card = replace(prob, device=torch.device("cuda", 0))
    method = st.ProxGGNSCORE(solver="cg")
    assert titerate._uncaptured(on_card) == (backend == "gloo")
    assert not titerate._uncaptured(prob)
    if raises in (None, "gloo"):
        titerate._check_capturable(prob, st.ProxGGNSCORE(solver="cg"))
        return
    with pytest.raises(RuntimeError, match=raises) as e:
        titerate._check_capturable(prob, st.ProxGGNSCORE(solver="cg"))
    assert "mode='timed'" in str(e.value)


def test_overlapped_chunks_over_ranks_stay_timed(monkeypatch):
    """``comm_overlap_chunks > 1`` over four NCCL ranks stays in timed
    mode: a fused solve raises naming A11 and timed mode before any
    collective (no capture held the chunks' all-reduces), one chunk
    captures, and one rank captures any number of chunks."""
    monkeypatch.setattr(titerate.dist, "get_backend", lambda group: "nccl")
    prob = replace(problems(st, losses, torch.float64, device="cpu")["traj"],
                   mesh=sharding.Mesh(group=object(), axis_names=("data",),
                                      size=4, rank=0, captures=True))
    overlapped = st.ProxGGNSCORE(solver="cg", comm_overlap_chunks=2)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP A11\).*mode='timed'"):
        titerate._check_capturable(prob, overlapped)
    titerate._check_capturable(prob, st.ProxGGNSCORE(solver="cg"))
    one = replace(prob, mesh=sharding.Mesh(
        group=object(), axis_names=("data",), size=1, rank=0,
        captures=False))
    titerate._check_capturable(one, overlapped)
    on_card = replace(prob, device=torch.device("cuda", 0))
    assert not titerate._uncaptured(on_card)


@pytest.mark.parametrize("value,captures", [("0", True), ("1", False),
                                            (None, False)])
def test_make_mesh_records_the_mixing_setting(monkeypatch, tmp_path, value,
                                               captures):
    """A group made by `distributed_init` over gloo records nothing, so
    `make_mesh` reads the variable when it makes the mesh; an NCCL group
    made by `distributed_init` keeps what the variable was then."""
    if value is None:
        monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", value)
    distributed_init("gloo", init_method=file_init(tmp_path),
                     world_size=1, rank=0)
    try:
        assert make_mesh().captures is captures
        monkeypatch.setitem(sharding._MIXING_OFF, None, not captures)
        assert make_mesh().captures is (not captures)
    finally:
        dist.destroy_process_group()


def _rowset(prob, rows, total, pad):
    """A `RowSet` of ``rows`` of prob's A with ``pad`` zero rows after."""
    A = torch.cat([prob.A[rows], prob.A.new_zeros((pad, prob.A.shape[1]))])
    y = torch.cat([prob.y[rows], prob.y.new_zeros((pad,))])
    mask = torch.cat([torch.ones(len(rows), dtype=A.dtype),
                      torch.zeros(pad, dtype=A.dtype)])
    return RowSet(A=A, y=y, total=total, pad=torch.tensor(pad), mask=mask)


def test_shares_of_a_padded_batch_sum_to_the_batch():
    """The per-rank shares of f, ∇f, ∇²f and of a per-row form over a
    batch split unevenly over two ranks, each padded with zero rows, sum
    to the unsharded batch's values (the f-contract, `Problem.share`)."""
    prob = problems(st, losses, torch.float64, device="cpu")["f_only"]
    x = torch.linspace(-0.3, 0.4, prob.x0.shape[0], dtype=torch.float64)
    batch = torch.tensor([3, 60, 17, 41, 8, 33, 50, 12, 22, 9])
    whole = (prob.f(prob.A[batch], prob.y[batch], x),
             prob.grad_fx(prob.A[batch], prob.y[batch], x),
             prob.hess_fx(prob.A[batch], prob.y[batch], x))
    mesh = sharding.Mesh(group=object(), axis_names=("data",), size=2,
                         rank=0)
    parts = []
    for own in (batch[batch < 32], batch[batch >= 32]):
        rs = _rowset(prob, own, len(batch), 8 - len(own))
        view = replace(prob, mesh=mesh, rows=rs)
        fns = (prob.f, prob.grad_fx, prob.hess_fx)
        parts.append([view.share(rs.A, rs.y, lambda a, b, fn=fn: fn(a, b, x))
                      for fn in fns])
        w = view.row_form(rs.A)(losses.logistic_hvp_w(rs.A, rs.y, x))
        assert torch.all(w[len(own):] == 0)
    for got, want in zip(zip(*parts), whole):
        torch.testing.assert_close(got[0] + got[1], want, rtol=1e-13,
                                   atol=1e-15)
