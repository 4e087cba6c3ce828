"""The exported solver (`scso_tpu_torch.utils.deploy`: a ``torch.export``
program of the whole fused solve) against the JAX package's StableHLO
artifact and the port's own ``iterate``, float64 on the CPU.

Each round trip equals ``iterate`` bit for bit and the JAX artifact's
``serve`` to 1e-12 (absolute on x, relative on the objective), for a
generic f (dense Newton with its hooks), a GLM with cached GGN-CG,
Newton-CG, L-BFGS (the K4 path) and multinomial (the K5 path). The
artifact loads in a process that never imports scso_tpu_torch; the
program holds one ``while_loop`` a loop of the solve; a function the
user wrote exports; the op library's schemas and Meta functions (built
here with g++, no CUDA) give the plain versions' output shapes."""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.utils import export_solver as jexport
from scso_tpu.utils import load_solver as jload
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.utils import export_solver, load_solver
from scso_tpu_torch.utils.deploy import META_FILE

TOL = 1e-12  # the port's artifact against the JAX artifact's serve


def _logistic(pkg, loss_mod, f=None, seed=1):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=seed, dtype=np.float64)
    kw = dict(grad_fx=loss_mod.logistic_grad, hess_fx=loss_mod.logistic_hess)
    f = f or loss_mod.logistic_f
    if pkg is st:
        return st.Problem(A, y, x0, f, 1e-2, dtype=torch.float64,
                          device="cpu", **kw)
    return scso.Problem(A, y, x0, f, 1e-2, dtype=np.float64, **kw)


def _glm(pkg, loss_mod, lam=1e-2, seed=3):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        128, 16, density=0.3, n_active=4, seed=seed, dtype=np.float64,
        label01=True)
    kw = dict(grad_fx=loss_mod.logistic01_grad, glm=loss_mod.LOGISTIC01_GLM)
    if pkg is st:
        return st.Problem(A, y, x0, loss_mod.logistic01_f, lam,
                          dtype=torch.float64, device="cpu", **kw)
    return scso.Problem(A, y, x0, loss_mod.logistic01_f, lam,
                        dtype=np.float64, **kw)


def _mglm(pkg, loss_mod):
    A, y, x0, _ = jsynth.make_multinomial_data(96, 12, 4, seed=2,
                                               dtype=np.float64)
    kw = dict(grad_fx=loss_mod.multinom_grad, mglm=loss_mod.multinom_mglm(4))
    if pkg is st:
        return st.Problem(A, y, x0, loss_mod.multinom_f, 1e-2,
                          dtype=torch.float64, device="cpu", **kw)
    return scso.Problem(A, y, x0, loss_mod.multinom_f, 1e-2,
                        dtype=np.float64, **kw)


#: case → (method, problem, max_epoch, the solve's loops: one
#: ``while_loop`` each in the program)
CASES = {
    # generic f: dense Newton, Armijo steps (ss_type 3)
    "newton_dense": (lambda pkg: pkg.ProxNSCORE(solver="dense", ss_type=3),
                     _logistic, 60, ("epochs", "armijo")),
    "ggn_cg": (lambda pkg: pkg.ProxGGNSCORE(solver="cg"), _glm, 60,
               ("epochs", "cg")),
    "newton_cg": (lambda pkg: pkg.ProxNSCORE(solver="cg", cg_maxiter=100),
                  lambda pkg, mod: _glm(pkg, mod, lam=0.1), 60,
                  ("epochs", "cg")),
    # L-BFGS: the two-loop direction (K4 on the card), BB steps
    "lbfgs": (lambda pkg: pkg.ProxLQNSCORE(), _logistic, 60, ("epochs",)),
    # multinomial: the mglm matvec (K5 on the card) in CG
    "mglm": (lambda pkg: pkg.ProxGGNSCORE(solver="cg"), _mglm, 40,
             ("epochs", "cg")),
}
SM = lambda pkg: pkg.PHuberSmootherL1L2(1.0)
_BLOBS: dict = {}


def _case(name):
    """(port problem, JAX problem, method of each package, max_epoch,
    the artifact's bytes), exported once a session."""
    method, problem, epochs, _ = CASES[name]
    prob = problem(st, losses)
    if name not in _BLOBS:
        _BLOBS[name] = export_solver(method(st), prob, "l1", SM(st),
                                     st.Options(verbose=0, max_epoch=epochs))
    return (prob, problem(scso, jlosses), method, epochs, _BLOBS[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_exported_solve_matches_iterate_and_the_jax_artifact(name):
    prob, jprob, method, epochs, blob = _case(name)
    x, k, obj = load_solver(blob, device="cpu")(prob.A, prob.y, prob.x0)
    ref = st.iterate(method(st), prob, "l1", SM(st), max_epoch=epochs,
                     verbose=0)
    assert int(k) == ref.epochs
    assert torch.equal(x, ref.x)
    assert float(obj) == float(ref.obj[-1])
    jx, jk, jobj = jload(jexport(method(scso), jprob, "l1", SM(scso),
                                 scso.Options(verbose=0, max_epoch=epochs)))(
        jprob.A, jprob.y, jprob.x0)
    assert int(k) == int(jk)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(obj), float(jobj), rtol=TOL, atol=0)


def _while_loops(gm) -> int:
    """The ``while_loop`` nodes of a graph module and of every subgraph
    it holds."""
    n = 0
    for node in gm.graph.nodes:
        if node.target is torch.ops.higher_order.while_loop:
            n += 1
    for sub in gm.children():
        if isinstance(sub, torch.fx.GraphModule):
            n += _while_loops(sub)
    return n


@pytest.mark.parametrize("name", ["ggn_cg", "lbfgs", "newton_dense"])
def test_the_program_holds_one_while_loop_per_loop_of_the_solve(name):
    """The epoch loop is one ``while_loop`` (its carry the iterate, the
    epoch count, the histories, the epoch cache, the L-BFGS memory), and
    so is each loop inside an epoch: CG, the Armijo search."""
    blob = _case(name)[-1]
    ep = torch.export.load(io.BytesIO(blob))
    assert _while_loops(ep.graph_module) == len(CASES[name][-1])


_LOADER = r"""
import base64, io, sys, zipfile
import numpy as np
import torch

blob = open(sys.argv[1], "rb").read()
with zipfile.ZipFile(io.BytesIO(blob)) as z:
    lib = [n for n in z.namelist() if n.endswith("extra/scso_ops.so.b64")]
assert not lib  # a CPU artifact holds ATen ops alone
serve = torch.export.load(io.BytesIO(blob)).module()
data = np.load(sys.argv[2])
x, k, obj = serve(*(torch.from_numpy(data[v]) for v in ("A", "y", "x0")))
assert not [m for m in sys.modules if m.startswith("scso_tpu")]
np.savez(sys.argv[3], x=x.numpy(), k=k.numpy(), obj=obj.numpy())
"""


def test_the_artifact_loads_where_scso_tpu_torch_was_never_imported(
        tmp_path):
    prob, _, method, epochs, blob = _case("lbfgs")
    (tmp_path / "solver.pt2").write_bytes(blob)
    np.savez(tmp_path / "data.npz", A=prob.A.numpy(), y=prob.y.numpy(),
             x0=prob.x0.numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-c", _LOADER, str(tmp_path / "solver.pt2"),
         str(tmp_path / "data.npz"), str(tmp_path / "out.npz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = np.load(tmp_path / "out.npz")
    x, k, obj = load_solver(blob)(prob.A, prob.y, prob.x0)
    assert np.array_equal(out["x"], x.numpy())
    assert int(out["k"]) == int(k) and float(out["obj"]) == float(obj)


def test_a_user_callable_exports():
    """A loss the user wrote (with its derivative hooks) is traced into
    the program: no lookup by name, as in the JAX package."""
    calls = []

    def my_loss(A, y, x):
        calls.append(1)
        return losses.logistic_f(A, y, x)

    method = st.ProxNSCORE(solver="dense", ss_type=3)
    prob = _logistic(st, losses, f=my_loss)
    blob = export_solver(method, prob, "l1", SM(st))
    traced = len(calls)
    assert traced > 0
    x, k, obj = load_solver(blob)(prob.A, prob.y, prob.x0)
    assert len(calls) == traced  # the loaded program runs no Python of it
    ref = st.iterate(method, prob, "l1", SM(st), verbose=0)
    assert torch.equal(x, ref.x) and int(k) == ref.epochs
    assert float(obj) == float(ref.obj[-1])


def test_the_artifact_is_a_torch_export_program():
    """A ``torch.export`` archive: the program, its constants, and the
    extra file that says what it was exported for; the template's data
    is not in it. Bytes of another kind raise ValueError."""
    prob, _, _, _, blob = _case("ggn_cg")
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = z.namelist()
        meta = json.loads(z.read(next(n for n in names
                                      if n.endswith("extra/" + META_FILE))))
        sample = [n for n in names if "sample_inputs" in n]
        sizes = sum(z.getinfo(n).file_size for n in sample)
    assert any(n.endswith("models/model.json") for n in names)
    assert meta["format"] == "scso_tpu_torch.solver"
    assert meta["device"] == "cpu" and meta["n"] == meta["n_true"] == 16
    assert meta["package_version"] == st.__version__
    assert sizes < prob.A.numel() * 8
    plain = io.BytesIO()
    with zipfile.ZipFile(plain, "w") as z:
        z.writestr("spec.json", "{}")
    with pytest.raises(ValueError, match="not a scso_tpu_torch.solver"):
        load_solver(plain.getvalue())
    with pytest.raises(ValueError, match="exported for cpu"):
        load_solver(blob, device="cuda")


def test_a_padded_problem_takes_unpadded_data():
    """pad_features: the loaded program takes data at the padded width
    or at n_true columns (padded as make_problem pads them), and returns
    x at n_true columns, as iterate does."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        96, 20, density=0.3, n_active=4, seed=5, dtype=np.float64,
        label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device="cpu", pad_features=True)
    assert prob.n_true == 20 and prob.A.shape[1] == 128
    method = st.ProxGGNSCORE(solver="cg")
    serve = load_solver(export_solver(method, prob, "l1", SM(st),
                                      st.Options(verbose=0, max_epoch=30)))
    ref = st.iterate(method, prob, "l1", SM(st), max_epoch=30, verbose=0)
    for data in ((A, y, x0), (prob.A, prob.y, prob.x0)):
        x, k, _ = serve(*data)
        assert x.shape == (20,) and torch.equal(x, ref.x)
        assert int(k) == ref.epochs


@pytest.mark.parametrize("shuffle", [True, False])
def test_a_mini_batch_solve_exports_with_iterates_bits(shuffle):
    """A mini-batch solve (batch_size=32) exports; the loaded program,
    which draws each epoch's permutation on the host as ``iterate``
    does, gives ``iterate``'s bits on the template's data and on fresh
    data."""
    prob, fresh = _glm(st, losses), _glm(st, losses, seed=7)
    method = st.ProxGGNSCORE(solver="cg")
    kw = dict(batch_size=32, max_epoch=20, shuffle_batch=shuffle)
    blob = export_solver(method, prob, "l1", SM(st),
                         st.Options(verbose=0, **kw))
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        meta = json.loads(z.read([n for n in z.namelist()
                                  if n.endswith(META_FILE)][0]))
    assert meta["batches"] == {"max_epoch": 20, "m": 128,
                               "shuffle": shuffle, "rng_seed": 0}
    serve = load_solver(blob)
    for p in (prob, fresh):
        ref = st.iterate(method, p, "l1", SM(st), verbose=0, **kw)
        x, k, obj = serve(p.A, p.y, p.x0)
        assert int(k) == ref.epochs
        assert torch.equal(x, ref.x) and torch.equal(obj, ref.obj[-1])


def test_a_column_shard_or_a_sharded_mini_batch_solve_is_refused_by_name():
    """What is not exported raises NotImplementedError naming ROADMAP A12
    before any trace: a column shard (its gathers hold the rank's
    offset) and a mini-batch solve of a row shard (each rank's rows of a
    batch are worked out on the host)."""
    from dataclasses import replace

    from scso_tpu_torch.ops.dense import ColShard
    from scso_tpu_torch.parallel import sharding

    prob = _glm(st, losses)
    mesh = sharding.Mesh(group=object(), axis_names=("data",), size=1,
                         rank=0, captures=True)
    cols = replace(prob, A=ColShard(prob.A, mesh, "data", object(), 0, 1))
    with pytest.raises(NotImplementedError, match="column-sharded.*A12"):
        export_solver(st.ProxGGNSCORE(solver="cg"), cols, "l1", SM(st))
    with pytest.raises(NotImplementedError, match="mini-batch.*A12"):
        export_solver(st.ProxGGNSCORE(solver="cg"), replace(prob, mesh=mesh),
                      "l1", SM(st), st.Options(verbose=0, batch_size=32))


# ---------------------------------------------------------------------------
# the op library's schemas and Meta functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meta_ops():
    from scso_tpu_torch.ops.cuda import build

    try:
        build.find_cxx()
    except RuntimeError as e:
        pytest.skip(str(e))
    build.build_meta()
    return torch.ops.scso


def _meta(*ts):
    return [t.to("meta") for t in ts]


def test_op_schemas(meta_ops):
    want = {
        "normal_matvec": 6, "glm_prep_pair": 12, "glm_prep": 9,
        "score_update": 13, "two_loop": 10, "mglm_matvec": 7}
    for name, nargs in want.items():
        schema = getattr(meta_ops, name).default._schema
        assert len(schema.arguments) == nargs, (name, schema)
        assert not any(a.alias_info for a in schema.arguments), schema


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_meta_shapes_match_the_plain_versions(meta_ops, dtype):
    from scso_tpu_torch.ops.cuda import glm_prep as k2
    from scso_tpu_torch.ops.cuda import mglm_matvec as k5
    from scso_tpu_torch.ops.cuda import score_update as k3
    from scso_tpu_torch.ops.cuda import two_loop as k4
    from scso_tpu_torch.ops.cuda.matvec import normal_matvec_torch
    from scso_tpu_torch.ops.lbfgs_core import init_memory

    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=dtype)
    m, n, k = 40, 24, 3
    A, w, v, y = rnd(m, n), rnd(m).abs(), rnd(n), (rnd(m) > 0).to(dtype)
    shapes = lambda ts: [tuple(t.shape) for t in ts]

    got = meta_ops.normal_matvec(*_meta(A, w, v), 1, 0, 1)
    assert got.shape == normal_matvec_torch(A, w, v).shape
    assert got.dtype == dtype
    glm = losses.LOGISTIC01_GLM
    for form in (0, 2):
        grid = [form, 1, m, 0, 32, 1, 1, 0, 0, 0]
        pair = meta_ops.glm_prep_pair(*_meta(A, y, v, v), None, None, None,
                                      m, 0, 0, grid, 0)
        plain = k2.glm_prep_pair_torch(A, y, v, v, glm)
        assert shapes(pair[:8]) == shapes(plain)
        assert tuple(pair[8].shape) == ((2, m) if form else (0, m))
        single = meta_ops.glm_prep(*_meta(A, y, v), None, None, m, 0, grid,
                                   0)
        assert shapes(single[:3]) == shapes(k2.glm_prep_torch(A, y, v,
                                                              glm)[:3])
    lam, ss, Mg = (torch.tensor(t, dtype=dtype) for t in (0.1, 1.0, 2.0))
    x_new, stats = meta_ops.score_update(*_meta(v, v, v, w[:n].abs() + 1),
                                         None, None, *_meta(lam, ss, Mg), 0,
                                         1, n, 0)
    plain = k3.score_update_torch(v, v, v, w[:n].abs() + 1, lam, ss, Mg,
                                  "l1")
    assert x_new.shape == plain.x_new.shape and tuple(stats.shape) == (3,)
    mem = init_memory(n, 5, dtype)
    d = meta_ops.two_loop(*_meta(mem.S, mem.Y, v, mem.pos, mem.count,
                                 mem.H0), 1, n, 3, 0)
    assert d.shape == k4.two_loop_torch(mem, v).shape
    spec = losses.multinom_mglm(k)
    Y, Z, V = rnd(m, k), torch.softmax(rnd(m, k), -1), rnd(n, k)
    want = k5.mglm_matvec_torch(A, Y, Z, V, spec).shape
    out, qu = meta_ops.mglm_matvec(*_meta(A, Z, V), None, 1, m, 1)
    assert out.shape == want and tuple(qu.shape) == (0, k)
    out, qu = meta_ops.mglm_matvec(*_meta(A, Z, V.t().contiguous()), None,
                                   1, m, 0)
    assert out.shape == want and tuple(qu.shape) == (m, k)
