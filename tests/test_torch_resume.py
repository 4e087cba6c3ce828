"""Resume from ``Solution.state``, checkpoints and recovery (CPU).

``Solution.state`` is the whole carry (`iterate.Carry`): a solve resumed
from it must continue bit for bit as the uninterrupted solve, in either
mode, for every path whose state differs: the epoch cache (cached
GGN-CG), the CG warm start and forcing reference (uncached GGN-CG), the
L-BFGS memory and carried gradient, and the mini-batch generator —
with ``stats_every`` 1 and 3 (a resume off the round grid takes the
epochs back to it first, as the JAX package's does). Also: the state
through a ``.npz`` checkpoint (`utils.save_state`/`load_state`), a
template of another structure refused, the state of the JAX package's
kind resumed (the same epochs as its own resume), and
`utils.solve_with_recovery` through injected faults bit for bit the
uninterrupted solve.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch.models import losses
from scso_tpu_torch.utils import (
    load_state, save_state, solution_to_state, solve_with_recovery)

torch.set_num_threads(1)

METHODS = {
    "cached": lambda p, **k: p.ProxGGNSCORE(solver="cg", **k),
    "uncached": lambda p, **k: p.ProxGGNSCORE(solver="cg",
                                              epoch_cache=False, **k),
    "lbfgs": lambda p, **k: p.ProxLQNSCORE(**k),
    "batched": lambda p, **k: p.ProxNSCORE(solver="cg", **k),
}
KW = dict(x_tol=1e-12, f_tol=1e-12, verbose=0, alpha=1.0)


def _problems(test=False):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        400, 16, density=0.3, n_active=5, seed=5, dtype=np.float64,
        label01=True)
    extra = dict(Atest=A[:50], ytest=y[:50]) if test else {}
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.05,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64, **extra)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.05,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    device="cpu", **extra)
    return pj, pt


def _norm(prob, x):
    return torch.linalg.vector_norm(x)


def _run(name, pt, mode, stats_every, max_epoch, resume=None):
    kw = dict(KW, mode=mode, stats_every=stats_every, max_epoch=max_epoch,
              metrics={"xnorm": _norm}, resume_state=resume)
    if name == "batched":
        # damped half steps: full ones on mini-batches run away here
        kw.update(batch_size=96, rng_seed=5, alpha=None)
    return st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                      **kw)


def _bitwise(a, b):
    assert a.epochs == b.epochs
    assert bool(torch.isfinite(a.obj).all() and torch.isfinite(a.x).all())
    assert torch.equal(a.x, b.x)
    for f in ("obj", "fval", "rel", "objrel", "fvaltest"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(torch.nan_to_num(a.pri_res_norm),
                       torch.nan_to_num(b.pri_res_norm))
    assert a.metricvals.keys() == b.metricvals.keys()
    for k in a.metricvals:
        assert torch.equal(a.metricvals[k], b.metricvals[k]), k


@pytest.mark.parametrize("stats_every,at", [(1, 5), (3, 5), (3, 6)])
@pytest.mark.parametrize("mode", ["fused", "timed"])
@pytest.mark.parametrize("name", list(METHODS))
def test_resume_is_bitwise(name, mode, stats_every, at):
    _, pt = _problems(test=True)
    full = _run(name, pt, mode, stats_every, 14)
    part = _run(name, pt, mode, stats_every, at)
    assert part.epochs == at and int(part.state.k) == at
    res = _run(name, pt, mode, stats_every, 14, part.state)
    _bitwise(full, res)
    assert len(res.fvaltest) == len(res.obj)
    # the resumed state is the uninterrupted one's, generator included
    assert torch.equal(full.state.rng, res.state.rng)
    assert torch.equal(full.state.x, res.state.x)


@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_resume_through_a_checkpoint(mode):
    _, pt = _problems(test=True)
    full = _run("batched", pt, mode, 1, 10)
    part = _run("batched", pt, mode, 1, 4)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        save_state(path, part.state)
        flat = load_state(path)
        state = load_state(path, template=part.state)
    assert len(flat) == len([t for t in torch.utils._pytree.tree_leaves(
        part.state) if t is not None])
    assert type(state) is type(part.state)
    assert state.k.dtype == torch.int32 and state.done.dtype == torch.bool
    assert torch.equal(state.hist.obj, part.state.hist.obj)
    _bitwise(full, _run("batched", pt, mode, 1, 10, state))


def test_npz_round_trip_of_any_tree():
    tree = {"a": torch.arange(5, dtype=torch.int64),
            "b": (torch.ones(2, 3, dtype=torch.float32), None,
                  torch.tensor(True)),
            "c": [torch.tensor(2.5, dtype=torch.float64),
                  torch.ones(4, dtype=torch.bfloat16) * 1.5],
            "d": np.arange(3.0)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.npz")
        save_state(path, tree)
        back = load_state(path, template=tree)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"][1] is None and torch.equal(back["b"][0], tree["b"][0])
    assert back["b"][2].dtype == torch.bool and bool(back["b"][2])
    assert back["c"][1].dtype == torch.bfloat16
    assert torch.equal(back["c"][1], tree["c"][1])
    assert isinstance(back["d"], np.ndarray)
    np.testing.assert_array_equal(back["d"], tree["d"])


def test_template_mismatch_raises():
    _, pt = _problems()
    cached = _run("cached", pt, "fused", 1, 3)
    lbfgs = _run("lbfgs", pt, "fused", 1, 3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.npz")
        save_state(path, cached.state)
        # the L-BFGS carry has no epoch cache: another structure
        with pytest.raises(ValueError, match="structure|leaves"):
            load_state(path, template=lbfgs.state)
        with pytest.raises(ValueError, match="leaves"):
            load_state(path, template=(torch.zeros(1),))
        # the same leaf count in another structure
        leaves = load_state(path)
        other = {str(i): t for i, t in enumerate(leaves)}
        with pytest.raises(ValueError, match="structure"):
            load_state(path, template=other)


def test_metrics_must_match_the_resumed_state():
    _, pt = _problems()
    part = _run("cached", pt, "fused", 1, 3)
    with pytest.raises(ValueError, match="metrics"):
        st.iterate(st.ProxGGNSCORE(solver="cg"), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), resume_state=part.state,
                   max_epoch=6, **KW)


def test_solution_to_state():
    _, pt = _problems()
    s = _run("cached", pt, "fused", 1, 3)
    assert solution_to_state(s) is s.state
    s.state = None
    summary = solution_to_state(s)
    np.testing.assert_array_equal(summary["x"], s.x.numpy())
    assert int(summary["epochs"]) == 3


@pytest.mark.parametrize("name", ["cached", "lbfgs"])
def test_epochs_of_a_resume_match_the_jax_package(name):
    """Both packages resume their own fused state and land on the same
    epochs and histories (to 1e-10) as their uninterrupted solves."""
    pj, pt = _problems()
    mj = METHODS[name](scso, kernels="xla")
    kw = dict(KW, max_epoch=12, stats_every=3)
    sj = scso.iterate(mj, pj, "l1", scso.PHuberSmootherL1L2(1.0),
                      **dict(kw, max_epoch=5))
    rj = scso.iterate(mj, pj, "l1", scso.PHuberSmootherL1L2(1.0),
                      resume_state=sj.state, **kw)
    s = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **dict(kw, max_epoch=5))
    r = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   resume_state=s.state, **kw)
    assert r.epochs == rj.epochs
    np.testing.assert_allclose(r.obj.numpy(), np.asarray(rj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), atol=1e-10)


@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_solve_with_recovery(mode):
    """Chunks of 4 epochs, each resumed from the last good state, with a
    transient fault injected into two chunks: the bits of the
    uninterrupted solve. A fault that repeats past ``retries`` raises."""
    _, pt = _problems()
    method = st.ProxNSCORE(solver="cg")
    sm = st.PHuberSmootherL1L2(1.0)
    kw = dict(KW, mode=mode, batch_size=96, rng_seed=2, alpha=None)
    full = st.iterate(method, pt, "l1", sm, max_epoch=14, **kw)
    seen = []

    def fault(chunk, attempt):
        seen.append((chunk, attempt))
        if chunk in (1, 2) and attempt == 0:
            raise RuntimeError("injected")

    rec = solve_with_recovery(method, pt, "l1", sm, chunk_epochs=4,
                              max_chunks=4, retries=1, fault_inject=fault,
                              **kw)
    assert (1, 1) in seen and (2, 1) in seen
    assert rec.epochs == full.epochs == 14 or rec.epochs == 16
    capped = st.iterate(method, pt, "l1", sm, max_epoch=rec.epochs, **kw)
    _bitwise(capped, rec)

    def always(chunk, attempt):
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError, match="persistent"):
        solve_with_recovery(method, pt, "l1", sm, chunk_epochs=4,
                            retries=1, fault_inject=always, **kw)
