"""Federated rounds and ``local_max_iter`` of the port against scso_tpu
(float64, CPU).

  * `federated_solve` on test_federated.py's ``_prob(512, 24)`` with 8
    clients and ``ProxNSCORE(solver='dense', ss_type=3)``: each round's
    centralized objective to 1e-10 relative, the clients' local epochs
    equal, the returned (best) x to 1e-9 — against the JAX package's
    `federated_solve` (its fleet vmapped on the 8-device CPU mesh);
  * explicit weights with the f_tol early stop, a zero cold start, the
    'gl' problem (the groups repeated per client), a row-sharded input
    (a one-rank gloo mesh: its mesh dropped) and the client axis on a
    one-rank batch mesh (the same bits), and `split_clients`' shapes and
    refusals;
  * ``Options.local_max_iter``: one epoch over the first that many
    mini-batches (the partial batch truncated away when the cap is at
    most the full batches) against the JAX package's
    ``iterate(batch_size=…, local_max_iter=…)``, in both modes (fused
    unshuffled: the JAX package's fused mode draws its permutations with
    jax.random, which the port does not reproduce; timed shuffled).
"""

import functools
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu.parallel import federated_solve as jfederated
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses
from scso_tpu_torch.parallel import (
    Mesh, distributed_init, federated_solve, make_mesh, shard_problem,
    split_clients)

torch.set_num_threads(1)


def _data(m=512, n=24, seed=11):
    return jsynth.make_sparse_logreg_data(
        m, n, density=0.25, n_active=6, seed=seed, dtype=np.float64)


def _prob(pkg, m=512, n=24, seed=11, x0=None, **kw):
    A, y, x0_, _ = _data(m, n, seed)
    x0 = x0_ if x0 is None else x0
    L = jlosses if pkg is scso else losses
    extra = {} if pkg is scso else dict(device="cpu")
    return pkg.Problem(A, y, x0, L.logistic_f, kw.pop("lam", 1e-2),
                       grad_fx=L.logistic_grad, hess_fx=L.logistic_hess,
                       dtype=np.float64 if pkg is scso else torch.float64,
                       **extra, **kw)


METH = lambda pkg: pkg.ProxNSCORE(solver="dense", ss_type=3)
SM = lambda pkg: pkg.PHuberSmootherL1L2(1.0)


@functools.lru_cache(maxsize=None)
def _jax(**kw):
    x0 = kw.pop("zero", False)
    p = _prob(scso, x0=np.zeros(24) if x0 else None)
    weights = kw.pop("weights", None)
    return jfederated(METH(scso), p, "l1", SM(scso),
                      weights=None if weights is None else np.asarray(weights),
                      **kw)


def _same(fed, ref):
    assert fed.rounds == ref.rounds
    np.testing.assert_allclose(fed.obj.numpy(), np.asarray(ref.obj),
                               rtol=1e-10)
    np.testing.assert_array_equal(fed.client_epochs.numpy(),
                                  np.asarray(ref.client_epochs))
    np.testing.assert_allclose(fed.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(fed.client_x.numpy(),
                               np.asarray(ref.client_x), rtol=0, atol=1e-9)


def test_rounds_match_jax():
    kw = dict(n_clients=8, comm_rounds=4, local_epochs=4)
    fed = federated_solve(METH(st), _prob(st), "l1", SM(st), **kw)
    _same(fed, _jax(**kw))
    assert fed.obj.shape == (4,) and fed.client_x.shape == (8, 24)
    # the returned iterate is the best round's average
    p = _prob(st)
    assert float(p.obj("l1", fed.x)) == pytest.approx(float(fed.obj.min()))
    assert "rounds=4" in repr(fed)


def test_weights_and_early_stop_match_jax():
    kw = dict(n_clients=4, comm_rounds=3, local_epochs=3)
    f1 = federated_solve(METH(st), _prob(st), "l1", SM(st), **kw)
    f2 = federated_solve(METH(st), _prob(st), "l1", SM(st),
                         weights=np.ones(4), **kw)
    assert torch.equal(f1.x, f2.x)
    _same(f2, _jax(weights=(1.0,) * 4, **kw))
    kw = dict(n_clients=4, comm_rounds=30, local_epochs=3, f_tol=1e-6)
    f3 = federated_solve(METH(st), _prob(st), "l1", SM(st), **kw)
    assert f3.rounds < 30 and tuple(f3.client_epochs.shape) == (f3.rounds, 4)
    _same(f3, _jax(**kw))
    w = (1.0, 2.0, 3.0, 4.0)
    kw = dict(n_clients=4, comm_rounds=2, local_epochs=3)
    _same(federated_solve(METH(st), _prob(st), "l1", SM(st), weights=w,
                          **kw), _jax(weights=w, **kw))


def test_zero_cold_start_matches_jax():
    """The degenerate f_tol guard: a zero x0 with the default x_star must
    not freeze the local solves at epoch 0."""
    kw = dict(n_clients=8, comm_rounds=3, local_epochs=4)
    fed = federated_solve(METH(st), _prob(st, x0=np.zeros(24)), "l1",
                          SM(st), **kw)
    _same(fed, _jax(zero=True, **kw))
    assert bool((fed.client_epochs > 0).any())


def test_group_lasso_matches_jax():
    """The groups carry the client axis (the fleet batches every tensor
    field)."""
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        256, 24, density=0.25, n_active=6, seed=5, dtype=np.float64)
    pj = scso.Problem(A, y, x0, jlosses.logistic_f, [1e-3, 1e-2],
                      grad_fx=jlosses.logistic_grad,
                      hess_fx=jlosses.logistic_hess,
                      groups=scso.make_contiguous_groups(24, 4),
                      dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.logistic_f, [1e-3, 1e-2],
                    grad_fx=losses.logistic_grad, hess_fx=losses.logistic_hess,
                    groups=st.make_contiguous_groups(24, 4),
                    dtype=torch.float64, device="cpu")
    kw = dict(n_clients=4, comm_rounds=3, local_epochs=4)
    j = jfederated(METH(scso), pj, "gl", scso.PHuberSmootherGL(1.0, pj), **kw)
    fed = federated_solve(METH(st), pt, "gl", st.PHuberSmootherGL(1.0, pt),
                          **kw)
    _same(fed, j)
    assert float(fed.obj.min()) < float(fed.obj[0]) + 1e-12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    distributed_init("gloo", init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_sharded_input_and_batch_mesh(one_rank):
    """A row-sharded input's mesh is dropped (the local solves are
    local), and a one-rank batch mesh over the clients gives the same
    bits, as does a problem row-sharded on a 1×1 ('batch', 'data') mesh
    with its clients over 'batch'; over more data ranks each rank keeps
    the clients whose rows it holds (their parity on 4 ranks:
    tests/test_torch_mesh2d_batch.py), so the clients must be a multiple
    of the data ranks."""
    kw = dict(n_clients=8, comm_rounds=2, local_epochs=4)
    plain = federated_solve(METH(st), _prob(st), "l1", SM(st), **kw)
    sharded = federated_solve(
        METH(st), shard_problem(_prob(st), make_mesh()), "l1", SM(st), **kw)
    on_mesh = federated_solve(METH(st), _prob(st), "l1", SM(st),
                              mesh=make_mesh(axis_names=("batch",)), **kw)
    grid = make_mesh((1, 1), ("batch", "data"))
    on_grid = federated_solve(METH(st), shard_problem(_prob(st), grid), "l1",
                              SM(st), mesh=grid, **kw)
    for f in (sharded, on_mesh, on_grid):
        assert torch.equal(f.x, plain.x)
        assert torch.equal(f.obj, plain.obj)
        assert torch.equal(f.client_epochs, plain.client_epochs)
    cl = split_clients(shard_problem(_prob(st), make_mesh()), 8)
    assert cl.mesh is None and cl.m_total == 64
    two = Mesh(group=None, axis_names=("data",), size=2, rank=0)
    with pytest.raises(ValueError, match="multiple of the 2 ranks"):
        federated_solve(METH(st), replace(_prob(st), mesh=two), "l1",
                        SM(st), **dict(kw, n_clients=7))


def test_split_clients_shapes_and_refusals():
    p = _prob(st)
    cl = split_clients(p, 8)
    assert tuple(cl.A.shape) == (8, 64, 24) and tuple(cl.y.shape) == (8, 64)
    assert torch.equal(cl.A.reshape(512, 24), p.A)
    assert tuple(cl.x0.shape) == (8, 24) and tuple(cl.lam.shape) == (8,)
    assert cl.m_total == 64
    with pytest.raises(ValueError, match="divisible"):
        split_clients(_prob(st, m=510), 8)
    nodata = st.Problem(np.zeros(4), losses.rosenbrock, 1e-3,
                        dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="data problem"):
        split_clients(nodata, 2)
    g = split_clients(replace(p, groups=st.make_contiguous_groups(24, 4)), 8)
    assert tuple(g.groups.segment_ids.shape) == (8, 24)


def _batch_problems(m=400, n=16):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.3, n_active=5, seed=5, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.05,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.05,
                    grad_fx=losses.logistic01_grad, glm=losses.LOGISTIC01_GLM,
                    dtype=torch.float64, device="cpu")
    return pj, pt


@pytest.mark.parametrize("mode,shuffle", [("fused", False), ("timed", True)])
@pytest.mark.parametrize("cap", [2, 4, 7])
@pytest.mark.parametrize("method", ["newton", "lbfgs"])
def test_local_max_iter_matches_jax(method, cap, mode, shuffle):
    """400 rows in batches of 96 (four full batches and one of 16): a cap
    of 2 or 4 takes that many full batches, 7 all five; max_epoch
    becomes 1."""
    make = {"newton": lambda p: p.ProxNSCORE(solver="cg"),
            "lbfgs": lambda p: p.ProxLQNSCORE()}[method]
    pj, pt = _batch_problems()
    kw = dict(batch_size=96, local_max_iter=cap, max_epoch=50, x_tol=1e-12,
              f_tol=1e-12, verbose=0, rng_seed=3, mode=mode,
              shuffle_batch=shuffle)
    sj = scso.iterate(make(scso), pj, "l1", scso.PHuberSmootherL1L2(1.0),
                      **kw)
    s = st.iterate(make(st), pt, "l1", st.PHuberSmootherL1L2(1.0), **kw)
    assert s.epochs == sj.epochs == 1
    assert len(s.obj) == len(sj.obj) == 2
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-9)
    # the truncation itself: one epoch over the first `cap` batches
    nb, _, rem = st.algorithms.iterate._make_batches(
        pt, st.Options(batch_size=96, local_max_iter=cap))
    assert (nb, rem) == ((cap, 0) if cap <= 4 else (4, 16))
