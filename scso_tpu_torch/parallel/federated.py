"""Federated composite optimization: local SCORE epochs + model averaging.

Port of `scso_tpu.parallel.federated`. The reference stores the
federated knobs without a mechanism (``comm_rounds`` is never read;
``local_max_iter`` only truncates the batch list); here, as in the JAX
package:

  * the data rows are split across ``n_clients`` equal shards
    (:func:`split_clients`);
  * each communication round solves EVERY client's local problem as one
    batched solve (`sweep.solve_fleet`: A stacked, each product one
    bmm; on the card one captured graph, the same one every round,
    x0 its buffer), warm-started from the global iterate — with a mesh
    the clients are split over the ranks of its batch axis, and on a
    row-sharded problem each rank solves the clients whose rows it
    holds;
  * the round ends with weighted model averaging (FedAvg; uniform
    weights by default).

Averaging local OPTIMA is not the centralized optimum for non-quadratic
losses: federated averaging settles at a fixed point a few percent
above it. So each round's CENTRALIZED objective is computed (one host
read a round), the best round's average is returned, and the row-sharded
solve (`shard_problem` + `iterate` from ``x0=result.x``) is the
high-precision finisher.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms import batched
from scso_tpu_torch.algorithms.iterate import Options
from scso_tpu_torch.parallel.sweep import solve_fleet
from scso_tpu_torch.problems import Problem

__all__ = ["FederatedResult", "split_clients", "federated_solve"]


@dataclasses.dataclass
class FederatedResult:
    """Per-round trajectory of the global (averaged) model."""

    x: Any               # (n,) BEST global iterate (by centralized obj —
    #                      averaging is not monotone), on the device
    obj: Any             # (R,) centralized objective after each round (CPU)
    rounds: int          # communication rounds executed
    client_epochs: Any   # (R, C) local epochs of each client a round (CPU)
    client_x: Any        # (C, n) final per-client iterates (round R)

    def __repr__(self):
        o = float(self.obj.min()) if len(self.obj) else float("nan")
        return (f"FederatedResult(rounds={self.rounds}, best_obj={o:.6e}, "
                f"clients={self.client_x.shape[0]})")


def _rep(a, C: int):
    """``a`` repeated on a new leading client axis (None stays)."""
    if a is None:
        return None
    a = torch.as_tensor(a)
    return a.expand((C,) + tuple(a.shape)).clone()


def split_clients(prob: Problem, n_clients: int) -> Problem:
    """Shard a data problem's rows into a stacked per-client Problem.

    Rows must divide evenly (silent zero-padding would rescale
    1/m-normalized losses). Client i gets the contiguous rows
    ``[i·m/C, (i+1)·m/C)``; shuffle the rows first for an IID split.
    Every other tensor (x0, λ, L, x*, the bounds, the groups) is
    repeated per client, as the fleet batches every tensor field; the
    test set and the low-precision copy stay out of the local solves,
    and a row-sharded input's mesh is dropped: local solves are local.
    """
    if not prob.has_data:
        raise ValueError("split_clients requires a data problem (A, y)")
    m = prob.A.shape[0]
    if m % n_clients != 0:
        raise ValueError(
            f"m={m} not divisible by n_clients={n_clients}: pad or "
            "subsample the data explicitly (silent padding would rescale "
            "1/m-normalized losses)")
    per = m // n_clients
    C = n_clients
    rows = lambda a: a.reshape((C, per) + tuple(a.shape[1:]))
    return dc_replace(
        prob, A=rows(prob.A), y=rows(prob.y), x0=_rep(prob.x0, C),
        lam=_rep(prob.lam, C), L=_rep(prob.L, C),
        x_star=_rep(prob.x_star, C), lb=_rep(prob.lb, C),
        ub=_rep(prob.ub, C), groups=_rep_fields(prob.groups, C),
        col_sumsq=None, Atest=None, ytest=None, A_lp=None,
        mesh=None, data_axis="data", m_total=per)


def _rep_fields(obj, C: int):
    """The dataclass ``obj`` with its tensors, and those of a field
    holding a dataclass (the groups), repeated per client (None
    stays)."""
    if obj is None:
        return None
    names = batched.tensor_fields(obj)
    return batched.rebuild(obj, batched.map_leaves(
        batched.leaves(obj, names), lambda t: _rep(t, C)))


def _gather_clients(prob: Problem, res):
    """Every data rank's clients' results (x, epochs), in client order,
    on every rank: one gather over the problem's data axis of the fields
    packed exactly into float64, after the fleet's graph has ended."""
    from scso_tpu_torch.parallel.sharding import gather_rows

    if res.x.device.type == "cuda":
        torch.cuda.synchronize(res.x.device)
    n = res.x.shape[-1]
    packed = torch.cat([res.x.to(torch.float64),
                        res.epochs.to(torch.float64)[:, None]], dim=1)
    full = gather_rows(prob.mesh, packed, prob.data_axis)
    return dataclasses.replace(
        res, x=full[:, :n].to(res.x.dtype),
        epochs=full[:, n].to(res.epochs.dtype))


def _stack_smoother(sm, C: int, dt, dev):
    """The smoother with μ and its tensors repeated per client."""
    mu = torch.as_tensor(sm.mu, dtype=dt, device=dev)
    return dc_replace(_rep_fields(sm, C), mu=_rep(mu, C))


def federated_solve(method, prob: Problem, reg_name: str, sm, *,
                    n_clients: int, comm_rounds: int = 10,
                    local_epochs: int = 5, weights=None,
                    opts: Optional[Options] = None, mesh=None,
                    batch_axis: str = "batch", f_tol: float = 0.0,
                    _capture: bool = True) -> FederatedResult:
    """Run federated SCORE: ``comm_rounds`` x (local solves + averaging).

    Args:
      method / reg_name / sm: as in :func:`iterate` — every client runs
        this SCORE solver locally.
      prob: the CENTRALIZED data problem; rows are split evenly across
        ``n_clients`` (:func:`split_clients`). A problem row-sharded over
        D ranks of its data axis keeps its clients where their rows are:
        client i's rows [i·m/C, (i+1)·m/C) lie on one rank (C must be a
        multiple of D), each rank solves its C/D clients as a fleet
        (split further over ``mesh``'s ``batch_axis`` when given: the
        ('batch', 'data') layout), one gather over the data axis gives
        every rank every client's iterate, and the centralized
        objective sums over the rows' ranks: the clients, rounds and
        averages of the unsharded solve.
      comm_rounds: communication rounds (the reference's stored-unused
        ``Options.comm_rounds``, made real).
      local_epochs: local epochs a round for each client.
      weights: (C,) averaging weights; default uniform.
      mesh / batch_axis: split the CLIENT axis over the ranks of a mesh
        axis; every rank gets every client's result each round.
      f_tol: stop once the centralized relative objective change between
        rounds is at most this (0 = run all rounds).

    Returns a :class:`FederatedResult` with per-round centralized
    objectives, computed on the full data.
    """
    dt, dev = prob.dtype, prob.device
    C = n_clients
    D = 1 if prob.mesh is None else prob.mesh.axis_size(prob.data_axis)
    if C % D != 0:
        raise ValueError(
            f"n_clients={C} must be a multiple of the {D} ranks of the "
            f"problem's data axis {prob.data_axis!r}: each client's rows "
            "stay on the rank that holds them")
    clients = split_clients(prob, C // D)
    sms = _stack_smoother(sm, C // D, dt, dev)
    if weights is None:
        w = torch.full((C,), 1.0 / C, dtype=dt, device=dev)
    else:
        w = torch.as_tensor(weights, dtype=dt).to(dev)
        w = w / torch.sum(w)
    base = opts or Options()
    # the degenerate f_tol guard (as the sweep's): with the default
    # x_star = 0 the gap test fires at any zero iterate (a zero cold
    # start, or a round whose average is exactly 0) and would freeze
    # every local solve at epoch 0; local rounds are epoch-capped anyway
    real_star = bool(torch.any(prob.x_star != 0))
    ropts = dataclasses.replace(
        base, max_epoch=local_epochs, verbose=0,
        f_tol=base.f_tol if real_star else -1.0)

    x_global = prob.x0.clone()
    objs, epochs = [], []
    prev = float("inf")
    res = None
    # averaging is not monotone in the centralized objective (few rows
    # per client): the best round's average is returned, not the last
    best_obj, best_x = float("inf"), x_global
    for _ in range(comm_rounds):
        cl = dc_replace(clients, x0=x_global.expand(C // D, -1))
        res = solve_fleet(method, cl, reg_name, sms, opts=ropts, mesh=mesh,
                          batch_axis=batch_axis, _capture=_capture)
        if D > 1:
            res = _gather_clients(prob, res)
        x_global = torch.tensordot(w, res.x, dims=1)
        obj = float(prob.obj(reg_name, x_global))
        objs.append(obj)
        epochs.append(res.epochs.cpu())
        if obj < best_obj:
            best_obj, best_x = obj, x_global
        if f_tol > 0 and math.isfinite(prev):
            if abs(prev - obj) <= f_tol * max(abs(prev), 1.0):
                break
        prev = obj
    n = prob.x0.shape[-1]
    return FederatedResult(
        x=best_x,
        obj=torch.tensor(objs, dtype=torch.float64),
        rounds=len(objs),
        client_epochs=(torch.stack(epochs) if epochs
                       else torch.zeros((0, C), dtype=torch.int32)),
        client_x=(res.x if res is not None else
                  torch.zeros((C, n), dtype=dt, device=dev)))
