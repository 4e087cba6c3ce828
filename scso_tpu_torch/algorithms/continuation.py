"""Smoothing and penalty continuation (μ/λ homotopy) as a solver mode.

Port of `scso_tpu.algorithms.continuation`: solve a sequence of
smoothing parameters μ₀ > μ₁ > … > μ_target (and/or penalties
λ₀ > … > λ_target), each stage warm-started from the last one's
iterate, the final (target) stage with the full epoch budget.

μ and λ enter each stage's solve as tensors: μ as the smoother's field,
a per-solve buffer of a captured solve like λ (`iterate._Buffers`), and
the budget is a buffer of the graph too. So on the card every stage
replays one captured graph (the JAX package's one compiled program for
its non-final stages); the final stage captures once more only where its
budget needs more room for its records (`iterate._capacity`).

As in the JAX package, a 'gl' λ-continuation whose first stage zeroes a
group traps it there: the GL smoother's Hessian vanishes on a zero
group, so its prox threshold is infinite. Keep λ₀ moderate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.iterate import Options, Solution, solve
from scso_tpu_torch.ops.cuda import graph
from scso_tpu_torch.problems import Problem

_FIELDS = ("obj", "fval", "pri_res_norm", "rel", "objrel", "fvaltest",
           "times")


def _concat(parts, get):
    """The stages' records of ``get(stage)``, end to end, without each
    stage boundary's duplicate (stage i's final record is stage i+1's
    first: the same iterate)."""
    segs = []
    for i, s in enumerate(parts):
        a = get(s)
        if i + 1 < len(parts) and a.shape[0] > 0:
            a = a[:-1]
        segs.append(a)
    return torch.cat(segs)


def iterate_continuation(method, model: Problem, reg_name: str, h_mu, *,
                         mu_schedule: Optional[Sequence] = None,
                         lam_schedule: Optional[Sequence] = None,
                         stage_epochs: int = 10,
                         metrics: Optional[dict] = None, alpha=None,
                         max_epoch=1000, x_tol=1e-10, f_tol=1e-10,
                         verbose=1, rng_seed=0, stats_every=1,
                         mode="fused", _capture=True) -> Solution:
    """Homotopy solve: anneal μ (and/or λ) to their targets, then finish.

    ``mu_schedule``: decreasing smoothing values ending at the target
    (the last entry is solved with the full ``max_epoch`` budget, the
    others with ``stage_epochs`` each); None keeps ``h_mu.mu``.
    ``lam_schedule``: the same for the penalty (scalars, or the two-λ
    vectors of 'gl'); None keeps ``model.lam``. Given both, they must
    have the same length (the stages advance in lockstep).

    Every stage solves the true composite problem, so the f_tol test may
    fire in any stage whose λ is the target's: the homotopy then stops.
    Returns a :class:`Solution` whose histories are the stages' end to
    end (boundary duplicates dropped), ``state`` the last stage's, and
    ``cg_info['stages']`` (mu, lam, epochs, seconds and the CUDA graphs
    captured) per stage run. ``_capture=False`` (private) runs each
    stage's graph bodies eagerly (see `iterate.solve`)."""
    mus = list(mu_schedule) if mu_schedule is not None else None
    lams = list(lam_schedule) if lam_schedule is not None else None
    if mus is not None and lams is not None and len(mus) != len(lams):
        raise ValueError(
            f"mu_schedule ({len(mus)}) and lam_schedule ({len(lams)}) "
            "must have the same length")
    n_stage = len(mus) if mus is not None else (
        len(lams) if lams is not None else 1)
    if n_stage == 0:
        raise ValueError("empty continuation schedule")
    names = tuple(sorted(metrics)) if metrics else ()
    fns = tuple(metrics[k] for k in names)
    base = dict(x_tol=x_tol, f_tol=f_tol, stats_every=stats_every,
                verbose=verbose, mode=mode)
    stage_opts = Options(max_epoch=stage_epochs, **base)
    final_opts = Options(max_epoch=max_epoch, **base)
    dt, dev = model.dtype, model.device
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dt).to(dev)

    parts, stages, cg_total = [], [], 0
    cur = model
    for i in range(n_stage):
        final = i == n_stage - 1
        sm_i = dc_replace(h_mu, mu=as_t(mus[i])) if mus is not None else h_mu
        if lams is not None:
            cur = dc_replace(cur, lam=as_t(lams[i]))
        captures = graph.STATS["captures"]
        s = solve(method, cur, reg_name, sm_i,
                  final_opts if final else stage_opts, metric_fns=fns,
                  metric_names=names, alpha=alpha, rng_seed=rng_seed + i,
                  capture=_capture)
        parts.append(s)
        cg_total += (s.cg_info or {}).get("total_cg_iters", 0)
        stages.append(dict(
            mu=float(np.ravel(mus[i])[0]) if mus is not None else None,
            lam=np.asarray(lams[i]).tolist() if lams is not None else None,
            epochs=int(s.epochs), seconds=float(s.times[-1]),
            captures=graph.STATS["captures"] - captures))
        if final:
            break
        # stop on the gap only where λ is already the target's: another
        # λ's gap is to another composite objective (a μ-only homotopy
        # is safe: the true objective does not depend on μ)
        lam_at_target = lams is None or bool(
            np.all(np.asarray(lams[i]) == np.asarray(lams[-1])))
        if float(s.state.frel) <= f_tol and lam_at_target:
            break
        # the next stage starts from this one's padded iterate
        cur = dc_replace(cur, x0=s.state.x.to(dt))

    last = parts[-1]
    hist = {f: _concat(parts, lambda s, f=f: getattr(s, f)) for f in _FIELDS}
    info = dict(last.cg_info or {})
    info["total_cg_iters"] = cg_total
    info["stages"] = stages
    return Solution(
        x=last.x, obj=hist["obj"], fval=hist["fval"],
        pri_res_norm=hist["pri_res_norm"], rel=hist["rel"],
        objrel=hist["objrel"], times=hist["times"],
        epochs=sum(p.epochs for p in parts), model=last.model,
        cg_info=info, state=last.state, fvaltest=hist["fvaltest"],
        metricvals={name: _concat(parts, lambda s, n=name: s.metricvals[n])
                    for name in names})
