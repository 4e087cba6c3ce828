"""Instance-parallel solves: λ/μ regularization paths and fleets.

Port of `scso_tpu.parallel.sweep`. The JAX package solves a path as ONE
`jax.vmap` of its scalar fused solve and a fleet of independent
problems as one vmap over stacked problem leaves. Here both are one
batched solve (`algorithms.batched`): the instances on a leading axis,
every product of the batch one matrix product, each instance the result
of its own scalar solve, and on the card the whole solve one captured
CUDA graph, replayed once a solve and cached per static configuration
(λ, μ, x0 and the budget are its buffers, so the waves of a path and a
polish replay one capture).

With ``mesh`` the instance axis is split over the ranks of the mesh's
``batch_axis``: each rank solves its contiguous share of the instances
on its own card, and one ``all_gather`` over that axis after the solve,
outside any capture, gives every rank the whole result. The problem may
be row-sharded over the mesh's 'data' axis (the JAX package's
('batch', 'data') layout) or over a ('data',) mesh of its own: its row
sums then run inside the batched solve over the data axis only, one
collective for the whole batch. ``plan='auto'`` decides once for the
mesh (`_agreed_latency_s`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms import batched
from scso_tpu_torch.algorithms.batched import BatchSpec, SweepResult
from scso_tpu_torch.algorithms.iterate import Options
from scso_tpu_torch.ops.cuda import graph
from scso_tpu_torch.problems import Problem

__all__ = ["SweepResult", "sweep", "stack_problems", "solve_fleet"]

#: a λ path's per-instance fields
_SWEEP = BatchSpec(prob=("lam", "x0"), sm=("mu",))


def _dispatch_latency_s(device: torch.device) -> float:
    """Measured latency of one launch on ``device`` (seconds), measured
    once a process and device (`_measured_latency_s`), so that calls
    with the same inputs pick the same plan. The decisive input to the
    plan rule."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _measured_latency_s(str(device))


@functools.lru_cache(maxsize=None)
def _measured_latency_s(device: str) -> float:
    """On a CUDA device the best of three replays of a captured trivial
    graph, each ended by ``torch.cuda.synchronize()``; on the CPU the
    best of three calls of a trivial op."""
    device = torch.device(device)
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    if device.type == "cuda":
        g = graph.capture(lambda: x.add_(1.0), device)
        launch = g.replay
        sync = lambda: torch.cuda.synchronize(device)
    else:
        launch = lambda: x.add_(1.0)
        sync = lambda: None
    launch()
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        launch()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


#: device-class throughput for the plan='auto' estimate; the order of
#: magnitude is all the rule needs (the two regimes it separates differ
#: by 100-1000x). 'cuda': the H100 SXM datasheet, 3.35 TB/s of HBM3 and
#: 67 TFLOP/s FP32 without TF32 (the batched solve's products run in
#: FP32 with TF32 off). 'cpu': the JAX package's rough host figures.
_PLAN_BW_BYTES_S = {"cuda": 3.35e12, "cpu": 20e9}
_PLAN_FLOPS_S = {"cuda": 67e12, "cpu": 2e11}
_PLAN_PASSES = 3        # data passes per epoch (step + stats)
_PLAN_WARM_EPOCHS = 10  # mean epochs of a warm wave (the JAX package's)


def _largest_wave_count(B: int, cap: int = 16, ndev: int = 1) -> int:
    """Largest divisor of B in [2, cap] whose per-wave batch also divides
    the mesh's batch axis (0 if none — prime/tiny grids)."""
    for w in range(min(cap, B), 1, -1):
        if B % w == 0 and (B // w) % ndev == 0:
            return w
    return 0


def _agreed_latency_s(prob: Problem, mesh) -> float:
    """The launch latency the plan rule reads: this rank's measured one
    (`_dispatch_latency_s`), and on a mesh of several ranks the largest
    over them (one all_reduce MAX over the whole mesh, the sweep's or
    else the problem's), so that every rank decides from the same input
    and runs the same plan. Each rank measures its own latency, once a
    process, and the H100 sits near the rule's threshold: ranks that
    decided alone ran different numbers of waves, whose gathers then no
    longer matched. The max and not rank 0's value: no rank is special,
    and the slowest rank's launches bound a wave of them all, since
    every wave ends in a collective. A 2-D mesh agrees over all its
    ranks, not one axis: a ('batch', 'data') mesh's data groups sum over
    ranks of different batch lines."""
    lat = _dispatch_latency_s(prob.device)
    mesh = mesh if mesh is not None else prob.comm_mesh
    if mesh is None or mesh.size <= 1:
        return lat
    dev = prob.device if dist.get_backend(mesh.group) == "nccl" else "cpu"
    t = torch.tensor([lat], dtype=torch.float64, device=dev)
    if t.device.type == "cuda":
        # a captured solve's collectives have ended before an eager one
        torch.cuda.synchronize(t.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t[0])


def _resolve_plan(plan: str, prob: Problem, B: int, opts: Options,
                  ndev: int, mesh=None) -> tuple:
    """(path_waves, wave_max_epoch) for a named execution plan.

    Waves buy fewer epochs per instance but pay one launch of the solve
    per wave; they win wall-clock iff a wave's compute dominates that
    latency. One warm wave's compute is estimated as WARM_EPOCHS x
    t_epoch, t_epoch = max(PASSES x bytes(A) / BW — with A shared, an
    epoch reads A the same times whatever the batch — and PASSES x
    2·m·n·Bw / FLOPS), and waves are taken iff that exceeds 4x the
    latency, agreed over the ranks of ``mesh`` (`_agreed_latency_s`;
    launch overhead < 25% a wave). 'quality' always waves (W = largest
    divisor of B in [2, 16], warm cap max_epoch/4); 'throughput'
    never."""
    if plan == "throughput":
        return 0, None
    W = _largest_wave_count(B, ndev=ndev)
    if W == 0:
        _plan_warn(f"plan={plan!r}: grid size {B} has no divisor in "
                   "[2, 16] — falling back to the cold one-dispatch plan")
        return 0, None
    cap = max(5, opts.max_epoch // 4)
    if plan == "quality":
        return W, cap
    # plan == 'auto'
    if prob.A is None:
        return 0, None  # data-less problems: per-epoch work unknown; cold
    if _wave_s(prob, B // W) > 4.0 * _agreed_latency_s(prob, mesh):
        return W, cap
    return 0, None


def _wave_s(prob: Problem, Bw: int) -> float:
    """The plan rule's estimate of one warm wave of ``Bw`` instances
    (seconds): WARM_EPOCHS x t_epoch (`_resolve_plan`), from A's global
    shape, as the JAX package's rule reads it: on a row shard all ranks'
    rows (``m_total``), on a column shard all columns."""
    m, n = prob.m_total, prob.A.shape[-1]
    itemsize = prob.A.element_size()
    dev = "cuda" if prob.device.type == "cuda" else "cpu"
    t_epoch = max(
        _PLAN_PASSES * m * n * itemsize / _PLAN_BW_BYTES_S[dev],
        _PLAN_PASSES * 2.0 * m * n * Bw / _PLAN_FLOPS_S[dev],
    )
    return _PLAN_WARM_EPOCHS * t_epoch


_plan_warned: set = set()


def _plan_warn(msg):
    if msg not in _plan_warned:
        _plan_warned.add(msg)
        warnings.warn(msg, stacklevel=3)


def _axis_size(mesh, batch_axis: str) -> int:
    if mesh is None:
        return 1
    return mesh.axis_size(batch_axis)


def _grid(g, B, dt, dev, like) -> torch.Tensor:
    """A grid as a tensor of the problem's dtype on its device; None
    broadcasts ``like`` (a problem's λ or a smoother's μ) to B
    instances."""
    if g is None:
        t = torch.as_tensor(like, dtype=dt, device=dev)
        return t.expand((B,) + tuple(t.shape)).clone()
    if isinstance(g, torch.Tensor):
        return g.to(device=dev, dtype=dt)
    return torch.as_tensor(np.asarray(g), dtype=dt, device=dev)


def _gather(mesh, res: SweepResult, batch_axis: str) -> SweepResult:
    """Every rank's instances, in rank order along ``batch_axis``, on
    every rank: one all_gather over that axis's group of the fields
    packed exactly into float64."""
    fields = [f.name for f in dataclasses.fields(SweepResult)]
    parts = [getattr(res, f) for f in fields]
    B = res.x.shape[0]
    flat = torch.cat([p.reshape(B, -1).to(torch.float64) for p in parts],
                     dim=1)
    if flat.device.type == "cuda":
        # the batched solve's graph has ended before an eager collective
        # (NCCL_GRAPH_MIXING_SUPPORT=0 leaves the two unordered otherwise)
        torch.cuda.synchronize(flat.device)
    group = mesh.axis_group(batch_axis)
    via_host = (flat.device.type == "cuda"
                and dist.get_backend(group) == "gloo")
    send = flat.cpu() if via_host else flat.contiguous()
    got = [torch.empty_like(send)
           for _ in range(mesh.axis_size(batch_axis))]
    dist.all_gather(got, send, group=group)
    full = torch.cat(got).to(flat.device)
    out, lo = {}, 0
    for f, p in zip(fields, parts):
        width = p[0].numel() if p.ndim > 1 else 1
        out[f] = full[:, lo:lo + width].reshape(
            (full.shape[0],) + tuple(p.shape[1:])).to(p.dtype)
        lo += width
    return SweepResult(**out)


def _solve(method, prob: Problem, reg_name: str, sm, opts: Options,
           spec: BatchSpec, mesh, batch_axis: str, capture: bool,
           rng_seed: int = 0, **kw) -> SweepResult:
    """One batched solve of the instances of ``prob``/``sm``; with a
    mesh each rank of its ``batch_axis`` solves its contiguous share and
    the results are gathered over that axis. A row-sharded problem
    (its rows on another axis of the mesh, or on a mesh of its own)
    sums its rows over its data axis inside the solve."""
    B = prob.x0.shape[0]
    size = _axis_size(mesh, batch_axis)
    if size > 1:
        if B % size != 0:
            raise ValueError(
                f"batch size {B} must be divisible by mesh axis "
                f"'{batch_axis}' size {size}")
        r = mesh.axis_rank(batch_axis)
        lo, hi = r * B // size, (r + 1) * B // size
        prob = batched.take(prob, spec.prob, lo, hi)
        sm = batched.take(sm, spec.sm, lo, hi)
    res = batched.solve(method, prob, reg_name, sm, opts, spec,
                        capture=capture, rng_seed=rng_seed, **kw)
    return _gather(mesh, res, batch_axis) if size > 1 else res


def _star_is_zero(prob: Problem) -> bool:
    return not bool(torch.any(prob.x_star != 0))


def sweep(method, prob: Problem, reg_name: str, sm, *,
          lam_grid=None, mu_grid=None, x0_grid=None, opts: Options = None,
          mesh=None, batch_axis: str = "batch", rng_seed: int = 0,
          path_waves: int = 0, wave_max_epoch: Optional[int] = None,
          plan: Optional[str] = None, _capture: bool = True) -> SweepResult:
    """Solve a (λ, μ) regularization path as one batched solve.

    Args:
      method / prob / reg_name / sm / opts: as in :func:`iterate.solve`;
        ``prob`` and ``sm`` are the template instance.
      lam_grid: (B,) or (B, k) penalty values; None keeps ``prob.lam``.
      mu_grid: (B,) smoothing values; None keeps ``sm.mu``.
      x0_grid: (B, n) per-instance initial iterates; None cold-starts
        every instance from ``prob.x0``. E.g. polish a ``path_waves``
        result with one wide solve, ``sweep(..., x0_grid=warm.x)``. Not
        combinable with ``path_waves``.
      mesh / batch_axis: split the instance axis over the ranks of this
        mesh axis (B must divide their number). ``prob`` may be
        row-sharded over another axis of the same mesh (the JAX
        package's ('batch', 'data') layout), or over a mesh of its own
        with ``mesh=None`` (a ('data',) mesh: the batch is not split).
      rng_seed: the seed of the mini-batches' permutations
        (``opts.batch_size``, ``slice_samples``): one seed for every
        instance, as the JAX package's vmapped solve takes it, so that
        every instance sees the same batches.
      path_waves: 0 solves all B instances at once, each from
        ``prob.x0``. W ≥ 2: glmnet-style pathwise warm starts — the grid
        sorted descending (by λ, or by μ without a lam_grid), split into
        W contiguous waves, wave w's instances starting from wave w−1's
        solutions; every wave replays one capture, and the results come
        back in grid order.
      wave_max_epoch: epoch cap of the warm waves (wave 1 on); needs
        ``path_waves >= 2``.
      plan: 'throughput' (one wide cold solve), 'quality' (waves: W the
        largest divisor of B in [2, 16], warm cap max_epoch/4) or 'auto'
        (`_resolve_plan`: a wave's estimated compute against the
        measured launch latency); exclusive with ``path_waves``.
      _capture: False runs the bodies eagerly on the card (the reference
        form of the captured solve).

    Returns a :class:`SweepResult` with leading axis B, on the problem's
    device.
    """
    opts = opts or Options()
    if lam_grid is None and mu_grid is None:
        raise ValueError("provide lam_grid and/or mu_grid")
    B = None
    for g in (lam_grid, mu_grid):
        if g is not None:
            gB = len(g)
            if B is not None and gB != B:
                raise ValueError("lam_grid and mu_grid batch sizes differ")
            B = gB
    dt, dev = prob.dtype, prob.device
    had_lam = lam_grid is not None
    lam_grid = _grid(lam_grid, B, dt, dev, prob.lam)
    mu_grid = _grid(mu_grid, B, dt, dev, sm.mu)

    if plan is not None:
        if plan not in ("throughput", "quality", "auto"):
            raise ValueError(
                f"plan={plan!r}: choose 'throughput' | 'quality' | 'auto'")
        if path_waves:
            raise ValueError("pass either plan= or path_waves=, not both")
        if wave_max_epoch is not None:
            raise ValueError("wave_max_epoch is chosen by the plan; pass "
                             "path_waves= to control it by hand")
        path_waves, wave_max_epoch = _resolve_plan(
            plan, prob, B, opts, _axis_size(mesh, batch_axis), mesh)

    if path_waves >= 2:
        if x0_grid is not None:
            raise ValueError("x0_grid cannot be combined with path_waves "
                             "(waves manage their own warm starts)")
        return _sweep_path(method, prob, reg_name, sm, opts, lam_grid,
                           mu_grid, had_lam, int(path_waves), mesh,
                           batch_axis, wave_max_epoch, _capture, rng_seed)
    if wave_max_epoch is not None:
        raise ValueError("wave_max_epoch requires path_waves >= 2")

    n_shape = tuple(prob.x0.shape)
    if x0_grid is not None:
        x0_grid = _grid(x0_grid, B, dt, dev, None)
        if tuple(x0_grid.shape) != (B,) + n_shape:
            raise ValueError(f"x0_grid shape {tuple(x0_grid.shape)} != "
                             f"{(B,) + n_shape}")
        # with the default x_star = 0 the f_tol gap test fires for any
        # instance started at exactly 0 (a fully sparse wave solution)
        if _star_is_zero(prob):
            opts = dataclasses.replace(opts, f_tol=-1.0)
    else:
        x0_grid = prob.x0.expand((B,) + n_shape).clone()
    bprob = dc_replace(prob, lam=lam_grid, x0=x0_grid)
    return _solve(method, bprob, reg_name, dc_replace(sm, mu=mu_grid),
                  opts, _SWEEP, mesh, batch_axis, _capture, rng_seed)


def _sweep_path(method, prob, reg_name, sm, opts, lam_grid, mu_grid,
                sort_by_lam, W, mesh, batch_axis, wave_max_epoch,
                capture, rng_seed=0) -> SweepResult:
    """Pathwise warm-started sweep: W sequential waves of B/W instances,
    sorted by descending λ (or μ), wave w's instance j started from wave
    w−1's instance j. Every wave replays one capture."""
    B = lam_grid.shape[0]
    if B % W != 0:
        raise ValueError(f"path_waves={W} must divide the grid size {B}")
    Bw = B // W
    ndev = _axis_size(mesh, batch_axis)
    if Bw % ndev != 0:
        raise ValueError(
            f"per-wave batch {Bw} (= {B}/{W} waves) must be divisible by "
            f"mesh axis '{batch_axis}' size {ndev}; use fewer waves or a "
            "larger grid")
    # with the degenerate default x_star = 0, any iterate at exactly 0
    # passes the f_tol gap test, and a wave warm-started from a fully
    # sparse neighbour sits there: the gap test is off for the waves
    # unless the caller gave a real x_star
    if _star_is_zero(prob):
        opts = dataclasses.replace(opts, f_tol=-1.0)
    key = (lam_grid if sort_by_lam else mu_grid).cpu().numpy()
    if key.ndim > 1:  # multi-λ (gl [λ1, λ2]): order by the total penalty
        key = key.reshape(key.shape[0], -1).sum(axis=1)
    order = np.argsort(-key, kind="stable")
    idx = torch.from_numpy(order).to(lam_grid.device)
    lam_w = lam_grid[idx].reshape((W, Bw) + tuple(lam_grid.shape[1:]))
    mu_w = mu_grid[idx].reshape((W, Bw) + tuple(mu_grid.shape[1:]))
    warm = opts if wave_max_epoch is None else dataclasses.replace(
        opts, max_epoch=int(wave_max_epoch))
    width = max(opts.max_epoch, warm.max_epoch) + 1
    x0 = prob.x0.expand((Bw,) + tuple(prob.x0.shape)).clone()
    parts = []
    for w in range(W):
        res = _solve(method, dc_replace(prob, lam=lam_w[w], x0=x0),
                     reg_name, dc_replace(sm, mu=mu_w[w]),
                     opts if w == 0 else warm, _SWEEP, mesh, batch_axis,
                     capture, rng_seed, width=width)
        parts.append(res)
        x0 = res.x
    inv = torch.from_numpy(np.argsort(order, kind="stable")).to(idx.device)
    cat = lambda f: torch.cat([getattr(r, f) for r in parts])[inv]
    return SweepResult(**{f.name: cat(f.name)
                          for f in dataclasses.fields(SweepResult)})


def stack_problems(items):
    """Stack a list of same-structure Problems (or smoothers) into one
    batched one: every tensor field, the smoother's μ, and the tensors of
    a field holding a dataclass (the groups) get a leading instance
    axis; every other field must be the same object or value in all of
    them. A Problem keeps its own row count as ``m_total``."""
    first = items[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(p, f.name) for p in items]
        v0 = vals[0]
        if isinstance(v0, torch.Tensor) or (
                f.name == "mu" and not isinstance(first, Problem)):
            out[f.name] = torch.stack([
                v if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=torch.float64) for v in vals])
        elif f.name in batched.tensor_fields(first):
            out[f.name] = stack_problems(vals)
        elif any(v is not v0 and v != v0 for v in vals):
            raise ValueError(f"stack_problems: field {f.name!r} differs "
                             "between the instances")
    return dc_replace(first, **out)


def _fleet_spec(probs: Problem, sms) -> BatchSpec:
    """Every tensor field of a stacked fleet, and of its smoothers."""
    return BatchSpec(prob=batched.tensor_fields(probs),
                     sm=batched.tensor_fields(sms))


def solve_fleet(method, probs: Problem, reg_name: str, sms, *,
                opts: Options = None, mesh=None, batch_axis: str = "batch",
                rng_seed: int = 0, _capture: bool = True) -> SweepResult:
    """Solve a fleet of independent problems (stacked fields, axis 0;
    build them with :func:`stack_problems`). ``sms`` is the stacked
    smoothers, or one smoother for every instance. With a mesh the
    instances are split over the ranks of ``batch_axis``. A stacked A
    makes each product of the batch one batched product (bmm). The
    instances may be row-sharded over a data axis (stacked row shards
    of one mesh); ``rng_seed`` seeds the mini-batches, as in
    :func:`sweep`."""
    opts = opts or Options()
    B = probs.x0.shape[0]
    spec = _fleet_spec(probs, sms)
    mu = torch.as_tensor(sms.mu).to(dtype=probs.dtype, device=probs.device)
    if mu.ndim == 0:
        # one smoother for all: only its μ gets the instance axis
        mu = mu.expand(B).clone()
        spec = spec._replace(sm=("mu",))
    sms = dc_replace(sms, mu=mu)
    return _solve(method, probs, reg_name, sms, opts, spec, mesh,
                  batch_axis, _capture, rng_seed)
