"""The solve loop: epochs, histories and the Solution record.

Port of the full-batch path of `scso_tpu.algorithms.iterate`, for
ProxNSCORE and ProxGGNSCORE (cached or uncached) and ProxLQNSCORE — the
default method when ``method`` is None. The JAX
solve is one jitted `lax.while_loop` on the device; here it is an
eager Python loop. Its host reads are the stopping test (one per epoch)
and the CG residual test (one per CG iteration); the history records
stay on the device until the solve ends. The structure is the JAX
package's: with ``stats_every = K > 1`` a TWO-LEVEL loop takes one
stats record per round of K epochs, and with the epoch cache the f_tol
test between records uses the exact per-epoch gap (``gap_now``; off the
cache, the round's gap). Off the cache a stats record costs one f(x)
pass over A; full-batch L-BFGS carries ∇q(x⁺) from one epoch to the
next, so an epoch costs one gradient.

Stopping is the reference's triple test: ‖x⁺−x‖ < x_tol·max(‖x‖, 1),
relative objective gap ≤ f_tol, or primal residual < x_tol. Records are
taken at x_0 … plus a final record at the terminating iterate.

A row-sharded problem (`parallel.shard_problem`) is solved SPMD, one
process per rank, on the cached GGN-CG path: ``obj_star`` and every
stats record come from the all-reduced cache, and every host decision
reads replicated values, so all ranks take the same CG iterations and
epochs. Everything else raises on it before the first collective.

Not ported yet: mini-batches, the timed (python-loop) mode, metrics,
test data and resume (ROADMAP A7, A12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Union

import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProxNSCORE)
from scso_tpu_torch.algorithms.mixed import with_lp_copy
from scso_tpu_torch.algorithms.steps import (
    GLMCache, MOGLMCache, _cg_tol, _cw, _lam_scalar, _resolve_ggn_solver,
    epoch_cache_enabled, lbfgs_step, make_step_fn, prime_glm_cache)
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, init_memory
from scso_tpu_torch.problems import Problem


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-solve configuration (the ported subset of the JAX Options)."""

    max_epoch: int = 1000
    x_tol: float = 1e-10
    f_tol: float = 1e-10
    stats_every: int = 1  # record histories every K epochs (1 = parity)
    verbose: int = 1


class History(NamedTuple):
    fval: torch.Tensor
    obj: torch.Tensor
    rel: torch.Tensor
    objrel: torch.Tensor
    prires: torch.Tensor


class Carry(NamedTuple):
    """Solver state between epochs (the JAX while_loop carry)."""

    x: torch.Tensor
    x_prev: torch.Tensor
    gq: torch.Tensor          # ∇q at x (L-BFGS; zeros otherwise)
    gq_prev: torch.Tensor     # ∇q at x_prev
    d_prev: torch.Tensor      # previous raw direction — CG warm start
    cg_total: int             # cumulative CG iterations
    bnorm_prev: torch.Tensor  # forcing s_ref (NaN until set)
    frel: torch.Tensor        # last recorded relative objective gap
    k: int
    pri_res: torch.Tensor
    done: bool
    mem: LBFGSMemory          # L-BFGS memory (size 1, unused, for GGN)
    fcache: Optional[Union[GLMCache, MOGLMCache]]  # None off the cache


@dataclasses.dataclass
class Solution:
    """Result record; field names mirror the JAX package's Solution.
    Histories are CPU tensors; ``x`` (sliced back to ``n_true``) stays on
    the problem's device, and ``state.x`` keeps the padded iterate for a
    warm start."""

    x: Any
    obj: Any
    fval: Any
    pri_res_norm: Any
    rel: Any
    objrel: Any
    times: Any
    epochs: int
    model: Problem
    cg_info: Optional[dict] = None
    state: Any = None

    def __repr__(self):
        obj = float(self.obj[-1]) if len(self.obj) else float("nan")
        rel = float(self.rel[-1]) if len(self.rel) else float("nan")
        return (f"Solution(epochs={self.epochs}, obj={obj:.6e}, "
                f"rel={rel:.3e}, n={self.x.shape[-1]})")


def _stats(prob: Problem, reg_name: str, x, obj_star, x_tol, f_tol,
           fval=None):
    """One record: (fval, obj, rel, objrel, raw_frel), all 0-d tensors.
    ``fval`` is the cached data loss when the epoch cache carries one;
    None evaluates f(x), one pass over A (never on a row shard, where it
    would be this rank's f alone)."""
    if fval is None:
        if prob.mesh is not None:
            raise NotImplementedError(
                "f(x) on a row-sharded problem off the epoch cache is not "
                "ported yet (ROADMAP A11)")
        fval = prob.f_val(prob.A, prob.y, x)
    obj = fval + prob.reg(reg_name, x)
    x_star = prob.x_star
    if reg_name == "gl":
        # the mean squared error, over the TRUE n under feature padding
        # (the padded coordinates of x and x_star are both exactly 0)
        n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
        rel = torch.sum((x_star - x) ** 2) / n_eff
    else:
        rel = torch.clamp_min(
            torch.linalg.vector_norm(x - x_star)
            / torch.clamp_min(torch.linalg.vector_norm(x_star), 1.0), x_tol)
    raw_frel = torch.abs(obj - obj_star) / torch.abs(obj_star)
    objrel = torch.clamp_min(raw_frel, f_tol)
    return fval, obj, rel, objrel, raw_frel


def _resolve_kernels(method, prob: Problem):
    """'auto' → 'cuda' for data on a CUDA device, 'torch' otherwise.
    'cuda' on data that is not on a CUDA device raises."""
    on_cuda = prob.A.device.type == "cuda"
    if method.kernels == "auto":
        return dc_replace(method, kernels="cuda" if on_cuda else "torch")
    if method.kernels == "cuda" and not on_cuda:
        raise ValueError(
            f"kernels='cuda' needs the problem's data on a CUDA device; it "
            f"is on {prob.A.device} (use kernels='torch' or 'auto')")
    return method


def _check_sharded(method, prob: Problem, reg_name: str):
    """A row-sharded problem runs the cached GGN-CG path only. Anything
    else (ProxNSCORE included) raises here, before the first collective:
    ranks that parted at a collective would wait for each other
    forever."""
    if prob.mesh is None:
        return
    what = None
    if not isinstance(method, ProxGGNSCORE):
        what = type(method).__name__
    elif prob.mglm is not None:
        what = "a multi-output (mglm) problem"
    elif not epoch_cache_enabled(method, prob, reg_name, True):
        what = ("the uncached GGN-CG path (ss_type 2 or 3, "
                "epoch_cache=False, or a spec without loss_sample)")
    if what is not None:
        raise NotImplementedError(
            f"{what} on a row-sharded problem is not ported yet: only "
            "the cached GGN-CG path runs sharded (ROADMAP A11)")


def _effective_L(prob: Problem, alpha):
    """The alpha kwarg overrides L as L = 1/alpha."""
    if alpha is not None:
        return dc_replace(prob, L=torch.tensor(1.0 / alpha, dtype=prob.dtype,
                                               device=prob.device))
    return prob


# AUTO precision-adaptive CG engages from this many bytes of A (of this
# rank's rows): the smallest A at which the cached chain with the bf16
# copy beat the chain without it on the H100 (chip_smoke.py phase 11,
# PERF.md). The JAX package's 2 GiB was measured on a TPU v5e.
_AUTO_LP_MIN_BYTES = 2 * 1024**3
# The same for a multi-output problem, on its cached path, or None: AUTO
# attaches no copy there. On the H100 the cached multinomial chain with
# the copy did not beat the chain without it at 49152×1024×16, and at
# 196608×1024×16 only in some runs (chip_smoke.py phase 13(c), PERF.md).
# The JAX package's 512 MiB was measured on a TPU v5e.
_AUTO_LP_MIN_BYTES_MGLM = None


def _auto_lp(method, prob: Problem, reg_name: str = "l1"):
    """Resolve ProxGGNSCORE.auto_lp: maybe attach a bfloat16 copy of A
    and set cg_lp_tol to the CG floor (precision-adaptive CG through the
    bulk epochs, float32 once the endgame tightens past the floor).

    The JAX package's gates, in its order: ProxGGNSCORE; no explicit
    cg_lp_tol, no cg_adaptive, no curvature_rows; a 2-D data problem
    without a copy yet; a float32 GLM or multi-output GLM (the port
    solves full batches only); the resolved solver 'cg'; a row mesh
    (the port's only kind of mesh, whose copy ``shard_problem`` shards
    with A); for a multi-output problem its cached path, where the copy
    acts (`steps._mo_lp_matvec`). ``auto_lp=None`` then adds the
    measured-win gates: A on a CUDA device (where the JAX package asks
    for a TPU), at least ``_AUTO_LP_MIN_BYTES`` of this rank's rows
    (``_AUTO_LP_MIN_BYTES_MGLM`` for a multi-output problem; None:
    never),
    and 1.55 times A (A, the copy and slack) within 0.85 of the card's
    memory. True skips those three; False disables. A that is already
    bfloat16 (the coarse phase of `iterate_mixed`) gets itself as the
    copy, as in the JAX package."""
    auto = method.auto_lp if isinstance(method, ProxGGNSCORE) else False
    if auto is False:
        return method, prob
    if method.cg_lp_tol != 0.0 or method.cg_adaptive or method.curvature_rows:
        return method, prob
    if prob.A is None or prob.A.ndim != 2 or prob.A_lp is not None:
        return method, prob
    if ((prob.glm is None and prob.mglm is None)
            or prob.x0.dtype != torch.float32):
        return method, prob
    if _resolve_ggn_solver(method, prob, prob.x0) != "cg":
        return method, prob
    if prob.mglm is not None and not epoch_cache_enabled(method, prob,
                                                         reg_name, True):
        return method, prob  # the uncached mglm path never reads a copy
    if auto is None:
        A = prob.A
        if A.device.type != "cuda":
            return method, prob
        nbytes = A.numel() * A.element_size()  # this rank's rows
        min_bytes = (_AUTO_LP_MIN_BYTES_MGLM if prob.mglm is not None
                     else _AUTO_LP_MIN_BYTES)
        if min_bytes is None or nbytes < min_bytes:
            return method, prob
        _, total = torch.cuda.mem_get_info(A.device)
        if nbytes * 1.55 > 0.85 * total:
            return method, prob
    method = dc_replace(method, cg_lp_tol=_cg_tol(method, prob.x0.dtype))
    return method, with_lp_copy(prob)


def solve(method, prob: Problem, reg_name: str, sm, opts: Options,
          alpha=None) -> Solution:
    """Run one solve; returns a :class:`Solution`."""
    if not isinstance(method, (ProxNSCORE, ProxGGNSCORE, ProxLQNSCORE)):
        raise TypeError(f"unknown method {method!r}")
    if prob.A is None or prob.y is None:
        raise NotImplementedError(
            "a problem without data (the f(x) flavour) is not ported yet "
            "(ROADMAP A7)")
    prob = _effective_L(prob, alpha)
    method = _resolve_kernels(method, prob)
    method, prob = _auto_lp(method, prob, reg_name)
    _check_sharded(method, prob, reg_name)
    sync = (torch.cuda.synchronize if prob.device.type == "cuda"
            else lambda: None)
    t0 = time.perf_counter()
    carry, records = _solve_impl(method, prob, reg_name, sm, opts)
    sol = _to_solution(carry, prob, records)
    sync()
    sol.times[-1] = time.perf_counter() - t0
    return sol


def _solve_impl(method, prob: Problem, reg_name: str, sm, opts: Options):
    dt, dev = prob.dtype, prob.device
    A, y = prob.A, prob.y
    scalar = lambda v: torch.tensor(v, dtype=dt, device=dev)
    x_tol, f_tol = opts.x_tol, opts.f_tol
    max_epoch = opts.max_epoch
    is_lbfgs = isinstance(method, ProxLQNSCORE)
    step = make_step_fn(method)
    use_fcache = epoch_cache_enabled(method, prob, reg_name, True)
    if use_fcache:
        # obj_star through the SAME evaluation path as the cached fval:
        # the kernel-accumulated loss and a separate reduction differ by
        # a few ulp-sums, and a mixed-path gap would inherit that offset
        # as a floor
        obj_star = (prime_glm_cache(method, prob, prob.x_star).loss
                    + prob.reg(reg_name, prob.x_star))
    else:
        obj_star = prob.obj(reg_name, prob.x_star)
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    records = []

    def with_stats(c: Carry):
        fval, obj, rel, objrel, raw_frel = _stats(
            prob, reg_name, c.x, obj_star, x_tol, f_tol,
            c.fcache.loss if use_fcache else None)
        records.append((fval, obj, rel, objrel, c.pri_res))
        if opts.verbose > 1:
            _, label = method.display()
            print("--------------------------------\n"
                  f"Optimizer = {label}\nepoch = {c.k}\n"
                  f"obj = {float(obj)}\nfval = {float(fval)}\n"
                  f"pri_res_norm = {float(c.pri_res)}\n"
                  f"rel_error = {float(rel)}")
        return raw_frel

    def step_epoch(c: Carry, raw_frel) -> Carry:
        it = c.k + 1  # 1-based like the reference epoch_t
        if is_lbfgs:
            out = lbfgs_step(method, prob, reg_name, sm, A, y, c.x,
                             c.x_prev, c.gq_prev, it, c.mem, gq_cached=c.gq)
        else:
            out = step(method, prob, reg_name, sm, A, y, c.x, c.x_prev, it,
                       d_prev=c.d_prev, bnorm_prev=c.bnorm_prev,
                       fcache=c.fcache, gq_prev=c.gq_prev, mem=c.mem)
        x, x_prev, pri = out.x_new, c.x, out.pri_res_norm
        conv = ((torch.linalg.vector_norm(x - x_prev)
                 < x_tol * torch.clamp_min(
                     torch.linalg.vector_norm(x_prev), 1.0))
                | (raw_frel <= f_tol) | (pri < x_tol))
        return Carry(x=x, x_prev=x_prev, gq=out.gq_new, gq_prev=out.gq,
                     d_prev=out.d, cg_total=c.cg_total + out.cg_iters,
                     bnorm_prev=out.bnorm, frel=raw_frel, k=c.k + 1,
                     pri_res=pri, done=bool(conv), mem=out.mem,
                     fcache=out.fcache)

    def gap_now(c: Carry):
        """The per-epoch gap between stats rounds: exact from the cached
        loss (O(n)); off the cache the round's gap (a fresh one would
        cost a pass over A)."""
        if not use_fcache:
            return c.frel
        obj_now = c.fcache.loss + prob.reg(reg_name, c.x)
        return torch.abs(obj_now - obj_star) / torch.abs(obj_star)

    x0 = prob.x0
    # full-batch L-BFGS carries ∇q(x⁺) into the next epoch
    gq0 = (prob.grad_f(A, y, x0) + lam * sm.grad(x0, cw) if is_lbfgs
           else torch.zeros_like(x0))
    carry = Carry(x=x0, x_prev=x0, gq=gq0, gq_prev=torch.zeros_like(x0),
                  d_prev=torch.zeros_like(x0), cg_total=0,
                  bnorm_prev=scalar(float("nan")), frel=scalar(float("inf")),
                  k=0, pri_res=scalar(float("nan")), done=False,
                  mem=init_memory(x0.shape[-1], method.m if is_lbfgs else 1,
                                  dt, dev),
                  fcache=(prime_glm_cache(method, prob, x0) if use_fcache
                          else None))
    live = lambda c: not c.done and c.k < max_epoch
    if opts.stats_every <= 1:
        while live(carry):
            carry = step_epoch(carry, with_stats(carry))
    else:
        # stats once per round, then stats_every plain steps, each with
        # gap_now; a finished solve skips the rest of its round
        while live(carry):
            carry = carry._replace(frel=with_stats(carry))
            for _ in range(opts.stats_every):
                if not live(carry):
                    break
                carry = step_epoch(carry, gap_now(carry))
    with_stats(carry)  # final record at the terminating iterate
    return carry, records


def _to_solution(carry: Carry, prob: Problem, records) -> Solution:
    cols = [torch.stack(col).cpu() for col in zip(*records)]
    hist = History(*cols)
    x_out = carry.x
    if prob.n_true is not None:
        x_out = x_out[..., : prob.n_true]  # drop feature padding
    times = torch.zeros(len(records), dtype=torch.float64)
    return Solution(
        x=x_out, obj=hist.obj, fval=hist.fval, pri_res_norm=hist.prires,
        rel=hist.rel, objrel=hist.objrel, times=times, epochs=carry.k,
        model=prob,
        cg_info={"total_cg_iters": carry.cg_total} if carry.cg_total
        else None,
        state=carry)


def iterate(method, model: Problem, reg_name: str, h_mu, *, alpha=None,
            max_epoch=1000, x_tol=1e-10, f_tol=1e-10, verbose=1,
            stats_every=1, mode="fused", **unported) -> Solution:
    """Run a SCORE solve — the JAX package's ``iterate`` entry point for
    full-batch ProxNSCORE, ProxGGNSCORE and ProxLQNSCORE solves.
    ``method=None`` runs ProxLQNSCORE(), the reference's intended
    default."""
    if unported or mode != "fused":
        names = sorted(unported) + ([] if mode == "fused" else ["mode"])
        raise NotImplementedError(
            f"iterate options {names} are not ported yet (ROADMAP A7, A12)")
    if method is None:
        method = ProxLQNSCORE()
    opts = Options(max_epoch=max_epoch, x_tol=x_tol, f_tol=f_tol,
                   stats_every=stats_every, verbose=verbose)
    if verbose > 0 and method.ss_type == 1 and model.L is None \
            and alpha is None:
        print("Neither L nor alpha is set for the problem... "
              "Now fixing alpha = 0.5...")
    return solve(method, model, reg_name, h_mu, opts, alpha=alpha)
