"""The GGN-CG SCORE step on the epoch-cache path — the main-path slice.

Port of the parts of `scso_tpu.algorithms.steps` that the main path
runs: prox-GGN with matrix-free CG on a GLM spec, ss_type=1, the
epoch-fused cache (`GLMCache`), tightening-only CG forcing, and the
SCORE-damped prox tail with optional greedy damping. One epoch:

  1. the cached RHS, weights and Jacobi diagonal (`_ggn_cg_from_cache`);
  2. warm-started Jacobi-preconditioned CG, one K1 launch per iteration;
  3. the damped candidate (K3, `_damped_prox_update`);
  4. the undamped trial candidate;
  5. one K2 pass that prices both candidates and builds the next
     epoch's cache (`_greedy_update_cached`) — or, with greedy off, the
     same kernel at (x⁺, x⁺) re-primes it (`_damped_update_cached`).

``method.kernels`` ('cuda' or 'torch', resolved by `iterate`) picks the
CUDA kernels or their plain versions for steps 2, 3 and 5. Newton and
L-BFGS steps, the uncached GGN paths, the dense solves, step-size modes
2 and 3, multi-output GLMs and the low-precision CG copy are not ported
yet (ROADMAP A7, A9, A10).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from scso_tpu_torch.algorithms.methods import ProxGGNSCORE
from scso_tpu_torch.ops.cuda.glm_prep import (
    glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
from scso_tpu_torch.ops.cuda.matvec import normal_matvec, normal_matvec_torch
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)
from scso_tpu_torch.ops.linalg import cg_solve
from scso_tpu_torch.ops.prox import prox_step
from scso_tpu_torch.ops.smoothers import get_Mg
from scso_tpu_torch.problems import Problem


class GLMCache(NamedTuple):
    """Cross-epoch GLM prep, all at the CURRENT iterate x: computed by
    the previous epoch's dual-candidate pass for whichever candidate won,
    or by the priming pass at x0. ``loss`` is the normalized data loss
    f(x), which doubles as the stats record's fval."""

    w: torch.Tensor       # (m,) CG matvec weights at x
    b_raw: torch.Tensor   # (n,) Aᵀ·ρ(y, A·x)
    hd_raw: torch.Tensor  # (n,) Σᵢ wᵢ·Aᵢⱼ² (Jacobi diagonal, data part)
    loss: torch.Tensor    # ()   f(x)


class StepOut(NamedTuple):
    x_new: torch.Tensor
    pri_res_norm: torch.Tensor
    dx: torch.Tensor
    d: torch.Tensor        # raw (undamped) direction — CG warm start seed
    cg_iters: int
    bnorm: torch.Tensor    # forcing s_ref (first outer step length)
    fcache: GLMCache       # the cache at x_new


# solver='auto' switches to CG once the materialized Jacobian would
# exceed this many elements (the JAX package's budget)
_DENSE_GGN_MAX_ELEMS = 1 << 24


def _resolve_ggn_solver(method, prob: Problem, As, x) -> str:
    """'auto' → 'cg' when the m·n Jacobian exceeds the dense budget and a
    GLM spec gives the matrix-free pieces, else 'auto' (the dense
    branches, not ported yet)."""
    if method.solver != "auto":
        return method.solver
    m, n = As.shape[0], x.shape[-1]
    if m * n > _DENSE_GGN_MAX_ELEMS and prob.glm is not None:
        warnings.warn(
            f"ProxGGNSCORE(solver='auto'): J would be {m}x{n} "
            f"(> {_DENSE_GGN_MAX_ELEMS} elements) — using matrix-free "
            "GGN-CG.", stacklevel=3)
        return "cg"
    return "auto"


def _lam_scalar(lam):
    """λ[0] when multi-valued, else λ, as a 0-d tensor."""
    if lam.ndim >= 1 and lam.shape[0] > 1:
        return lam.reshape(-1)[0]
    return lam.reshape(())


def _cw(prob: Problem, reg_name: str):
    """Group element-weights for 'gl' (not ported yet), None otherwise."""
    if reg_name == "gl":
        raise NotImplementedError(
            "the group-lasso regularizer is not ported yet (ROADMAP A8)")
    return None


def _resolve_step_size(method, prob: Problem, x):
    """ss_type=1: min(1/L, 1) when L is set, else 0.5."""
    if method.ss_type != 1:
        raise NotImplementedError(
            "step-size modes 2 (inverse BB) and 3 (Armijo) are not ported "
            "yet (ROADMAP A7)")
    if prob.L is not None:
        return torch.clamp_max(1.0 / prob.L, 1.0)
    return torch.tensor(0.5, dtype=x.dtype, device=x.device)


def _damped_prox_update(method, prob: Problem, reg_name, sm, x, d,
                        step_size, lam, lgr, Hr_diag):
    """SCORE damping + scaled prox, the tail of every step:
    α = ss/(1 + M_g·η), η = sqrt(λgr'·diag(1/Hr)·λgr), safe = min(1, α),
    x⁺ = prox(x + safe·d; threshold ss·λ·Hr) — K3, or its plain version.
    Returns (x⁺, ‖x⁺ − x‖, safe·d)."""
    # feature-padded problems damp with the TRUE n (get_Mg depends on n)
    n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
    Mg = get_Mg(sm.Mh, sm.nu, sm.mu, n_eff)
    update = score_update if method.kernels == "cuda" else score_update_torch
    out = update(x, d, lgr, Hr_diag, lam, step_size, Mg, reg_name,
                 use_prox=method.use_prox, lb=prob.lb, ub=prob.ub)
    return out.x_new, out.pri, out.safe * d


def use_greedy(method, n=None, prob=None) -> bool:
    """Resolve greedy_alpha None = AUTO: on for ss_type=1 AND n >= 4096
    AND (when ``prob`` is given) a GLM ``loss_z`` to price the trial.

    The n >= 4096 rule changes the trajectory, so it is kept as the JAX
    package has it, for parity. It was measured there on a TPU v5e
    (n = 10112: 41 vs 120 epochs; n = 1024: 29 vs 21) and has not been
    measured on the H100. Explicit True/False always wins."""
    g = method.greedy_alpha
    if g is None:
        if method.ss_type != 1:
            return False
        if prob is not None and (prob.glm is None
                                 or prob.glm.loss_z is None):
            return False
        return n is None or n >= 4096
    return bool(g)


def _cg_tol(method, dtype) -> float:
    """The CG forcing floor: method.cg_tol if > 0, else AUTO — 3e-4 in
    float32 (the JAX package's measured knee for 1e-6 gaps), sqrt(eps)
    in float64; never below 4·eps."""
    eps = torch.finfo(dtype).eps
    if method.cg_tol > 0:
        tol = method.cg_tol
    elif dtype == torch.float32:
        tol = 3e-4
    else:
        tol = eps ** 0.5
    return max(tol, 4.0 * eps)


def _forcing_tol(method, b, x, x_prev, ref_prev, it: int, endgame=False):
    """(tol, step_ref) for the CG solve.

    ``endgame=True`` (float32 and below): TIGHTENING-ONLY forcing,
    η_k = clip(0.9·(‖x_k − x_{k−1}‖/s_ref)², 4·eps, cg_tol) — the bulk
    phase keeps the cg_tol floor and the endgame refines the direction
    as the steps shrink, removing the inexact-CG fixed point near the
    optimum. ``method.cg_adaptive``: Eisenstat–Walker-style
    η_k = clip(0.9·ratio², cg_tol, 0.1). Otherwise the fixed floor.
    s_ref is the first nonzero step length (NaN until set)."""
    fin = torch.finfo(b.dtype)
    floor = _cg_tol(method, b.dtype)
    nan = torch.full((), float("nan"), dtype=b.dtype, device=b.device)
    if endgame and fin.bits > 32:
        endgame = False
    if method.cg_adaptive:
        lo, hi, first = floor, 0.1, 0.1
    elif endgame:
        lo, hi, first = 4.0 * fin.eps, floor, floor
    else:
        return floor, nan
    dxn = torch.linalg.vector_norm(x - x_prev)
    rp = nan if ref_prev is None else ref_prev
    unset = torch.isnan(rp) | (rp <= 0)
    ref = torch.where(unset & (dxn > 0), dxn, rp)
    ratio = dxn / torch.clamp_min(ref, fin.tiny)
    eta = torch.clamp(0.9 * ratio * ratio, lo, hi)
    if it <= 1:
        return torch.full_like(eta, first), ref
    return torch.where(torch.isnan(ref), torch.full_like(eta, first),
                       eta), ref


def _loss_scale(g, m_total):
    """loss_z = scale · Σ loss_sample."""
    return (1.0 / m_total) if g.sample_normalized else 1.0


def epoch_cache_enabled(method, prob: Problem, reg_name: str,
                        full_batch: bool) -> bool:
    """Predicate for the epoch-fused cache path: ProxGGNSCORE on the CG
    solver with ss_type=1, a GLM spec with loss_z, loss_sample and the
    stable ggn_rw/ggn_w forms, full-batch data. The uncached path is not
    ported yet (ROADMAP A7), so a solve that fails this raises."""
    if not isinstance(method, ProxGGNSCORE) or method.ss_type != 1:
        return False
    if method.epoch_cache is False:
        return False
    if prob.A.ndim != 2:
        return False
    g = prob.glm
    if (g is None or g.loss_z is None or g.loss_sample is None
            or g.ggn_rw is None or g.ggn_w is None):
        return False
    if not full_batch:
        return False
    return _resolve_ggn_solver(method, prob, prob.A, prob.x0) == "cg"


def prime_glm_cache(method, prob: Problem, x, As=None, ys=None) -> GLMCache:
    """Build the epoch cache at iterate x: the K2 kernel with both
    candidates = x (one pass over A), or the plain single-candidate
    prep."""
    As = prob.A if As is None else As
    ys = prob.y if ys is None else ys
    g = prob.glm
    scale = _loss_scale(g, As.shape[0])
    if method.kernels == "cuda":
        pp = glm_prep_pair(As, ys, x, x, g)
        return GLMCache(pp.w_t, pp.b_t, pp.hd_t, pp.loss_t * scale)
    w, b, hd, loss = glm_prep_torch(As, ys, x, g)
    return GLMCache(w, b, hd, loss * scale)


def _ggn_cg_from_cache(method, prob: Problem, As, x, gr, Hr_diag, lam,
                       cache: GLMCache, d_prev, it, bnorm_prev, x_prev):
    """GGN-CG direction with no prep pass over A: RHS, matvec weights and
    Jacobi diagonal come from the cache; only the smoother terms
    (λ·gr, λ·Hr) are fresh. Each CG iteration is one K1 launch."""
    lhr = lam * Hr_diag
    b = -(cache.b_raw + lam * gr)
    diag = torch.clamp_min(cache.hd_raw + lhr, torch.finfo(x.dtype).tiny)
    w = cache.w
    matvec = normal_matvec if method.kernels == "cuda" else normal_matvec_torch
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = cg_solve(lambda v: matvec(As, w, v) + lhr * v, b, d_prev,
                   tol=tol, maxiter=method.cg_maxiter,
                   M_inv=lambda v: v / diag)
    return res.x, res.iters, bnorm


def _greedy_update_cached(method, prob: Problem, reg_name, sm, As, ys,
                          x, d, step_size, lam, lgr, Hr_diag,
                          cache: GLMCache):
    """Greedy SCORE damping through the dual-candidate pass: trial the
    UNDAMPED prox step and accept it iff the true composite objective
    strictly decreases, else take the SCORE-damped step. One K2 call
    prices both candidates and builds both caches; the winner's becomes
    the new cache. A NaN trial loss fails the strict test."""
    x_damped, pri_d, dx_d = _damped_prox_update(
        method, prob, reg_name, sm, x, d, step_size, lam, lgr, Hr_diag)
    if method.use_prox:
        x_trial = prox_step(reg_name, x + d, 1.0 / Hr_diag, lam, step_size,
                            lb=prob.lb, ub=prob.ub)
    else:
        x_trial = x + d
    g = prob.glm
    pair = glm_prep_pair if method.kernels == "cuda" else glm_prep_pair_torch
    pp = pair(As, ys, x_trial, x_damped, g)
    scale = _loss_scale(g, As.shape[0])
    loss_t = pp.loss_t * scale
    loss_d = pp.loss_d * scale
    F_t = loss_t + prob.reg(reg_name, x_trial)
    F_x = cache.loss + prob.reg(reg_name, x)
    accept = F_t < F_x
    sel = lambda a, b: torch.where(accept, a, b)
    x_new = sel(x_trial, x_damped)
    pri = sel(torch.linalg.vector_norm(x_trial - x), pri_d)
    dx = sel(d, dx_d)
    fc = GLMCache(w=sel(pp.w_t, pp.w_d), b_raw=sel(pp.b_t, pp.b_d),
                  hd_raw=sel(pp.hd_t, pp.hd_d), loss=sel(loss_t, loss_d))
    return x_new, pri, dx, fc


def _damped_update_cached(method, prob: Problem, reg_name, sm, As, ys,
                          x, d, step_size, lam, lgr, Hr_diag, cache):
    """Greedy resolved OFF: the SCORE-damped step, then one priming pass
    at x⁺ rebuilds the cache."""
    del cache  # refreshed wholesale at x_new
    x_new, pri, dx = _damped_prox_update(
        method, prob, reg_name, sm, x, d, step_size, lam, lgr, Hr_diag)
    return x_new, pri, dx, prime_glm_cache(method, prob, x_new, As, ys)


def _cached_update(method, prob: Problem, reg_name, sm, As, ys, x, d,
                   step_size, lam, lgr, Hr_diag, cache):
    """Post-direction update: greedy dual-candidate when greedy damping
    is resolved on, else the damped step + a re-prime."""
    n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
    update = (_greedy_update_cached if use_greedy(method, n_eff, prob)
              else _damped_update_cached)
    return update(method, prob, reg_name, sm, As, ys, x, d, step_size,
                  lam, lgr, Hr_diag, cache)


def ggn_step(method: ProxGGNSCORE, prob: Problem, reg_name: str, sm,
             As, ys, x, x_prev, it: int, d_prev=None, bnorm_prev=None,
             fcache: GLMCache = None) -> StepOut:
    """One generalized Gauss-Newton step with self-concordant damping on
    the epoch-cache path: cached prep → CG → the update pass that is
    also the next epoch's prep."""
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    gr = sm.grad(x, cw)
    lgr = lam * gr
    Hr_diag = sm.hess_diag(x, cw)
    if _resolve_ggn_solver(method, prob, As, x) != "cg" or fcache is None:
        raise NotImplementedError(
            "only the epoch-cached GGN-CG step is ported; the uncached "
            "and dense GGN paths are not ported yet (ROADMAP A7)")
    d, cg_iters, bnorm = _ggn_cg_from_cache(
        method, prob, As, x, gr, Hr_diag, lam, fcache, d_prev, it,
        bnorm_prev, x_prev)
    ss = _resolve_step_size(method, prob, x)
    x_new, pri, dx, fc_new = _cached_update(
        method, prob, reg_name, sm, As, ys, x, d, ss, lam, lgr, Hr_diag,
        fcache)
    return StepOut(x_new, pri, dx, d, cg_iters, bnorm, fc_new)
