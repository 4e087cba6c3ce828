"""The SCORE steps: GGN-CG (cached and uncached) and L-BFGS.

Port of `scso_tpu.algorithms.steps` for the ported paths: prox-GGN with
matrix-free CG and prox-L-BFGS, with the three step-size modes, the
SCORE-damped prox tail and optional greedy damping, for a scalar GLM
spec (`GLMCache`, sparse logistic) and a multi-output spec
(`MOGLMCache`, multinomial).

One epoch of the epoch-cache GGN-CG path (ss_type 1, full batch):

  1. the cached RHS and Jacobi diagonal (`_cg_from_cache`);
  2. warm-started Jacobi-preconditioned CG, one K1 launch (GLM) or one
     K5 launch (mglm) per iteration;
  3. the damped candidate (K3, `_damped_prox_update`);
  4. the undamped trial candidate;
  5. one pass that prices both candidates and builds the next epoch's
     cache — K2 for a GLM (`_greedy_update_cached`), three matrix
     products for an mglm (`_greedy_update_cached_mo`) — or, with
     greedy off, the priming pass at x⁺ (`_damped_update_cached`).

On a row-sharded problem (`parallel.shard_problem`: A and y hold this
rank's rows, every n-vector is replicated) the cached path runs
rank-locally: CG's matvec is K1s (K1 plus an all_reduce), the prep is
K2 on the shard normalized by ``prob.m_total`` plus one packed
all_reduce of its sums, and K3 runs on the replicated vectors. Every
other path raises on a sharded problem (`iterate.solve`, ROADMAP A11).

The uncached GGN-CG path (`_ggn_cg_direction`: ss_type 2 or 3,
``epoch_cache=False``, or a spec without ``loss_sample``) preps each
epoch afresh — K2s for a GLM under 'cuda', else z = A·x and the spec's
weights (`_weighted_system`), or Z = A·W for an mglm (`_mo_glm_system`)
— then runs CG and the damped (or greedy, `_greedy_prox_update`) tail.
An L-BFGS epoch (`lbfgs_step`) is the two-loop direction (K4), the step
size, the damped tail (K3) and one gradient at x⁺.

``method.kernels`` ('cuda' or 'torch', resolved by `iterate`) picks the
CUDA kernels or their plain versions. Gradients and the mglm prep stay
`torch.matmul`: the JAX package runs them as plain XLA matmuls, not as
Pallas kernels. Newton steps (with K2's newton flavour), the dense GGN
solves, subsampled curvature, the static preconditioner, the generic
jvp/vjp GGN branch and the low-precision CG copy are not ported yet
(ROADMAP A7, B2, A10).
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import torch

from scso_tpu_torch.algorithms.methods import ProxGGNSCORE, ProxLQNSCORE
from scso_tpu_torch.ops.cuda.glm_prep import (
    glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
from scso_tpu_torch.ops.cuda.matvec import (
    normal_matvec, normal_matvec_sharded, normal_matvec_sharded_torch,
    normal_matvec_torch)
from scso_tpu_torch.ops.cuda.mglm_matvec import (
    mglm_matvec, mglm_matvec_torch)
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)
from scso_tpu_torch.ops.cuda.two_loop import two_loop, two_loop_torch
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, update_memory
from scso_tpu_torch.ops.linalg import (
    armijo_linesearch, cg_solve, inv_bb_step)
from scso_tpu_torch.ops.prox import prox_step
from scso_tpu_torch.ops.smoothers import get_Mg
from scso_tpu_torch.parallel.sharding import all_reduce_sum
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


class MOGLMCache(NamedTuple):
    """Multi-output analogue of :class:`GLMCache`: Z = A·W replaces the
    weight vector (the per-sample curvature actions of the CG matvec
    derive from Z). All fields are at the CURRENT iterate."""

    Z: torch.Tensor         # (m, k) linear predictor at x
    grad_vec: torch.Tensor  # (n,) vec(Aᵀ·gres(y, Z)) — data gradient
    hd_raw: torch.Tensor    # (n,) data Jacobi diagonal (qdiag_w-weighted)
    loss: torch.Tensor      # ()   data loss f(x), normalized


class StepOut(NamedTuple):
    x_new: torch.Tensor
    pri_res_norm: torch.Tensor
    dx: torch.Tensor
    gq: torch.Tensor       # ∇q at x (composite gradient), for BB caching
    gq_new: torch.Tensor   # ∇q at x_new (L-BFGS only; zeros otherwise)
    mem: LBFGSMemory       # L-BFGS memory (passed through by ggn_step)
    d: torch.Tensor        # raw (undamped) direction — CG warm start seed
    cg_iters: int          # CG iterations spent (0 for L-BFGS)
    bnorm: torch.Tensor    # forcing s_ref (first outer step length)
    fcache: GLMCache = None  # the cache at x_new (MOGLMCache for mglm);
    #                          None off the epoch-cache path


# solver='auto' switches to CG once the materialized Jacobian would
# exceed this many elements (the JAX package's budget)
_DENSE_GGN_MAX_ELEMS = 1 << 24


def _resolve_ggn_solver(method, prob: Problem, x) -> str:
    """'auto' → 'cg' when the m·n Jacobian exceeds the dense budget and a
    GLM spec gives the matrix-free pieces, else 'auto' (the dense
    branches, not ported yet). An mglm problem has no dense pieces in
    the port (no out_fn/loss_fn), so it always resolves to 'cg', as the
    JAX package resolves it without them. A row shard counts all ranks'
    rows, as the JAX package's sharded A keeps its global shape."""
    if method.solver != "auto":
        return method.solver
    if prob.mglm is not None:
        return "cg"
    m = prob.m_total
    n = x.shape[-1]
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


def _resolve_step_size(method, prob: Problem, sm, reg_name, As, ys,
                       x, x_prev, gq, gq_prev, d, it: int, cw):
    """The three step-size schemes, in the reference's branch order.

    GGN:     ss1 & L set → min(1/L, 1); ss1 & L unset → 0.5;
             ss2 → 1 at iteration 1, else inverse BB; ss3 → Armijo.
    L-BFGS:  ss1 & L set → min(1/L, 1); ss2 OR L unset → BB (so ss1 and
             ss3 without L take BB too); ss3 → Armijo."""
    dt = x.dtype
    sst = method.ss_type
    if sst not in (1, 2, 3):
        raise ValueError("Please, choose ss_type in [1, 2, 3].")
    L = prob.L
    lam = _lam_scalar(prob.lam)

    def bb():
        if it == 1:
            return torch.ones((), dtype=dt, device=x.device)
        return inv_bb_step(x, x_prev, gq, gq_prev)

    def linesearch():
        obj = lambda v: prob.f_val(As, ys, v) + prob.reg(reg_name, v)
        grad_q = lambda v: prob.grad_f(As, ys, v) + lam * sm.grad(v, cw)
        return armijo_linesearch(x, d, obj, grad_q)

    if sst == 1 and L is not None:
        return torch.clamp_max(1.0 / L, 1.0)
    if isinstance(method, ProxLQNSCORE):
        if sst == 2 or L is None:
            return bb()
        return linesearch()  # sst == 3
    if sst == 1:
        return torch.tensor(0.5, dtype=dt, device=x.device)
    if sst == 2:
        return bb()
    return linesearch()  # sst == 3


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


def _trial_point(method, prob: Problem, reg_name, x, d, step_size, lam,
                 Hr_diag):
    """The greedy trial: the UNDAMPED prox step (or x + d without prox)."""
    if method.use_prox:
        return prox_step(reg_name, x + d, 1.0 / Hr_diag, lam, step_size,
                         lb=prob.lb, ub=prob.ub)
    return x + d


def _greedy_prox_update(method, prob: Problem, reg_name, sm, As, ys,
                        x, d, step_size, lam, lgr, Hr_diag, z=None):
    """Greedy SCORE damping off the epoch cache: trial the UNDAMPED prox
    step and accept it iff F = f + g strictly decreases, else take the
    SCORE-damped step. F(x) reuses the step's linear predictor ``z``
    when the GLM path formed one; otherwise each of F(x) and F(x_trial)
    costs one matrix product over A (two for f_val without a loss_z).
    A NaN trial objective fails the strict test."""
    x_damped, pri_d, dx_d = _damped_prox_update(
        method, prob, reg_name, sm, x, d, step_size, lam, lgr, Hr_diag)
    x_trial = _trial_point(method, prob, reg_name, x, d, step_size, lam,
                           Hr_diag)
    data_2d = As.ndim == 2
    if data_2d and prob.glm is not None and prob.glm.loss_z is not None:
        z_x = As @ x if z is None else z
        F_x = prob.glm.loss_z(ys, z_x) + prob.reg(reg_name, x)
        F_t = prob.glm.loss_z(ys, As @ x_trial) + prob.reg(reg_name, x_trial)
    elif (data_2d and prob.mglm is not None
          and prob.mglm.loss_z is not None):
        k = int(prob.mglm.n_out)
        Zf = lambda v: As @ v.reshape(v.shape[-1] // k, k)
        F_x = prob.mglm.loss_z(ys, Zf(x)) + prob.reg(reg_name, x)
        F_t = prob.mglm.loss_z(ys, Zf(x_trial)) + prob.reg(reg_name,
                                                           x_trial)
    else:
        F_x = prob.f_val(As, ys, x) + prob.reg(reg_name, x)
        F_t = prob.f_val(As, ys, x_trial) + prob.reg(reg_name, x_trial)
    accept = F_t < F_x
    x_new = torch.where(accept, x_trial, x_damped)
    pri = torch.where(accept, torch.linalg.vector_norm(x_trial - x), pri_d)
    dx = torch.where(accept, d, dx_d)
    return x_new, pri, dx


def use_greedy(method, n=None, prob=None) -> bool:
    """Resolve greedy_alpha None = AUTO: on for ss_type=1 AND n >= 4096
    AND (when ``prob`` is given) a glm/mglm ``loss_z`` to price the trial.

    The n >= 4096 rule changes the trajectory, so it is kept as the JAX
    package has it, for parity. It was measured there on a TPU v5e
    (n = 10112: 41 vs 120 epochs; n = 1024: 29 vs 21) and has not been
    measured on the H100. Explicit True/False always wins."""
    g = method.greedy_alpha
    if g is None:
        if method.ss_type != 1:
            return False
        if prob is not None and not any(
                spec is not None and spec.loss_z is not None
                for spec in (prob.glm, prob.mglm)):
            return False
        return n is None or n >= 4096
    return bool(g)


def _apply_update(method, prob: Problem, reg_name, sm, As, ys, x, d,
                  step_size, lam, lgr, Hr_diag, z=None):
    """The damped-prox tail off the epoch cache; the greedy variant when
    greedy damping resolves on."""
    n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
    if use_greedy(method, n_eff, prob):
        return _greedy_prox_update(method, prob, reg_name, sm, As, ys,
                                   x, d, step_size, lam, lgr, Hr_diag, z)
    return _damped_prox_update(method, prob, reg_name, sm, x, d,
                               step_size, lam, lgr, Hr_diag)


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
    solver with ss_type=1, full-batch data, and either an mglm spec with
    loss_z and loss_sample (taking precedence, as in the JAX package) or
    a GLM spec with loss_z, loss_sample and the stable ggn_rw/ggn_w
    forms, and no row-subsampled curvature (``curvature_rows`` does
    nothing on a row-sharded problem, as in the JAX package). A GGN
    solve that fails this takes the uncached path
    (`_ggn_cg_direction`)."""
    if not isinstance(method, ProxGGNSCORE) or method.ss_type != 1:
        return False
    if method.epoch_cache is False:
        return False
    if prob.A.ndim != 2:
        return False
    mo, g = prob.mglm, prob.glm
    if mo is not None:
        if mo.loss_z is None or mo.loss_sample is None:
            return False
    elif (g is None or g.loss_z is None or g.loss_sample is None
            or g.ggn_rw is None or g.ggn_w is None):
        return False
    if not full_batch:
        return False
    # curvature_rows subsamples rows only on an unsharded problem, as in
    # the JAX package: on a row shard it is a no-op and the cache stays
    if prob.mesh is None and 0 < method.curvature_rows < prob.m_total:
        return False
    return _resolve_ggn_solver(method, prob, prob.x0) == "cg"


def _mo_shapes(g, x):
    """(k, p) for x = vec(W), W of shape (p, k)."""
    k = int(g.n_out)
    pf = x.shape[-1] // k if k > 0 else 0
    if k <= 0 or pf * k != x.shape[-1]:
        raise ValueError(
            f"mglm: n = {x.shape[-1]} incompatible with n_out = {k} (n must "
            "be divisible by a positive n_out; build the spec per k, e.g. "
            "losses.multinom_mglm(k))")
    return k, pf


def _jacobi_mo(Q, As):
    """Σᵢ Qᵢc·Aᵢⱼ² as (p, c) — the einsum "ic,ij,ij->jc" with one
    A-sized temporary (A²)."""
    return torch.square(As).T @ Q


def _moglm_pair_prep(As, ys, g, x_t, x_d):
    """Dual-candidate mglm prep: both candidates' Z, data gradient,
    Jacobi diagonal and loss from three A-reads (the per-candidate
    products batch into (m×p)·(p×2k) matmuls). Returns two
    (Z, grad_vec, hd_raw, loss) tuples, losses normalized."""
    k, pf = _mo_shapes(g, x_t)
    m = As.shape[0]
    W2 = torch.cat([x_t.reshape(pf, k), x_d.reshape(pf, k)], dim=1)
    Z2 = As @ W2                                     # read 1
    Zt, Zd = Z2[:, :k].contiguous(), Z2[:, k:].contiguous()
    R2 = torch.cat([g.gres(ys, Zt), g.gres(ys, Zd)], dim=1)
    G2 = As.T @ R2                                   # read 2
    Q2 = torch.cat([g.qdiag_w(ys, Zt), g.qdiag_w(ys, Zd)], dim=1)
    H2 = _jacobi_mo(Q2, As)                          # read 3
    scale = (1.0 / m) if g.sample_normalized else 1.0
    lt = torch.sum(g.loss_sample(ys, Zt)) * scale
    ld = torch.sum(g.loss_sample(ys, Zd)) * scale
    return ((Zt, G2[:, :k].reshape(-1), H2[:, :k].reshape(-1), lt),
            (Zd, G2[:, k:].reshape(-1), H2[:, k:].reshape(-1), ld))


def _prime_moglm(prob: Problem, x, As, ys) -> MOGLMCache:
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    Z = As @ x.reshape(pf, k)
    grad_vec = (As.T @ g.gres(ys, Z)).reshape(-1)
    hd = _jacobi_mo(g.qdiag_w(ys, Z), As).reshape(-1)
    scale = (1.0 / As.shape[0]) if g.sample_normalized else 1.0
    loss = torch.sum(g.loss_sample(ys, Z)) * scale
    return MOGLMCache(Z=Z, grad_vec=grad_vec, hd_raw=hd, loss=loss)


def prime_glm_cache(method, prob: Problem, x, As=None, ys=None):
    """Build the epoch cache at iterate x: for an mglm problem the three
    matrix products of `_prime_moglm` (MOGLMCache); for a GLM the K2
    kernel with both candidates = x (one pass over A), or the plain
    single-candidate prep (GLMCache), normalized by ``prob.m_total``.

    On a row-sharded problem K2 runs on this rank's rows and one packed
    all_reduce sums (b, hd, loss) over the ranks; w stays per-row and
    local. The JAX package takes its plain GSPMD-partitioned prep there
    instead (its `_use_pair_kernel`), only because a pallas_call cannot
    be GSPMD-partitioned; the sums are the same, and on the H100 the
    plain prep costs 105 ms an epoch against K2's 5.4 ms at 196608×10112
    float32 (PERF.md)."""
    As = prob.A if As is None else As
    ys = prob.y if ys is None else ys
    if prob.mglm is not None:
        return _prime_moglm(prob, x, As, ys)
    g = prob.glm
    if method.kernels == "cuda":
        pp = glm_prep_pair(As, ys, x, x, g, prob.m_total)
        w, b, hd, loss = pp.w_t, pp.b_t, pp.hd_t, pp.loss_t
    else:
        w, b, hd, loss = glm_prep_torch(As, ys, x, g, prob.m_total)
    if prob.mesh is not None:
        b, hd, loss = all_reduce_sum(prob.mesh, b, hd, loss)
    return GLMCache(w, b, hd, loss * _loss_scale(g, prob.m_total))


def _ggn_cg_from_cache(method, prob: Problem, As, x, gr, Hr_diag, lam,
                       cache: GLMCache, d_prev, it, bnorm_prev, x_prev):
    """GGN-CG direction with no prep pass over A: RHS, matvec weights and
    Jacobi diagonal come from the cache; only the smoother terms
    (λ·gr, λ·Hr) are fresh. Each CG iteration is one K1 launch, or on a
    row-sharded problem one K1s call (K1 on the shard plus an
    all_reduce; ``method.comm_overlap_chunks`` picks its schedule)."""
    lhr = lam * Hr_diag
    b = -(cache.b_raw + lam * gr)
    diag = torch.clamp_min(cache.hd_raw + lhr, torch.finfo(x.dtype).tiny)
    w = cache.w
    cuda = method.kernels == "cuda"
    if prob.mesh is None:
        matvec = normal_matvec if cuda else normal_matvec_torch
    else:
        matvec = functools.partial(
            normal_matvec_sharded if cuda else normal_matvec_sharded_torch,
            mesh=prob.mesh, data_axis=prob.data_axis,
            overlap_chunks=method.comm_overlap_chunks)
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = cg_solve(lambda v: matvec(As, w, v) + lhr * v, b, d_prev,
                   tol=tol, maxiter=method.cg_maxiter,
                   M_inv=lambda v: v / diag)
    return res.x, res.iters, bnorm


def _mo_curv_matvec(method, As, ys, Z, g, lhr, pf, k):
    """The mglm curvature matvec v ↦ vec(Aᵀ·quad(y, Z, A·V)) + λHr∘v from
    the cached Z — one K5 launch, or its plain version."""
    mv = mglm_matvec if method.kernels == "cuda" else mglm_matvec_torch
    return lambda v: mv(As, ys, Z, v.reshape(pf, k), g).reshape(-1) + lhr * v


def _mo_cg_from_cache(method, prob: Problem, As, ys, x, gr, Hr_diag, lam,
                      cache: MOGLMCache, d_prev, it, bnorm_prev, x_prev):
    """Multi-output GGN-CG direction from the carried MOGLMCache: no
    prep pass over A; each CG matvec applies the per-sample curvature
    action from the cached Z (one K5 launch per iteration)."""
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    lhr = lam * Hr_diag
    b = -(cache.grad_vec + lam * gr)
    diag = torch.clamp_min(cache.hd_raw + lhr, torch.finfo(x.dtype).tiny)
    mv = _mo_curv_matvec(method, As, ys, cache.Z, g, lhr, pf, k)
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = cg_solve(mv, b, d_prev, tol=tol, maxiter=method.cg_maxiter,
                   M_inv=lambda v: v / diag)
    return res.x, res.iters, bnorm


def _cg_from_cache(method, prob: Problem, As, ys, x, gr, Hr_diag, lam,
                   cache, d_prev, it, bnorm_prev, x_prev):
    """Dispatch the cached CG direction by problem kind (mglm first)."""
    if prob.mglm is not None:
        return _mo_cg_from_cache(method, prob, As, ys, x, gr, Hr_diag,
                                 lam, cache, d_prev, it, bnorm_prev,
                                 x_prev)
    return _ggn_cg_from_cache(method, prob, As, x, gr, Hr_diag, lam,
                              cache, d_prev, it, bnorm_prev, x_prev)


def _greedy_update_cached_mo(method, prob: Problem, reg_name, sm, As, ys,
                             x, d, step_size, lam, lgr, Hr_diag,
                             cache: MOGLMCache):
    """Multi-output analogue of `_greedy_update_cached`: the same greedy
    semantics; the dual-candidate prep is `_moglm_pair_prep`."""
    x_damped, pri_d, dx_d = _damped_prox_update(
        method, prob, reg_name, sm, x, d, step_size, lam, lgr, Hr_diag)
    x_trial = _trial_point(method, prob, reg_name, x, d, step_size, lam,
                           Hr_diag)
    ct, cd = _moglm_pair_prep(As, ys, prob.mglm, x_trial, x_damped)
    F_t = ct[3] + prob.reg(reg_name, x_trial)
    F_x = cache.loss + prob.reg(reg_name, x)
    accept = F_t < F_x
    sel = lambda a, b: torch.where(accept, a, b)
    x_new = sel(x_trial, x_damped)
    pri = sel(torch.linalg.vector_norm(x_trial - x), pri_d)
    dx = sel(d, dx_d)
    fc = MOGLMCache(Z=sel(ct[0], cd[0]), grad_vec=sel(ct[1], cd[1]),
                    hd_raw=sel(ct[2], cd[2]), loss=sel(ct[3], cd[3]))
    return x_new, pri, dx, fc


# the pair prep's sums over rows (w stays per-row)
_SUMMED = ("b_t", "b_d", "hd_t", "hd_d", "loss_t", "loss_d")


def _greedy_update_cached(method, prob: Problem, reg_name, sm, As, ys,
                          x, d, step_size, lam, lgr, Hr_diag,
                          cache: GLMCache):
    """Greedy SCORE damping through the dual-candidate pass: trial the
    UNDAMPED prox step and accept it iff the true composite objective
    strictly decreases, else take the SCORE-damped step. One K2 call
    prices both candidates and builds both caches; the winner's becomes
    the new cache. A NaN trial loss fails the strict test. On a
    row-sharded problem K2 runs on this rank's rows and one packed
    all_reduce sums both candidates' (b, hd, loss) over the ranks (see
    `prime_glm_cache`), so the accept test reads replicated losses."""
    x_damped, pri_d, dx_d = _damped_prox_update(
        method, prob, reg_name, sm, x, d, step_size, lam, lgr, Hr_diag)
    x_trial = _trial_point(method, prob, reg_name, x, d, step_size, lam,
                           Hr_diag)
    g = prob.glm
    pair = glm_prep_pair if method.kernels == "cuda" else glm_prep_pair_torch
    pp = pair(As, ys, x_trial, x_damped, g, prob.m_total)
    if prob.mesh is not None:
        pp = pp._replace(**dict(zip(_SUMMED, all_reduce_sum(
            prob.mesh, *(getattr(pp, f) for f in _SUMMED)))))
    scale = _loss_scale(g, prob.m_total)
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
    is resolved on (the mglm form for an mglm problem), else the damped
    step + a re-prime."""
    n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
    if not use_greedy(method, n_eff, prob):
        update = _damped_update_cached
    elif prob.mglm is not None:
        update = _greedy_update_cached_mo
    else:
        update = _greedy_update_cached
    return update(method, prob, reg_name, sm, As, ys, x, d, step_size,
                  lam, lgr, Hr_diag, cache)


def _weighted_system(method, As, x, w, lhr, hd_raw=None):
    """(matvec, preconditioner) from GLM weights w:
    mv(v) = Aᵀ(w∘(Av)) + λHr∘v (one K1 launch under 'cuda'), Jacobi
    M⁻¹ = 1/(Σᵢ wᵢAᵢⱼ² + λHr). ``hd_raw`` is Σᵢ wᵢAᵢⱼ² when the prep
    already has it (K2s); otherwise the plain diagonal builds one A-sized
    temporary. The static preconditioner and the row-sharded matvec are
    not ported yet (ROADMAP A7, A11)."""
    if method.static_precond:
        raise NotImplementedError(
            "static_precond (the static Jacobi preconditioner) is not "
            "ported yet (ROADMAP A7)")
    tiny = torch.finfo(x.dtype).tiny
    matvec = normal_matvec if method.kernels == "cuda" else normal_matvec_torch
    if hd_raw is None:
        hd_raw = torch.einsum("i,ij,ij->j", w, As, As)
    hdiag = hd_raw + lhr
    return (lambda v: matvec(As, w, v) + lhr * v,
            lambda v: v / torch.clamp_min(hdiag, tiny))


def _ggn_weights(g, ys, z):
    """(ρ, w) of the GGN system at z: the spec's stable ggn_rw/ggn_w when
    given, else σ'·res and σ'²·qdiag."""
    if g.ggn_rw is not None:
        rw = g.ggn_rw(ys, z)
    else:
        rw = g.dlink(z) * g.res(ys, g.link(z))
    if g.ggn_w is not None:
        w = g.ggn_w(ys, z)
    else:
        sp = g.dlink(z)
        w = sp * sp * g.qdiag(ys, g.link(z))
    return rw, w


def _mo_glm_system(method, prob: Problem, As, ys, x, lhr):
    """(Z, grad_vec, matvec, preconditioner) for a multi-output GLM off
    the epoch cache: Z = A·W once (W = x.reshape(p, k)),
    ∇f = vec(Aᵀ·gres(y, Z)), each matvec the per-sample curvature action
    vec(Aᵀ·quad(y, Z, A·V)) + λHr∘v (one K5 launch under 'cuda'), Jacobi
    diagonal Σᵢ qdiag_wᵢ·Aᵢⱼ² + λHr."""
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    Z = As @ x.reshape(pf, k)
    grad_vec = (As.T @ g.gres(ys, Z)).reshape(-1)
    mv = _mo_curv_matvec(method, As, ys, Z, g, lhr, pf, k)
    hdiag = _jacobi_mo(g.qdiag_w(ys, Z), As).reshape(-1) + lhr
    tiny = torch.finfo(x.dtype).tiny
    return Z, grad_vec, mv, lambda v: v / torch.clamp_min(hdiag, tiny)


def _ggn_cg_direction(method, prob: Problem, As, ys, x, gr, Hr_diag, lam,
                      d_prev=None, it=None, bnorm_prev=None, x_prev=None):
    """Matrix-free GGN-CG direction off the epoch cache: solve
    (JᵀQJ + λ·diag(Hr)) d = −(Jᵀr + λ·gr) by warm-started Jacobi-
    preconditioned CG, every piece prepared afresh at x.

    A GLM preps in one call to K2s (`glm_prep`) under 'cuda' unless
    ``use_fused_prep`` is False — at every shape: the JAX package's AUTO
    gate n ≥ 8192 was measured on a TPU v5e — and otherwise forms
    z = A·x and the spec's weights (`_weighted_system`). An mglm goes
    through `_mo_glm_system`. Returns (d, cg_iters, bnorm, z), z the
    linear predictor when one was formed (the greedy trial reuses it),
    else None."""
    if method.cg_lp_tol > 0:
        raise NotImplementedError(
            "precision-adaptive CG on a low-precision copy of A is not "
            "ported yet (ROADMAP A10)")
    z_cache = None
    lhr = lam * Hr_diag
    if prob.mglm is not None and As.ndim == 2:
        _, grad_vec, mv, M_inv = _mo_glm_system(method, prob, As, ys, x,
                                                lhr)
        b = -(grad_vec + lam * gr)
    elif prob.glm is not None and As.ndim == 2:
        if 0 < method.curvature_rows < As.shape[0]:
            raise NotImplementedError(
                "subsampled curvature (curvature_rows) is not ported yet "
                "(ROADMAP A7)")
        if method.kernels == "cuda" and method.use_fused_prep is not False:
            w, b_raw, hd_raw = glm_prep(As, ys, x, prob.glm)
        else:
            z_cache = As @ x
            rw, w = _ggn_weights(prob.glm, ys, z_cache)
            b_raw, hd_raw = As.T @ rw, None
        b = -(b_raw + lam * gr)
        mv, M_inv = _weighted_system(method, As, x, w, lhr, hd_raw)
    else:
        raise NotImplementedError(
            "the generic GGN-CG branch (jvp/vjp of out_fn, no GLM spec) is "
            "not ported yet (ROADMAP A7)")
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = cg_solve(mv, b, d_prev, tol=tol, maxiter=method.cg_maxiter,
                   M_inv=M_inv)
    return res.x, res.iters, bnorm, z_cache


def ggn_step(method: ProxGGNSCORE, prob: Problem, reg_name: str, sm,
             As, ys, x, x_prev, it: int, d_prev=None, bnorm_prev=None,
             fcache: GLMCache = None, gq_prev=None,
             mem: LBFGSMemory = None) -> StepOut:
    """One generalized Gauss-Newton step with self-concordant damping.

    With ``fcache`` (primed by the driver when `epoch_cache_enabled`)
    the step runs the epoch-fused path: cached prep → CG → the update
    pass that is also the next epoch's prep. Without it, the uncached
    path: `_ggn_cg_direction`, the step size (ss_type 2 prices the
    composite gradient at x and x_prev, two gradients), and the damped
    or greedy tail. ``gq``/``gq_new`` come back as zeros and ``mem``
    unchanged, as in the JAX package."""
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    gr = sm.grad(x, cw)
    lgr = lam * gr
    Hr_diag = sm.hess_diag(x, cw)
    zeros = torch.zeros_like(x)
    if _resolve_ggn_solver(method, prob, x) != "cg":
        raise NotImplementedError(
            "the dense GGN solves (dense_dual/dense_primal, and 'auto' "
            "below the dense budget) are not ported yet (ROADMAP A7)")
    if fcache is not None:
        d, cg_iters, bnorm = _cg_from_cache(
            method, prob, As, ys, x, gr, Hr_diag, lam, fcache, d_prev, it,
            bnorm_prev, x_prev)
        ss = _resolve_step_size(method, prob, sm, reg_name, As, ys, x,
                                x_prev, zeros, gq_prev, d, it, cw)
        x_new, pri, dx, fc_new = _cached_update(
            method, prob, reg_name, sm, As, ys, x, d, ss, lam, lgr,
            Hr_diag, fcache)
        return StepOut(x_new, pri, dx, zeros, zeros, mem, d, cg_iters,
                       bnorm, fc_new)
    d, cg_iters, bnorm, z_cache = _ggn_cg_direction(
        method, prob, As, ys, x, gr, Hr_diag, lam, d_prev, it=it,
        bnorm_prev=bnorm_prev, x_prev=x_prev)
    # the composite gradients only for BB (ss2): GGN never forms ∇f
    # otherwise
    if method.ss_type == 2:
        gq = prob.grad_f(As, ys, x) + lgr
        gqp = prob.grad_f(As, ys, x_prev) + lam * sm.grad(x_prev, cw)
    else:
        gq, gqp = zeros, gq_prev
    ss = _resolve_step_size(method, prob, sm, reg_name, As, ys, x, x_prev,
                            gq, gqp, d, it, cw)
    x_new, pri, dx = _apply_update(method, prob, reg_name, sm, As, ys, x,
                                   d, ss, lam, lgr, Hr_diag, z=z_cache)
    return StepOut(x_new, pri, dx, gq, zeros, mem, d, cg_iters, bnorm)


def lbfgs_step(method: ProxLQNSCORE, prob: Problem, reg_name: str, sm,
               As, ys, x, x_prev, gq_prev, it: int, mem: LBFGSMemory,
               gq_cached=None) -> StepOut:
    """L-BFGS step with self-concordant damping.

    The direction is the two-loop recursion (K4 under 'cuda') on the
    composite gradient ∇q = ∇f + λ·∇g_s; with an empty memory it is
    −H0·∇q = −∇q, the reference's first-iteration branch. The full-batch
    driver carries ∇q(x_new) forward as ``gq_cached``, so an epoch costs
    one gradient (two matrix products over A); None recomputes it."""
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    gr = sm.grad(x, cw)
    lgr = lam * gr
    Hr_diag = sm.hess_diag(x, cw)
    gq = (gq_cached if gq_cached is not None
          else prob.grad_f(As, ys, x) + lgr)
    direction = two_loop if method.kernels == "cuda" else two_loop_torch
    d = direction(mem, gq)
    ss = _resolve_step_size(method, prob, sm, reg_name, As, ys, x, x_prev,
                            gq, gq_prev, d, it, cw)
    x_new, pri, dx = _apply_update(method, prob, reg_name, sm, As, ys, x,
                                   d, ss, lam, lgr, Hr_diag)
    # the curvature pair from the NEW composite gradient
    gq_new = prob.grad_f(As, ys, x_new) + lam * sm.grad(x_new, cw)
    mem = update_memory(mem, x_new - x, gq_new - gq)
    return StepOut(x_new, pri, dx, gq, gq_new, mem, d, 0,
                   torch.zeros((), dtype=x.dtype, device=x.device))


def make_step_fn(method):
    """The step function of a method config."""
    if isinstance(method, ProxGGNSCORE):
        return ggn_step
    if isinstance(method, ProxLQNSCORE):
        return lbfgs_step
    raise NotImplementedError(
        f"{type(method).__name__} is not ported yet (ROADMAP A7)")
