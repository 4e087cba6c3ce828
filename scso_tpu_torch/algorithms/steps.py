"""The SCORE steps: Newton, GGN (CG, cached and uncached, or dense) and
L-BFGS.

Port of `scso_tpu.algorithms.steps`: prox-Newton (dense or matrix-free
CG), prox-GGN (matrix-free CG, or the reference's dense dual and primal
systems) and prox-L-BFGS, with the three step-size modes, the
SCORE-damped prox tail and optional greedy damping, for a scalar GLM
spec (`GLMCache`, sparse logistic), a multi-output spec (`MOGLMCache`,
multinomial), or a data f with its derivative hooks.

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
rank's rows, every n-vector is replicated) every step runs
rank-locally and every contraction over rows ends in a sum over the
ranks (`Problem.row_sum`, one all_reduce, packed where several sums are
ready together): CG's matvec is K1s (K1 plus an all_reduce) or K5 on
the shard plus an all_reduce of its (p, k) result; the preps are K2,
K2s or the mglm products on the shard, normalized by the rows of all
ranks (``m_norm``, `Problem.row_form`), plus one packed all_reduce; f,
∇f, ∇²f and ∇²f·v are this rank's share summed (`Problem.f_val` and
its siblings, under the mean-over-rows contract `Problem` states); a
dense Newton or primal GGN system is summed before every rank factors
it, and a dense dual GGN system gathers every rank's rows of J
(`parallel.sharding.gather_rows`). K3 and K4 run on the replicated
vectors. A mini-batch on a shard is this rank's rows of the batch,
zero-padded (`Problem.rows`). The sums run over the mesh's data axis
(a mesh of more axes: `Problem.row_sum`).

On a column shard (`parallel.shard_problem_features`: A an
`ops.dense.ColShard` of this rank's columns, x replicated) the kernels
that fuse a row's dot with its scatter (K1, K1s, K2, K2s, K5) cannot
take a partial dot: the steps take their plain versions, whose products
(`ops.dense`) sum A·v and gather Aᵀu over the model axis (`_kernel`),
as the JAX package's column-sharded solve takes XLA products. K3 and K4
still launch, on the replicated vectors.

The uncached GGN-CG path (`_ggn_cg_direction`: ss_type 2 or 3,
``epoch_cache=False``, or a spec without ``loss_sample``) preps each
epoch afresh — K2s for a GLM under 'cuda', else z = A·x and the spec's
weights (`_weighted_system`), or Z = A·W for an mglm (`_mo_glm_system`)
— then runs CG and the damped (or greedy, `_greedy_prox_update`) tail.
An L-BFGS epoch (`lbfgs_step`) is the two-loop direction (K4), the step
size, the damped tail (K3) and one gradient at x⁺.

A Newton epoch (`newton_step`) runs the same cached path with K2 in its
newton flavour (ρ = gres, w = hvp_w: the true Hessian weights,
`_cache_flavour`), or off the cache forms ∇q once — z = A·x and Aᵀ·gres
for a GLM (its CG matvecs K1 on the hvp_w weights), Z = A·W for an mglm
(K5, whose GGN operator is the Hessian), else ∇f — and solves
(∇²f + λ·diag(Hr)) d = −∇q by CG (warm-started from −d_prev), or
densely through ∇²f (the user's hess_fx or autograd) for n up to
`_DENSE_NEWTON_MAX_N` under solver='auto'. The dense GGN step
(`_ggn_dense_direction`) solves the reference's dual or primal system
over the materialized Jacobian (`Problem.ggn_pieces`).

``method.kernels`` ('cuda' or 'torch', resolved by `iterate`) picks the
CUDA kernels or their plain versions, for any spec: K2 and K2s compute
the logistic01, least-squares and Poisson specs in the kernel, K5 the
multinomial one, and any other between their passes over A (their
split form). The group-lasso prox ('gl') keeps its damped tail in
PyTorch (`_damped_prox_update`), as the JAX package keeps it out of its
kernel: K3 serves 'l1', 'l2', 'indbox' and no prox. Gradients and
the mglm prep stay `torch.matmul` (`ops.dense`): the JAX package runs
them as plain XLA matmuls, not as Pallas kernels. A may be stored in
bfloat16 (the coarse phase of `iterate_mixed`): the kernels take it as
it is, `ops.dense` upcasts its values exactly.

Precision-adaptive CG (cached, uncached and row-sharded GLM specs, and
the cached multi-output path): with a low-precision copy of A
(`Problem.A_lp`, bfloat16) and ``method.cg_lp_tol`` > 0, an epoch whose
CG forcing tolerance is at least ``cg_lp_tol`` runs its CG matvecs on
the copy (K1, K1s or K5 with A in bfloat16), the others on A
(`_lp_matvec`, `_mo_lp_matvec`, `_cg_direction_solve`). The RHS, the
prep and the greedy pass always read A. The choice is the JAX package's
`lax.cond` on the device: `graph.device_cond`, two conditionals of a
captured epoch.

The epoch index ``it`` may be a Python int or a 0-d tensor on the data's
device (the solve loops pass the tensor): the first-epoch rules of the
forcing and of the BB step are `torch.where`s on it, as in the JAX
package. A step reads nothing back to the host, so that it can be
captured into a CUDA graph.

Off the cache the GGN-CG system has two more forms, as in the JAX
package: subsampled curvature (``curvature_rows``: the RHS over all
rows, the CG operator and its Jacobi diagonal over a strided subsample
of about that many rows; under 'cuda' K2s on A for the RHS and on the
subsample for the weights, K1 on the subsample) and the static Jacobi
preconditioner (``static_precond`` with the problem's ``col_sumsq``:
(Σw/m)·diag(AᵀA) + λHr). A problem without a GLM spec takes the
generic branch: J applied by ``torch.func.jvp`` and ``vjp`` of its
``out_fn``, diagonal Q from ``hess_fy_diag`` (or the ``ggn_w`` hook's
weights through K1). A problem without data (f(x)) runs the
Newton, GGN and L-BFGS steps with ``As`` and ``ys`` None.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import torch

from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProxNSCORE)
from scso_tpu_torch.ops.cuda.graph import device_cond
from scso_tpu_torch.ops.cuda.glm_prep import (
    ggn_weights, glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
from scso_tpu_torch.ops.cuda.matvec import (
    normal_matvec, normal_matvec_sharded, normal_matvec_sharded_torch,
    normal_matvec_torch)
from scso_tpu_torch.ops.cuda.mglm_matvec import (
    mglm_matvec, mglm_matvec_torch)
from scso_tpu_torch.ops.cuda.score_update import (
    score_update, score_update_torch)
from scso_tpu_torch.ops.cuda.two_loop import two_loop, two_loop_torch
from scso_tpu_torch.ops.dense import amul, atmul, is_colshard, sq_atmul
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, update_memory
from scso_tpu_torch.ops.linalg import (
    armijo_linesearch, cg_solve, inv_bb_step)
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
    cg_iters: object       # CG iterations spent: a 0-d int32 tensor, or
    #                        0 where no CG ran (L-BFGS, the dense solves)
    bnorm: torch.Tensor    # forcing s_ref (first outer step length)
    fcache: GLMCache = None  # the cache at x_new (MOGLMCache for mglm);
    #                          None off the epoch-cache path


# solver='auto' switches to CG above n = _DENSE_NEWTON_MAX_N (the n×n
# factorization) and once the materialized Jacobian would exceed
# _DENSE_GGN_MAX_ELEMS elements: the JAX package's budgets, kept for
# parity (measured on a TPU, not on the H100)
_DENSE_NEWTON_MAX_N = 2048
_DENSE_GGN_MAX_ELEMS = 1 << 24

_warned: set = set()


def _warn_once(key, msg):
    """Warn once a process for each ``key`` (the JAX package's rule)."""
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=3)


def _resolve_newton_solver(method, x) -> str:
    """'auto' → 'dense' (the reference's direct solve) up to n =
    _DENSE_NEWTON_MAX_N, 'cg' above it (warned once a shape)."""
    if method.solver != "auto":
        return method.solver
    n = x.shape[-1]
    if n > _DENSE_NEWTON_MAX_N:
        _warn_once(
            ("newton-auto-cg", n),
            f"ProxNSCORE(solver='auto'): n={n} exceeds the dense budget "
            f"({_DENSE_NEWTON_MAX_N}) — using matrix-free Newton-CG. Pass "
            "solver='dense' to force the direct solve.")
        return "cg"
    return "dense"


def _resolve_ggn_solver(method, prob: Problem, x, As=None) -> str:
    """'auto' → 'cg' when the (m·k)×n Jacobian exceeds the dense budget
    and the matrix-free pieces exist (a GLM or mglm spec, or out_fn),
    else 'auto' (the reference's dense branch, also for a problem
    without data). An mglm problem without
    the dense pieces (jac_yx, grad_fy and hess_fy, or out_fn and
    loss_fn) resolves to 'cg' at any size, as in the JAX package. m is
    the problem's row count for A itself (a row shard counts all ranks'
    rows, as the JAX package's sharded A keeps its global shape) and a
    mini-batch's rows for a batch ``As``. Warned once a shape."""
    if method.solver != "auto":
        return method.solver
    As = prob.A if As is None else As
    if not prob.has_data or As.ndim != 2:
        return "auto"
    m = prob.rows_total(As)
    n = x.shape[-1]
    k = prob.mglm.n_out if prob.mglm is not None else 1
    if prob.mglm is not None:
        dense_ok = (all(fn is not None
                        for fn in (prob.jac_yx, prob.grad_fy, prob.hess_fy))
                    or (prob.out_fn is not None and prob.loss_fn is not None))
        if not dense_ok:
            return "cg"
    matrix_free_ok = (prob.glm is not None or prob.mglm is not None
                      or prob.out_fn is not None)
    if m * k * n > _DENSE_GGN_MAX_ELEMS and matrix_free_ok:
        _warn_once(
            ("ggn-auto-cg", (m, k, n)),
            f"ProxGGNSCORE(solver='auto'): J would be {m * k}x{n} "
            f"(> {_DENSE_GGN_MAX_ELEMS} elements) — using matrix-free "
            "GGN-CG. Pass solver='dense_dual'/'dense_primal' to force a "
            "dense branch.")
        return "cg"
    return "auto"


def _lam_scalar(lam):
    """λ[0] when multi-valued, else λ, as a 0-d tensor."""
    if lam.ndim >= 1 and lam.shape[0] > 1:
        return lam.reshape(-1)[0]
    return lam.reshape(())


def _cw(prob: Problem, reg_name: str):
    """Diagonal of the reference's Cmat: group element-weights for 'gl',
    None (the identity) otherwise."""
    if reg_name == "gl":
        if prob.groups is None:
            raise ValueError("'gl' regularizer requires group structure")
        return prob.groups.element_weights
    return None


def _resolve_step_size(method, prob: Problem, sm, reg_name, As, ys,
                       x, x_prev, gq, gq_prev, d, it, cw):
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
        first = torch.as_tensor(it == 1, device=x.device)
        return torch.where(first, torch.ones((), dtype=dt, device=x.device),
                           inv_bb_step(x, x_prev, gq, gq_prev))

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
        return torch.full((), 0.5, dtype=dt, device=x.device)
    if sst == 2:
        return bb()
    return linesearch()  # sst == 3


def _damped_prox_update(method, prob: Problem, reg_name, sm, x, d,
                        step_size, lam, lgr, Hr_diag):
    """SCORE damping + scaled prox, the tail of every step:
    α = ss/(1 + M_g·η), η = sqrt(λgr'·diag(1/Hr)·λgr), safe = min(1, α),
    x⁺ = prox(x + safe·d; threshold ss·λ·Hr) — K3, or its plain version.
    The group-lasso prox ('gl') is not K3's: that tail stays plain
    PyTorch, as the JAX package keeps it out of its kernel. Returns
    (x⁺, ‖x⁺ − x‖, safe·d)."""
    # feature-padded problems damp with the TRUE n (get_Mg depends on n)
    n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
    Mg = get_Mg(sm.Mh, sm.nu, sm.mu, n_eff)
    if reg_name == "gl" and method.use_prox:
        hdiag_inv = 1.0 / Hr_diag
        # lgr²/Hr → 0 where lgr = 0, also where Hr = 0 (the GL smoother's
        # Hessian vanishes with its gradient at a fully thresholded x)
        eta_terms = torch.where(lgr == 0, torch.zeros_like(lgr),
                                lgr * hdiag_inv * lgr)
        alpha = step_size / (1.0 + Mg * torch.sqrt(torch.sum(eta_terms)))
        dx = torch.clamp_max(alpha, 1.0) * d
        x_new = prox_step(reg_name, x + dx, hdiag_inv, prob.lam, step_size,
                          groups=prob.groups)
        return x_new, torch.linalg.vector_norm(x_new - x), dx
    update = score_update if method.kernels == "cuda" else score_update_torch
    out = update(x, d, lgr, Hr_diag, lam, step_size, Mg, reg_name,
                 use_prox=method.use_prox, lb=prob.lb, ub=prob.ub)
    return out.x_new, out.pri, out.safe * d


def _trial_point(method, prob: Problem, reg_name, x, d, step_size, lam,
                 Hr_diag):
    """The greedy trial: the UNDAMPED prox step (or x + d without prox)."""
    if method.use_prox:
        # the group-lasso prox takes the whole [λ₁, λ₂]
        lam_prox = prob.lam if reg_name == "gl" else lam
        return prox_step(reg_name, x + d, 1.0 / Hr_diag, lam_prox, step_size,
                         lb=prob.lb, ub=prob.ub, groups=prob.groups)
    return x + d


def _loss_z_pair(prob: Problem, As, ys, loss_z, z_x, z_t):
    """A spec's loss_z at two linear predictors of the rows ``As``
    (their zero pad rows at z = 0); on a row shard each rank's share,
    summed over the ranks in one all_reduce."""
    if prob.mesh is None:
        return loss_z(ys, z_x), loss_z(ys, z_t)
    def share(z):
        # `Problem.share` also evaluates at one zero (pad) row: z = 0 there
        zero = lambda: z.new_zeros((1,) + tuple(z.shape[1:]))
        return prob.share(As, ys,
                          lambda a, b: loss_z(b, z if a is As else zero()))

    return prob.row_sum(share(z_x), share(z_t))


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
    data_2d = prob.has_data and As.ndim == 2
    if data_2d and prob.glm is not None and prob.glm.loss_z is not None:
        z_x = amul(As, x) if z is None else z
        lx, lt = _loss_z_pair(prob, As, ys, prob.glm.loss_z, z_x,
                              amul(As, x_trial))
        F_x = lx + prob.reg(reg_name, x)
        F_t = lt + prob.reg(reg_name, x_trial)
    elif (data_2d and prob.mglm is not None
          and prob.mglm.loss_z is not None):
        k = int(prob.mglm.n_out)
        Zf = lambda v: amul(As, v.reshape(v.shape[-1] // k, k))
        lx, lt = _loss_z_pair(prob, As, ys, prob.mglm.loss_z, Zf(x),
                              Zf(x_trial))
        F_x = lx + prob.reg(reg_name, x)
        F_t = lt + prob.reg(reg_name, x_trial)
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


def _forcing_tol(method, b, x, x_prev, ref_prev, it, endgame=False):
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
    return torch.where(torch.isnan(ref) | (it <= 1),
                       torch.full_like(eta, first), eta), ref


def _loss_scale(g, m_total):
    """loss_z = scale · Σ loss_sample."""
    return (1.0 / m_total) if g.sample_normalized else 1.0


def _lp_tol_refused(method, dtype) -> bool:
    """True (with a one-shot warning) when cg_lp_tol sits below the
    reachable CG forcing range for this dtype.

    Under the tightening-only endgame schedule (float32, not
    cg_adaptive — `_forcing_tol` with endgame=True) the forcing drops
    below the floor once the outer steps shrink, so cg_lp_tol == floor
    is exactly "bf16 through the bulk phase, float32 once the endgame
    tightens": the test ``tol >= cg_lp_tol`` holds at the floor and
    fails as soon as the schedule tightens. With cg_adaptive (or
    float64) the tolerance never passes below the floor, and equality
    would pin the copy through the endgame; a threshold below the floor
    would too, and CG would chase a residual below the copy's own error
    and spend cg_maxiter every epoch. Both are refused."""
    lp_tol = method.cg_lp_tol
    floor = _cg_tol(method, dtype)
    endgame_mode = (torch.finfo(dtype).bits <= 32
                    and not method.cg_adaptive)
    if lp_tol < floor or (lp_tol == floor and not endgame_mode):
        _warn_once(
            ("lp-tol-floor", (lp_tol, floor)),
            f"cg_lp_tol={lp_tol:g} is <= the CG tolerance floor "
            f"{floor:g} — the low-precision matvec would stay engaged "
            "through the convergence endgame and stall CG below the "
            "copy's own error. Disabled; set cg_lp_tol well above "
            "cg_tol (e.g. 1e-2).")
        return True
    return False


def _lp_engaged(method, prob: Problem, As, dtype) -> bool:
    """Whether precision-adaptive CG acts on this solve: cg_lp_tol > 0,
    a copy of A's shape (full batch: a batch slice has no matching
    copy), and a threshold that is not refused. Never for ProxNSCORE,
    which has no cg_lp_tol: as in the JAX package, its CG runs on A."""
    A_lp = prob.A_lp
    if (isinstance(method, ProxNSCORE) or method.cg_lp_tol <= 0.0
            or A_lp is None or A_lp.shape != As.shape
            or prob.rows_total(As) != prob.m_total):
        return False
    return not _lp_tol_refused(method, dtype)


def _kernel(method, As) -> bool:
    """Whether the step launches the kernels that fuse a row's dot with
    its scatter (K1, K1s, K2, K2s, K5) on the rows ``As``: under 'cuda',
    and not on a column shard, whose partial dots they cannot take (it
    takes their products route, `ops.dense`, as the JAX package's
    column-sharded solve does; K3 and K4 still launch there)."""
    return method.kernels == "cuda" and not is_colshard(As)


def _glm_matvec(method, prob: Problem):
    """(A, w, v) ↦ Aᵀ(w∘(A·v)) for the GLM CG operator: K1 under 'cuda'
    (for A in w's dtype or in bfloat16), K1s on a row-sharded problem
    (``method.comm_overlap_chunks`` picks its schedule), or their plain
    versions (a column shard's, `_kernel`)."""
    cuda = _kernel(method, prob.A)
    if prob.mesh is None:
        return normal_matvec if cuda else normal_matvec_torch
    return functools.partial(
        normal_matvec_sharded if cuda else normal_matvec_sharded_torch,
        mesh=prob.mesh, data_axis=prob.data_axis,
        overlap_chunks=method.comm_overlap_chunks)


def _lp_matvec(method, prob: Problem, As, w, lhr):
    """The low-precision CG operator v ↦ A_lpᵀ(w∘(A_lp·v)) + λHr∘v, or
    None when precision-adaptive CG does not act (`_lp_engaged`). It
    runs the same kernel as the full-precision operator, on the copy:
    K1 (or K1s on a row shard, where ``shard_problem`` took the copy's
    rows with A's) with A in bfloat16, the result in w's dtype."""
    if not _lp_engaged(method, prob, As, w.dtype):
        return None
    matvec = _glm_matvec(method, prob)
    A_lp = prob.A_lp
    return lambda v: matvec(A_lp, w, v) + lhr * v


def _cg_direction_solve(method, mv, mv_lp, b, d_prev, tol, M_inv):
    """Warm-started CG for the direction, on the low-precision operator
    ``mv_lp`` when it is given and ``tol >= method.cg_lp_tol`` (the bulk
    epochs), else on ``mv``. The test is on the very ``tol`` the solve
    then uses: a host branch when it is the fixed floor (a float), else
    the JAX package's `lax.cond`, `graph.device_cond` (the float32
    endgame schedule and cg_adaptive give a 0-d tensor)."""
    run = lambda op: cg_solve(op, b, d_prev, tol=tol,
                              maxiter=method.cg_maxiter, M_inv=M_inv)
    if mv_lp is None:
        return run(mv)
    if not isinstance(tol, torch.Tensor):
        return run(mv_lp if tol >= method.cg_lp_tol else mv)
    return device_cond(tol >= method.cg_lp_tol, lambda: run(mv_lp),
                       lambda: run(mv))


def epoch_cache_enabled(method, prob: Problem, reg_name: str,
                        full_batch: bool) -> bool:
    """Predicate for the epoch-fused cache path: ProxGGNSCORE or
    ProxNSCORE on the CG solver with ss_type=1, full-batch data, and
    either an mglm spec with
    loss_z and loss_sample (taking precedence, as in the JAX package) or
    a GLM spec with loss_z and loss_sample (the GGN forms fall back to
    dlink, res and qdiag without ggn_rw/ggn_w, `glm_prep.ggn_weights`),
    and no row-subsampled curvature (``curvature_rows`` does
    nothing on a row-sharded problem, as in the JAX package). A GGN
    solve that fails this takes the uncached path
    (`_ggn_cg_direction`)."""
    if (not isinstance(method, (ProxGGNSCORE, ProxNSCORE))
            or method.ss_type != 1):
        return False
    if method.epoch_cache is False:
        return False
    if not prob.has_data or prob.A.ndim != 2:
        return False
    mo, g = prob.mglm, prob.glm
    if mo is not None:
        if mo.loss_z is None or mo.loss_sample is None:
            return False
    elif g is None or g.loss_z is None or g.loss_sample is None:
        return False
    if not full_batch:
        return False
    # ProxNSCORE has neither curvature_rows nor cg_lp_tol
    if isinstance(method, ProxNSCORE):
        if method.static_precond and prob.col_sumsq is not None:
            return False
        return _resolve_newton_solver(method, prob.x0) == "cg"
    # curvature_rows subsamples rows only on an unsharded problem, as in
    # the JAX package: on a row shard it is a no-op and the cache stays
    if prob.mesh is None and 0 < method.curvature_rows < prob.m_total:
        return False
    # a refused cg_lp_tol warns here, once, as in the JAX package
    if method.cg_lp_tol > 0 and prob.A_lp is not None:
        _lp_tol_refused(method, prob.x0.dtype)
    # the static preconditioner acts off the cache only
    if method.static_precond and prob.col_sumsq is not None:
        return False
    return _resolve_ggn_solver(method, prob, prob.x0) == "cg"


def _cache_flavour(method) -> str:
    """The K2 flavour of a method's epoch cache: 'newton' (gres and the
    true Hessian weights hvp_w) for ProxNSCORE, 'ggn' otherwise."""
    return "newton" if isinstance(method, ProxNSCORE) else "ggn"


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


def _moglm_pair_prep(As, ys, g, x_t, x_d, prob: Problem = None):
    """Dual-candidate mglm prep: both candidates' Z, data gradient,
    Jacobi diagonal and loss from three A-reads (the per-candidate
    products batch into (m×p)·(p×2k) matmuls). Returns two
    (Z, grad_vec, hd_raw, loss) tuples, losses normalized. With ``prob``
    a row shard's: normalized by the rows of all ranks, and the
    gradients, diagonals and losses summed over the ranks in one
    all_reduce (Z stays per-row)."""
    k, pf = _mo_shapes(g, x_t)
    fix = (lambda v: v) if prob is None else prob.row_form(
        As, g.sample_normalized)
    total = As.shape[0] if prob is None else prob.rows_total(As)
    W2 = torch.cat([x_t.reshape(pf, k), x_d.reshape(pf, k)], dim=1)
    Z2 = amul(As, W2)                                # read 1
    Zt, Zd = Z2[:, :k].contiguous(), Z2[:, k:].contiguous()
    R2 = fix(torch.cat([g.gres(ys, Zt), g.gres(ys, Zd)], dim=1))
    G2 = atmul(As, R2)                               # read 2
    Q2 = fix(torch.cat([g.qdiag_w(ys, Zt), g.qdiag_w(ys, Zd)], dim=1))
    H2 = sq_atmul(As, Q2)                            # read 3
    scale = (1.0 / total) if g.sample_normalized else 1.0
    lt = _mo_loss_sum(prob, As, g.loss_sample(ys, Zt)) * scale
    ld = _mo_loss_sum(prob, As, g.loss_sample(ys, Zd)) * scale
    if prob is not None:
        G2, H2, lt, ld = prob.row_sum(G2, H2, lt, ld)
    return ((Zt, G2[:, :k].reshape(-1), H2[:, :k].reshape(-1), lt),
            (Zd, G2[:, k:].reshape(-1), H2[:, k:].reshape(-1), ld))


def _mo_loss_sum(prob: Problem, As, samples):
    """Σ of per-sample losses over the rows ``As``, a mini-batch's pad
    rows left out (`Problem.rows`; ``prob`` None: unsharded)."""
    rs = None if prob is None or prob.mesh is None else prob.rows
    if rs is not None and As is rs.A:
        samples = samples * rs.mask
    return torch.sum(samples)


def _prime_moglm(prob: Problem, x, As, ys) -> MOGLMCache:
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    fix = prob.row_form(As, g.sample_normalized)
    Z = amul(As, x.reshape(pf, k))
    grad_vec = atmul(As, fix(g.gres(ys, Z))).reshape(-1)
    hd = sq_atmul(As, fix(g.qdiag_w(ys, Z))).reshape(-1)
    scale = (1.0 / prob.rows_total(As)) if g.sample_normalized else 1.0
    loss = _mo_loss_sum(prob, As, g.loss_sample(ys, Z)) * scale
    grad_vec, hd, loss = prob.row_sum(grad_vec, hd, loss)
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
    flavour = _cache_flavour(method)
    if _kernel(method, As):
        pp = glm_prep_pair(As, ys, x, x, g, prob.m_total, flavour)
        w, b, hd, loss = pp.w_t, pp.b_t, pp.hd_t, pp.loss_t
    else:
        w, b, hd, loss = glm_prep_torch(As, ys, x, g, prob.m_total, flavour)
    b, hd, loss = prob.row_sum(b, hd, loss)
    return GLMCache(w, b, hd, loss * _loss_scale(g, prob.m_total))


def _ggn_cg_from_cache(method, prob: Problem, As, x, gr, Hr_diag, lam,
                       cache: GLMCache, d_prev, it, bnorm_prev, x_prev):
    """GGN-CG direction with no prep pass over A: RHS, matvec weights and
    Jacobi diagonal come from the cache; only the smoother terms
    (λ·gr, λ·Hr) are fresh. Each CG iteration is one K1 launch, or on a
    row-sharded problem one K1s call (K1 on the shard plus an
    all_reduce; ``method.comm_overlap_chunks`` picks its schedule) —
    on the bfloat16 copy of A in the bulk epochs of precision-adaptive
    CG (`_cg_direction_solve`)."""
    lhr = lam * Hr_diag
    b = -(cache.b_raw + lam * gr)
    diag = torch.clamp_min(cache.hd_raw + lhr, torch.finfo(x.dtype).tiny)
    w = cache.w
    matvec = _glm_matvec(method, prob)
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = _cg_direction_solve(
        method, lambda v: matvec(As, w, v) + lhr * v,
        _lp_matvec(method, prob, As, w, lhr), b, d_prev, tol,
        lambda v: v / diag)
    return res.x, res.iters, bnorm


def _mo_curv_matvec(method, prob: Problem, As, ys, Z, g, lhr, pf, k,
                    m_norm=None):
    """The mglm curvature matvec v ↦ vec(Aᵀ·quad(y, Z, A·V)) + λHr∘v from
    the cached Z — one K5 launch, or its plain version, normalized by
    ``m_norm`` rows (default: the rows ``As`` stands for), and on a row
    shard followed by one all_reduce of its (p, k) result."""
    mv = mglm_matvec if _kernel(method, As) else mglm_matvec_torch
    m_norm = prob.rows_total(As) if m_norm is None else m_norm
    return lambda v: prob.row_sum(mv(As, ys, Z, v.reshape(pf, k), g,
                                     m_norm))[0].reshape(-1) + lhr * v


def _mo_lp_matvec(method, prob: Problem, As, ys, Z, g, lhr, pf, k):
    """The low-precision curvature matvec of the cached multi-output
    path, or None when precision-adaptive CG does not act
    (`_lp_engaged`): `_mo_curv_matvec` on the copy ``prob.A_lp`` — one
    K5 launch with A in bfloat16 — while the cached Z, the spec's quad
    and the RHS stay in x's dtype. The JAX package sends this product
    through its XLA pair rather than its kernel; the function is the
    same, and PyTorch multiplies no bfloat16 matrix by a wider one."""
    if not _lp_engaged(method, prob, As, Z.dtype):
        return None
    return _mo_curv_matvec(method, prob, prob.A_lp, ys, Z, g, lhr, pf, k,
                           prob.rows_total(As))


def _mo_cg_from_cache(method, prob: Problem, As, ys, x, gr, Hr_diag, lam,
                      cache: MOGLMCache, d_prev, it, bnorm_prev, x_prev):
    """Multi-output GGN-CG direction from the carried MOGLMCache: no
    prep pass over A; each CG matvec applies the per-sample curvature
    action from the cached Z (one K5 launch per iteration) — on the
    bfloat16 copy of A in the bulk epochs of precision-adaptive CG
    (`_mo_lp_matvec`, `_cg_direction_solve`)."""
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    lhr = lam * Hr_diag
    b = -(cache.grad_vec + lam * gr)
    diag = torch.clamp_min(cache.hd_raw + lhr, torch.finfo(x.dtype).tiny)
    mv = _mo_curv_matvec(method, prob, As, ys, cache.Z, g, lhr, pf, k)
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = _cg_direction_solve(
        method, mv, _mo_lp_matvec(method, prob, As, ys, cache.Z, g, lhr, pf,
                                  k), b, d_prev, tol, lambda v: v / diag)
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
    ct, cd = _moglm_pair_prep(As, ys, prob.mglm, x_trial, x_damped, prob)
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
    pair = glm_prep_pair if _kernel(method, As) else glm_prep_pair_torch
    pp = pair(As, ys, x_trial, x_damped, g, prob.m_total,
              _cache_flavour(method))
    if prob.mesh is not None:
        pp = pp._replace(**dict(zip(_SUMMED, prob.row_sum(
            *(getattr(pp, f) for f in _SUMMED)))))
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


def _weighted_system(method, prob: Problem, As, x, w, lhr, hd_raw=None):
    """(matvec, preconditioner) from GLM weights w:
    mv(v) = Aᵀ(w∘(Av)) + λHr∘v (one K1 launch under 'cuda'), Jacobi
    M⁻¹ = 1/(Σᵢ wᵢAᵢⱼ² + λHr). ``hd_raw`` is Σᵢ wᵢAᵢⱼ² when the prep
    already has it (K2s); otherwise the plain diagonal builds one A-sized
    temporary. With ``static_precond`` and the problem's ``col_sumsq``
    the diagonal is (Σw/m)·diag(AᵀA) + λHr instead, O(m + n), where
    ``As`` holds all of A's rows (a subsample has other column sums):
    exact where w is uniform (least squares), the same CG operator and
    fixed point otherwise. On a row shard w is this rank's rows (already
    normalized by the rows of all ranks), the matvec is K1s and the
    diagonal's sums (given ``hd_raw`` is summed already) run over the
    ranks."""
    tiny = torch.finfo(x.dtype).tiny
    matvec = _glm_matvec(method, prob)
    if (method.static_precond and prob.col_sumsq is not None
            and prob.rows_total(As) == prob.m_total):
        wsum, = prob.row_sum(torch.sum(w))
        hdiag = (wsum / prob.m_total) * prob.col_sumsq + lhr
    else:
        if hd_raw is None:
            hd_raw, = prob.row_sum(sq_atmul(As, w))
        hdiag = hd_raw + lhr
    return (lambda v: matvec(As, w, v) + lhr * v,
            lambda v: v / torch.clamp_min(hdiag, tiny))


def _mo_glm_system(method, prob: Problem, As, ys, x, lhr):
    """(Z, grad_vec, matvec, preconditioner) for a multi-output GLM off
    the epoch cache: Z = A·W once (W = x.reshape(p, k)),
    ∇f = vec(Aᵀ·gres(y, Z)), each matvec the per-sample curvature action
    vec(Aᵀ·quad(y, Z, A·V)) + λHr∘v (one K5 launch under 'cuda'), Jacobi
    diagonal Σᵢ qdiag_wᵢ·Aᵢⱼ² + λHr."""
    g = prob.mglm
    k, pf = _mo_shapes(g, x)
    fix = prob.row_form(As, g.sample_normalized)
    Z = amul(As, x.reshape(pf, k))
    grad_vec, hd = prob.row_sum(
        atmul(As, fix(g.gres(ys, Z))).reshape(-1),
        sq_atmul(As, fix(g.qdiag_w(ys, Z))).reshape(-1))
    mv = _mo_curv_matvec(method, prob, As, ys, Z, g, lhr, pf, k)
    hdiag = hd + lhr
    tiny = torch.finfo(x.dtype).tiny
    return Z, grad_vec, mv, lambda v: v / torch.clamp_min(hdiag, tiny)


def _glm_cg_system(method, prob: Problem, As, ys, x, lhr, weight_fn,
                   hvp_fallback):
    """(matvec, preconditioner) of a CG system without a spec: from the
    problem's weight hook w = weight_fn(A, y, x) through
    `_weighted_system` (K1 under 'cuda'), else the operator
    hvp_fallback(v) + λHr∘v with the Jacobi diagonal λHr."""
    if weight_fn is not None and prob.has_data and As.ndim == 2:
        return _weighted_system(method, prob, As, x, prob.row_form(As)(
            weight_fn(As, ys, x)), lhr)
    tiny = torch.finfo(x.dtype).tiny
    return (lambda v: hvp_fallback(v) + lhr * v,
            lambda v: v / torch.clamp_min(lhr, tiny))


def _cached_step(method, prob: Problem, reg_name, sm, As, ys, x, x_prev,
                 it, d_prev, bnorm_prev, fcache, gq_prev, mem, lam, gr,
                 Hr_diag, cw) -> StepOut:
    """The epoch-fused step of `newton_step` and `ggn_step` (CG solver,
    ``fcache`` primed in the method's flavour, `_cache_flavour`): CG from
    the cache, the step size, and the update pass that is also the next
    epoch's prep. ``gq`` comes back as zeros."""
    zeros = torch.zeros_like(x)
    d, cg_iters, bnorm = _cg_from_cache(
        method, prob, As, ys, x, gr, Hr_diag, lam, fcache, d_prev, it,
        bnorm_prev, x_prev)
    ss = _resolve_step_size(method, prob, sm, reg_name, As, ys, x, x_prev,
                            zeros, gq_prev, d, it, cw)
    x_new, pri, dx, fc_new = _cached_update(
        method, prob, reg_name, sm, As, ys, x, d, ss, lam, lam * gr,
        Hr_diag, fcache)
    return StepOut(x_new, pri, dx, zeros, zeros, mem, d, cg_iters, bnorm,
                   fc_new)


def newton_step(method: ProxNSCORE, prob: Problem, reg_name: str, sm,
                As, ys, x, x_prev, it, d_prev=None, bnorm_prev=None,
                fcache: GLMCache = None, gq_prev=None,
                mem: LBFGSMemory = None) -> StepOut:
    """One proximal Newton step with self-concordant damping:
    d = −(∇²f + λ·diag(Hr))⁻¹ (∇f + λ·gr), by the dense solve or by
    Newton-CG warm-started from −d_prev.

    With ``fcache`` (primed by the driver when `epoch_cache_enabled`,
    newton flavour) the step is the cached path of `ggn_step`. Off the
    cache ∇q is formed once: for a GLM (CG) from z = A·x, with the CG
    matvecs K1 on hvp_w's weights and z reused by the greedy trial; for
    an mglm (CG) from Z = A·W, with `_mo_glm_system`'s operator (K5),
    which is the Hessian; else ∇f, with the problem's hvp_w weights or
    forward-over-reverse HVPs. ``gq`` comes back as ∇q at x."""
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    gr = sm.grad(x, cw)
    lgr = lam * gr
    Hr_diag = sm.hess_diag(x, cw)
    zeros = torch.zeros_like(x)
    solver = _resolve_newton_solver(method, x)
    if solver == "cg" and fcache is not None:
        return _cached_step(method, prob, reg_name, sm, As, ys, x, x_prev,
                            it, d_prev, bnorm_prev, fcache, gq_prev, mem,
                            lam, gr, Hr_diag, cw)

    lhr = lam * Hr_diag
    data_2d = prob.has_data and As.ndim == 2
    z_cache = None
    if solver == "cg" and prob.mglm is not None and data_2d:
        _, grad_vec, mv, M_inv = _mo_glm_system(method, prob, As, ys, x,
                                                lhr)
        gq = grad_vec + lgr
    elif solver == "cg" and prob.glm is not None and data_2d:
        z_cache = amul(As, x)
        fix = prob.row_form(As, prob.glm.sample_normalized)
        gq = prob.row_sum(atmul(As, fix(prob.glm.gres(ys, z_cache))))[0]
        gq = gq + lgr
        mv, M_inv = _weighted_system(method, prob, As, x,
                                     fix(prob.glm.hvp_w(ys, z_cache)), lhr)
    else:
        gq = prob.grad_f(As, ys, x) + lgr
        if solver == "cg":
            mv, M_inv = _glm_cg_system(
                method, prob, As, ys, x, lhr, prob.hvp_w,
                lambda v: prob.hvp_f(As, ys, x, v))

    cg_iters = 0
    bnorm = torch.zeros((), dtype=x.dtype, device=x.device)
    if solver == "dense":
        H = prob.hess_f(As, ys, x)
        # solve_ex: a singular system gives NaN on the card, as in the JAX
        # package, where solve would read its status on the host
        d = -torch.linalg.solve_ex(H + lam * torch.diag(Hr_diag), gq)[0]
    elif solver == "cg":
        xp = x if x_prev is None else x_prev
        tol, bnorm = _forcing_tol(method, gq, x, xp, bnorm_prev, it,
                                  endgame=True)
        res = cg_solve(mv, gq, None if d_prev is None else -d_prev,
                       tol=tol, maxiter=method.cg_maxiter, M_inv=M_inv)
        d = -res.x
        cg_iters = res.iters
    else:
        raise ValueError(f"unknown ProxNSCORE solver {solver!r}")

    # ∇q at x_prev for BB, recomputed (the JAX package's fix of the
    # reference's Newton BB branch)
    if method.ss_type == 2:
        gqp = prob.grad_f(As, ys, x_prev) + lam * sm.grad(x_prev, cw)
    else:
        gqp = gq_prev
    ss = _resolve_step_size(method, prob, sm, reg_name, As, ys, x, x_prev,
                            gq, gqp, d, it, cw)
    x_new, pri, dx = _apply_update(method, prob, reg_name, sm, As, ys, x,
                                   d, ss, lam, lgr, Hr_diag, z=z_cache)
    return StepOut(x_new, pri, dx, gq, zeros, mem, d, cg_iters, bnorm)


def _ggn_dense_direction(solver, prob: Problem, As, ys, x, gr, Hr_diag,
                         lam):
    """The reference's dense GGN direction over the materialized J
    (`Problem.ggn_pieces`), with its dual/primal switch. With
    Jt = [Jᵀ  λ·gr] (n × (q+1)), r̃ = [residual; 1] and Q̃ = Q padded:
      dual   (q+1 ≤ n under 'auto', or 'dense_dual'):
             d = H⁻¹ Jt (I + Q̃ JtᵀH⁻¹Jt)⁻¹ r̃, H = diag(Hr) — with no λ,
             the reference's quirk, which the JAX package reproduces;
      primal (else): d = (Jt Q̃ Jtᵀ + λ·diag(Hr))⁻¹ Jt r̃.
    On a row shard (residual and Q this rank's share, `Problem.row_form`;
    Q block-diagonal over the rows, as a loss that is a mean over rows
    gives it) the primal system Jt Q̃ Jtᵀ and its right-hand side are
    summed over the ranks (r̃'s 1 counted on rank 0 only), and the dual
    one, which couples every row with every other, is built from every
    rank's rows of J, the residual and Q (`gather_rows`); q is the rows
    of all ranks times the outputs a row. Returns −d."""
    n = x.shape[-1]
    _, J, residual, Q = prob.ggn_pieces(As, ys, x)
    J2 = J.reshape(-1, n)
    q = J2.shape[0]
    dt, dev = x.dtype, x.device
    residual = residual.reshape(-1)
    Q = torch.as_tensor(Q).reshape(q, q)
    q_all = q
    one = 1.0
    mesh = prob.mesh
    if mesh is not None:
        rows = As.shape[0]
        fix = prob.row_form(As)
        residual = fix(residual.reshape(rows, -1)).reshape(-1)
        Q = fix(Q.reshape(rows, -1)).reshape(q, q)
        q_all = prob.rows_total(As) * (q // max(rows, 1))
        ax = prob.data_axis
        one = 1.0 if mesh.axis_rank(ax) == 0 else 0.0
    use_dual = ((q_all + 1 <= n) if solver == "auto"
                else solver == "dense_dual")
    if mesh is not None and use_dual:
        from scso_tpu_torch.parallel.sharding import gather_rows

        rank, size = mesh.axis_rank(ax), mesh.axis_size(ax)
        block = Q.new_zeros((q, size * q))
        block[:, rank * q:(rank + 1) * q] = Q
        J2, residual, Q = (gather_rows(mesh, J2, ax),
                           gather_rows(mesh, residual, ax),
                           gather_rows(mesh, block, ax))
        q, one = J2.shape[0], 1.0
    Jt = torch.cat([J2.T, (lam * gr)[:, None]], dim=1)
    rt = torch.cat([residual, torch.full((1,), one, dtype=dt, device=dev)])
    Qp = torch.zeros((q + 1, q + 1), dtype=dt, device=dev)
    Qp[:q, :q] = Q
    if use_dual:
        hinv = 1.0 / Hr_diag
        Amat = Qp @ (Jt.T @ (Jt * hinv[:, None]))
        B = torch.linalg.solve_ex(
            torch.eye(q + 1, dtype=dt, device=dev) + Amat, rt)[0]
        d = hinv * (Jt @ B)
    else:
        M, rhs = prob.row_sum((Jt @ Qp) @ Jt.T, Jt @ rt)
        M = M + lam * torch.diag(Hr_diag)
        d = torch.linalg.solve_ex(M, rhs)[0]
    return -d


def _curvature_stride(method, prob: Problem, As, x) -> int:
    """The row stride of subsampled curvature, or 0 where it does not
    act: ``curvature_rows`` K with 0 < K < m on an unsharded problem
    (as in the JAX package, a no-op on a row shard). A subsample
    thinner than 2·n rows warns once: its curvature is near singular."""
    K = method.curvature_rows
    m = As.shape[0]
    if not (0 < K < m) or prob.mesh is not None:
        return 0
    if K < 2 * x.shape[-1]:
        _warn_once(
            ("curv-thin", (K, x.shape[-1])),
            f"curvature_rows={K} < 2·n={2 * x.shape[-1]}: the "
            "subsampled curvature is (near-)rank-deficient — expect CG to "
            "struggle or the outer iteration to diverge. Use "
            "curvature_rows >> n.")
    return -(-m // K)


def _subsampled_weights(method, prob: Problem, As_c, ys_c, x, m):
    """The GGN weights on the subsample (``As_c`` its rows) and, under
    'cuda', their Jacobi diagonal from K2s: a sample-normalized spec's
    1/len(z) forms average over the subsample already; any other spec's
    weights are scaled by m/m_sub."""
    g = prob.glm
    m_sub = As_c.shape[0]
    if _kernel(method, As_c):
        w, _, hd = glm_prep(As_c, ys_c, x, g)
    else:
        w, hd = ggn_weights(g, ys_c, amul(As_c, x))[1], None
    if not g.sample_normalized:
        w = w * (m / m_sub)
        hd = None if hd is None else hd * (m / m_sub)
    return w, hd


def _ggn_cg_direction(method, prob: Problem, As, ys, x, gr, Hr_diag, lam,
                      d_prev=None, it=None, bnorm_prev=None, x_prev=None):
    """Matrix-free GGN-CG direction off the epoch cache: solve
    (JᵀQJ + λ·diag(Hr)) d = −(Jᵀr + λ·gr) by warm-started Jacobi-
    preconditioned CG, every piece prepared afresh at x.

    A GLM preps in one call to K2s (`glm_prep`) under 'cuda' unless
    ``use_fused_prep`` is False — at every shape: the JAX package's AUTO
    gate n ≥ 8192 was measured on a TPU v5e — and otherwise forms
    z = A·x and the spec's weights (`_weighted_system`); its bulk epochs
    may run CG on the bfloat16 copy of A (`_cg_direction_solve`). With
    subsampled curvature (`_curvature_stride`) the RHS comes from all
    rows and the operator from every stride-th row (`A[::stride]`,
    copied each epoch; K1 on it under 'cuda'), never on the copy. An
    mglm goes through `_mo_glm_system` and, as in the JAX package, never
    reads the copy. A problem without a spec applies J by jvp and vjp of
    its ``out_fn`` (the ``ggn_w`` hook's weights through K1 where it has
    one, else the Jacobi diagonal λHr). Returns (d, cg_iters, bnorm, z),
    z the linear predictor when one was formed (the greedy trial reuses
    it), else None."""
    z_cache = None
    mv_lp = None
    lhr = lam * Hr_diag
    data_2d = prob.has_data and As.ndim == 2
    if prob.mglm is not None and data_2d:
        _, grad_vec, mv, M_inv = _mo_glm_system(method, prob, As, ys, x,
                                                lhr)
        b = -(grad_vec + lam * gr)
    elif prob.glm is not None and data_2d:
        stride = _curvature_stride(method, prob, As, x)
        fused = _kernel(method, As) and method.use_fused_prep is not False
        if fused:
            w, b_raw, hd_raw = glm_prep(As, ys, x, prob.glm,
                                        prob.rows_total(As))
            b_raw, hd_raw = prob.row_sum(b_raw, hd_raw)
        else:
            z_cache = amul(As, x)
            fix = prob.row_form(As, prob.glm.sample_normalized)
            rw, w = (fix(v) for v in ggn_weights(prob.glm, ys, z_cache))
            b_raw, = prob.row_sum(atmul(As, rw))
            hd_raw = None
        b = -(b_raw + lam * gr)
        if stride:
            As_c = As[::stride].contiguous()
            ys_c = ys[::stride].contiguous()
            w_c, hd_c = _subsampled_weights(method, prob, As_c, ys_c, x,
                                            As.shape[0])
            mv, M_inv = _weighted_system(method, prob, As_c, x, w_c, lhr,
                                         hd_c)
        else:
            mv, M_inv = _weighted_system(method, prob, As, x, w, lhr,
                                         hd_raw)
            mv_lp = _lp_matvec(method, prob, As, w, lhr)
    else:
        _, residual, q_diag = prob.ggn_residual_qdiag(As, ys, x)
        fix = prob.row_form(As)
        residual, q_diag = fix(residual), fix(q_diag)
        # a fresh vjp a product: autograd runs a backward on the stream
        # of its forward, so a CG iteration captured into a conditional
        # body must make its own forward there; on a row shard Jᵀu is
        # summed over the ranks (J·v stays per-row)
        jt = lambda u: prob.row_sum(prob.vjp_out(As, x)[1](u))[0]
        b = -(jt(residual) + lam * gr)
        mv, M_inv = _glm_cg_system(
            method, prob, As, ys, x, lhr, prob.ggn_w,
            lambda v: jt(q_diag * prob.jvp_out(As, x, v)))
    xp = x if x_prev is None else x_prev
    tol, bnorm = _forcing_tol(method, b, x, xp, bnorm_prev, it,
                              endgame=True)
    res = _cg_direction_solve(method, mv, mv_lp, b, d_prev, tol, M_inv)
    return res.x, res.iters, bnorm, z_cache


def ggn_step(method: ProxGGNSCORE, prob: Problem, reg_name: str, sm,
             As, ys, x, x_prev, it, d_prev=None, bnorm_prev=None,
             fcache: GLMCache = None, gq_prev=None,
             mem: LBFGSMemory = None) -> StepOut:
    """One generalized Gauss-Newton step with self-concordant damping.

    With ``fcache`` (primed by the driver when `epoch_cache_enabled`)
    the step runs the epoch-fused path: cached prep → CG → the update
    pass that is also the next epoch's prep. Without it, the uncached
    path: `_ggn_cg_direction` (or, for the dense solvers,
    `_ggn_dense_direction`), the step size (ss_type 2 prices the
    composite gradient at x and x_prev, two gradients), and the damped
    or greedy tail. ``gq``/``gq_new`` come back as zeros and ``mem``
    unchanged, as in the JAX package."""
    lam = _lam_scalar(prob.lam)
    cw = _cw(prob, reg_name)
    gr = sm.grad(x, cw)
    lgr = lam * gr
    Hr_diag = sm.hess_diag(x, cw)
    zeros = torch.zeros_like(x)
    solver = _resolve_ggn_solver(method, prob, x, As)
    if solver == "cg" and fcache is not None:
        return _cached_step(method, prob, reg_name, sm, As, ys, x, x_prev,
                            it, d_prev, bnorm_prev, fcache, gq_prev, mem,
                            lam, gr, Hr_diag, cw)
    if solver == "cg":
        d, cg_iters, bnorm, z_cache = _ggn_cg_direction(
            method, prob, As, ys, x, gr, Hr_diag, lam, d_prev, it=it,
            bnorm_prev=bnorm_prev, x_prev=x_prev)
    else:
        d = _ggn_dense_direction(solver, prob, As, ys, x, gr, Hr_diag, lam)
        cg_iters, z_cache = 0, None
        bnorm = torch.zeros((), dtype=x.dtype, device=x.device)
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
               As, ys, x, x_prev, gq_prev, it, mem: LBFGSMemory,
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
    if isinstance(method, ProxNSCORE):
        return newton_step
    if isinstance(method, ProxGGNSCORE):
        return ggn_step
    if isinstance(method, ProxLQNSCORE):
        return lbfgs_step
    raise TypeError(f"unknown method {method!r}")
