"""scso_tpu_torch — the PyTorch / CUDA port of scso_tpu.

Self-concordant-smoothing (SCORE) optimization of f(x) + g(x) on an
NVIDIA H100: plain tensor code in PyTorch, and every TPU (Pallas) kernel
of the ported path replaced by a CUDA kernel written for Hopper
(``csrc/``, built by ``ops/cuda/build.py`` on first use). The JAX
package ``scso_tpu`` stays the reference; module names mirror it.

Ported, on full batches, with every smoother family (pseudo-Huber and
Ostrovskii–Bach l1/l2, the box-indicator smoothers, the group-lasso
ones) and the l1, l2, indbox and sparse-group-lasso ('gl') proxes:
``ProxNSCORE`` (proximal Newton: dense, or Newton-CG through the
epoch-fused cache and off it), ``ProxGGNSCORE`` (GGN-CG through the
cache and off it, and the dense dual and primal solves that
``solver='auto'`` takes on small problems), with step-size modes 1, 2
and 3, and ``ProxLQNSCORE`` (L-BFGS, the default method of
``iterate``), on sparse logistic regression with 0/1 labels, least
squares and Poisson regression (``GLMSpec``), multinomial softmax
regression (``MOGLMSpec``, ``mglm=``), or any data f with its
derivative hooks or autograd.
Problems without data (``Problem(x0, f, lam)``: f(x)) run every method.
GGN-CG on a GLM spec runs precision-adaptive CG on a bfloat16 copy of A
(``with_lp_copy`` with ``cg_lp_tol``, or ``auto_lp``), subsampled
curvature (``curvature_rows``) or the static Jacobi preconditioner
(``static_precond`` with ``with_col_sumsq``). ``iterate`` has the JAX
package's two modes, 'fused' (the default; on the card the solve is
captured into a CUDA graph and replayed) and 'timed', with its
mini-batches, metrics, test set and resume (``resume_state``;
``utils.save_state``/``load_state``); ``iterate_continuation`` anneals
μ and λ. ``scso_tpu_torch.parallel`` shards any single solve over the
ranks of a mesh of one or two axes, by rows, by features or both (every
method, captured over NCCL), and solves λ/μ paths, problem fleets and
federated rounds as one batched solve (``sweep``, ``solve_fleet``,
``federated_solve``: the instances on a leading axis, also split over a
batch axis of row-sharded problems; on the card one captured graph).
``utils.export_solver`` writes the whole fused solve as a
``torch.export`` program that loads with torch alone (K1–K5 as custom
ops, their library in the artifact). What the port leaves out raises
NotImplementedError naming its ROADMAP item (A12: serving and exporting
a sharded problem).
"""

from __future__ import annotations

import torch

from scso_tpu_torch.algorithms.continuation import iterate_continuation
from scso_tpu_torch.algorithms.iterate import Options, Solution, iterate, solve
from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProximalMethod, ProxNSCORE)
from scso_tpu_torch.algorithms.mixed import iterate_mixed, with_lp_copy
from scso_tpu_torch.ops import smoothers as _smoothers
from scso_tpu_torch.ops.groups import (
    Groups, lasso_fz, make_contiguous_groups, make_groups,
    make_groups_from_ind)
from scso_tpu_torch.ops.linalg import armijo_linesearch, cg_solve, inv_bb_step
from scso_tpu_torch.ops.prox import (
    prox_group_lasso, prox_indbox, prox_l1, prox_l2, prox_step)
from scso_tpu_torch.ops.regularizers import indbox_f, reg_value
from scso_tpu_torch.ops.smoothers import (
    NoSmooth, OsBaSmootherL1L2, PHuberSmootherL1L2, get_Mg, sanitize_bounds)
from scso_tpu_torch.problems import (
    GLMSpec, Interval, MOGLMSpec, ProblemLike, is_interval_set,
    with_col_sumsq)
from scso_tpu_torch.problems import Problem as CompositeProblem
from scso_tpu_torch.problems import make_problem

__version__ = "0.5.0"

# the reference's constructor call shapes, as in the JAX package
Problem = make_problem


def _bounded(cls, lb, ub, mu):
    a, b = sanitize_bounds(lb, ub)
    return cls(lb=torch.from_numpy(a), ub=torch.from_numpy(b), mu=mu)


def PHuberSmootherIndBox(lb, ub, mu):
    """Pseudo-Huber box-indicator smoother."""
    return _bounded(_smoothers.PHuberSmootherIndBox, lb, ub, mu)


def ExponentialSmootherIndBox(lb, ub, mu):
    """Exponential box-indicator smoother."""
    return _bounded(_smoothers.ExponentialSmootherIndBox, lb, ub, mu)


def LogExpSmootherIndBox(lb, ub, mu):
    """Log-exp box-indicator smoother."""
    return _bounded(_smoothers.LogExpSmootherIndBox, lb, ub, mu)


def PHuberSmootherGL(mu, model):
    """Group-lasso pseudo-Huber smoother: λ₁, λ₂ and the groups from
    ``model``."""
    return _smoothers.make_gl_smoother(_smoothers.PHuberSmootherGL, mu, model)


def OsBaSmootherGL(mu, model):
    """Group-lasso Ostrovskii–Bach smoother: λ₁, λ₂ and the groups from
    ``model``."""
    return _smoothers.make_gl_smoother(_smoothers.OsBaSmootherGL, mu, model)


def get_reg(model, x, reg_name: str):
    """The true nonsmooth g(x) of ``model``."""
    return model.reg(reg_name, x)


# the reference's group-structure constructor, on its 3×G ``ind`` matrix
get_P = make_groups_from_ind

__all__ = [
    "Problem",
    "CompositeProblem",
    "GLMSpec",
    "MOGLMSpec",
    "make_problem",
    "ProblemLike",
    "with_col_sumsq",
    "Interval",
    "is_interval_set",
    "ProxNSCORE",
    "ProxGGNSCORE",
    "ProxLQNSCORE",
    "ProximalMethod",
    "iterate",
    "iterate_continuation",
    "solve",
    "Options",
    "Solution",
    "iterate_mixed",
    "with_lp_copy",
    "NoSmooth",
    "PHuberSmootherL1L2",
    "OsBaSmootherL1L2",
    "PHuberSmootherIndBox",
    "ExponentialSmootherIndBox",
    "LogExpSmootherIndBox",
    "PHuberSmootherGL",
    "OsBaSmootherGL",
    "get_Mg",
    "get_reg",
    "sanitize_bounds",
    "get_P",
    "prox_step",
    "prox_l1",
    "prox_l2",
    "prox_indbox",
    "prox_group_lasso",
    "reg_value",
    "indbox_f",
    "Groups",
    "make_groups",
    "make_groups_from_ind",
    "make_contiguous_groups",
    "lasso_fz",
    "cg_solve",
    "inv_bb_step",
    "armijo_linesearch",
]
