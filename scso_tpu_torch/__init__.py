"""scso_tpu_torch — the PyTorch / CUDA port of scso_tpu.

Self-concordant-smoothing (SCORE) optimization of f(x) + g(x) on an
NVIDIA H100: plain tensor code in PyTorch, and every TPU (Pallas) kernel
of the ported path replaced by a CUDA kernel written for Hopper
(``csrc/``, built by ``ops/cuda/build.py`` on first use). The JAX
package ``scso_tpu`` stays the reference; module names mirror it.

Ported, on full batches with the pseudo-Huber l1 smoother:
``ProxNSCORE`` (proximal Newton: dense, or Newton-CG through the
epoch-fused cache and off it), ``ProxGGNSCORE`` (GGN-CG through the
cache and off it, and the dense dual and primal solves that
``solver='auto'`` takes on small problems), with step-size modes 1, 2
and 3, and ``ProxLQNSCORE`` (L-BFGS, the default method of
``iterate``), on sparse logistic regression with 0/1 labels
(``GLMSpec``), multinomial softmax regression (``MOGLMSpec``,
``mglm=``), or any data f with its derivative hooks or autograd.
GGN-CG on a GLM spec runs precision-adaptive CG on a bfloat16 copy of A
(``with_lp_copy`` with ``cg_lp_tol``, or ``auto_lp``). What the port leaves out raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

from scso_tpu_torch.algorithms.iterate import Options, Solution, iterate, solve
from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProxNSCORE)
from scso_tpu_torch.algorithms.mixed import iterate_mixed, with_lp_copy
from scso_tpu_torch.ops.linalg import cg_solve
from scso_tpu_torch.ops.prox import prox_l1, prox_l2, prox_indbox, prox_step
from scso_tpu_torch.ops.regularizers import reg_value
from scso_tpu_torch.ops.smoothers import PHuberSmootherL1L2, get_Mg
from scso_tpu_torch.problems import GLMSpec, MOGLMSpec
from scso_tpu_torch.problems import Problem as CompositeProblem
from scso_tpu_torch.problems import make_problem

Problem = make_problem

__all__ = [
    "Problem",
    "CompositeProblem",
    "GLMSpec",
    "MOGLMSpec",
    "make_problem",
    "ProxNSCORE",
    "ProxGGNSCORE",
    "ProxLQNSCORE",
    "iterate",
    "solve",
    "Options",
    "Solution",
    "iterate_mixed",
    "with_lp_copy",
    "PHuberSmootherL1L2",
    "get_Mg",
    "prox_step",
    "prox_l1",
    "prox_l2",
    "prox_indbox",
    "reg_value",
    "cg_solve",
]
