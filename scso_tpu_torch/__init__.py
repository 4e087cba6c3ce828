"""scso_tpu_torch — the PyTorch / CUDA port of scso_tpu.

Self-concordant-smoothing (SCORE) optimization of f(x) + g(x) on an
NVIDIA H100: plain tensor code in PyTorch, and every TPU (Pallas) kernel
of the ported path replaced by a CUDA kernel written for Hopper
(``csrc/``, built by ``ops/cuda/build.py`` on first use). The JAX
package ``scso_tpu`` stays the reference; module names mirror it.

Two paths are ported, both solved by ``ProxGGNSCORE(solver='cg')`` with
the pseudo-Huber l1 smoother, on full batches, through the epoch-fused
cache: sparse logistic regression with 0/1 labels (``GLMSpec``), and
multinomial softmax regression (``MOGLMSpec``, ``mglm=``). What the
port leaves out raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from scso_tpu_torch.algorithms.iterate import Options, Solution, iterate, solve
from scso_tpu_torch.algorithms.methods import ProxGGNSCORE
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
    "ProxGGNSCORE",
    "iterate",
    "solve",
    "Options",
    "Solution",
    "PHuberSmootherL1L2",
    "get_Mg",
    "prox_step",
    "prox_l1",
    "prox_l2",
    "prox_indbox",
    "reg_value",
    "cg_solve",
]
