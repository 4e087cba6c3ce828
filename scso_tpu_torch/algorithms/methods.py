"""Method configuration objects (frozen, hashable).

Port of `scso_tpu.algorithms.methods.ProxGGNSCORE`. Field meanings and
defaults are the JAX package's; see its docstrings for the measurements
behind them. ``kernels`` differs:
  * 'auto'  — resolved by `iterate` to 'cuda' for problems whose data
    lies on a CUDA device and to 'torch' otherwise;
  * 'cuda'  — the hand-written CUDA kernels (ops/cuda/) at every shape;
    a tensor or GLM spec they do not take raises;
  * 'torch' — the plain PyTorch versions on any device.
ProxNSCORE and ProxLQNSCORE are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_KERNEL_MODES = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ProxGGNSCORE:
    """Proximal generalized Gauss-Newton with self-concordant
    regularization. The port runs ``solver='cg'`` (matrix-free GGN-CG on
    a GLM spec); 'auto' resolves to 'cg' above the dense budget and the
    dense branches are not ported yet (ROADMAP A7)."""

    ss_type: int = 1
    use_prox: bool = True
    solver: str = "auto"
    #: CG forcing floor; 0.0 = AUTO (3e-4 in float32, sqrt(eps) in
    #: float64) — see steps._cg_tol
    cg_tol: float = 0.0
    cg_maxiter: int = 250
    #: Eisenstat-Walker adaptive CG forcing (opt-in)
    cg_adaptive: bool = False
    #: greedy SCORE damping; None = AUTO (on for ss_type=1 and n >= 4096)
    greedy_alpha: Optional[bool] = None
    #: precision-adaptive CG on a low-precision copy of A — not ported
    #: yet (ROADMAP A10); only the defaults are accepted
    cg_lp_tol: float = 0.0
    auto_lp: Optional[bool] = None
    #: epoch-fused greedy path; None = AUTO (on when its requirements
    #: hold, steps.epoch_cache_enabled)
    epoch_cache: Optional[bool] = None
    kernels: str = "auto"
    name: str = "prox-ggnscore"
    label: str = "Prox-GGN-SCORE"

    def __post_init__(self):
        if self.kernels not in _KERNEL_MODES:
            raise ValueError(
                f"kernels must be one of {_KERNEL_MODES}, got "
                f"{self.kernels!r}")

    def display(self):
        if not self.use_prox:
            return "ggnscore", "GGN-SCORE"
        return self.name, self.label
