"""Method configuration objects (frozen, hashable).

Port of `scso_tpu.algorithms.methods.ProxGGNSCORE` and `ProxLQNSCORE`
(the default method of `iterate`). Field meanings and
defaults are the JAX package's; see its docstrings for the measurements
behind them. ``kernels`` differs:
  * 'auto'  — resolved by `iterate` to 'cuda' for problems whose data
    lies on a CUDA device and to 'torch' otherwise;
  * 'cuda'  — the hand-written CUDA kernels (ops/cuda/) at every shape;
    a tensor or GLM spec they do not take raises;
  * 'torch' — the plain PyTorch versions on any device.
ProxNSCORE is not ported yet (ROADMAP A7, with K2's newton flavour B2).
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
    #: the static Jacobi preconditioner and subsampled curvature — not
    #: ported yet (ROADMAP A7); only the defaults are accepted
    static_precond: bool = False
    curvature_rows: int = 0
    #: epoch-fused greedy path; None = AUTO (on when its requirements
    #: hold, steps.epoch_cache_enabled)
    epoch_cache: Optional[bool] = None
    #: single-candidate prep kernel K2s on the uncached GLM path: z, RHS
    #: pullback and Jacobi diagonal without the (m,)-sized plain
    #: intermediates. None = AUTO: on whenever kernels='cuda' (the JAX
    #: package's n >= 8192 gate was measured on a TPU v5e and is not
    #: carried over); False takes z = A·x and the plain weights.
    use_fused_prep: Optional[bool] = None
    #: row-sharded problems: > 1 splits the CG matvec's second
    #: contraction into that many column chunks whose all_reduces
    #: overlap the next chunk's product (ops/cuda/matvec.py, K1s); 1 =
    #: K1 on the shard plus one all_reduce. Kept for parity with the JAX
    #: package: the overlapped form bypasses the hand-written K1 (both
    #: contractions are matrix products) and on four NVLink-joined H100s
    #: it was measured slower than 1 (PERF.md, chip_sharded.py)
    comm_overlap_chunks: int = 1
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


@dataclasses.dataclass(frozen=True)
class ProxLQNSCORE:
    """Proximal L-BFGS with self-concordant regularization; ``m`` is the
    L-BFGS memory (the reference's default 10). The two-loop recursion
    runs as the K4 kernel under kernels='cuda' (m ≤ 64 there)."""

    ss_type: int = 1
    use_prox: bool = True
    m: int = 10
    #: greedy SCORE damping — the L-BFGS direction is not Newton-quality,
    #: so it stays OFF by default (each rejected trial costs data passes)
    greedy_alpha: bool = False
    kernels: str = "auto"
    name: str = "prox-lbfgsscore"
    label: str = "Prox-LBFGS-SCORE"

    def __post_init__(self):
        if self.kernels not in _KERNEL_MODES:
            raise ValueError(
                f"kernels must be one of {_KERNEL_MODES}, got "
                f"{self.kernels!r}")

    def display(self):
        if not self.use_prox:
            return "lbfgsscore", "LBFGS-SCORE"
        return self.name, self.label
