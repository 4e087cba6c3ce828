"""Method configuration objects (frozen, hashable).

Port of `scso_tpu.algorithms.methods`: `ProxNSCORE`, `ProxGGNSCORE` and
`ProxLQNSCORE` (the default method of `iterate`). Field meanings and
defaults are the JAX package's; see its docstrings for the measurements
behind them. ``kernels`` differs:
  * 'auto'  — resolved by `iterate` to 'cuda' for problems whose data
    lies on a CUDA device and to 'torch' otherwise;
  * 'cuda'  — the hand-written CUDA kernels (ops/cuda/) at every shape,
    for any GLM or MOGLM spec; a tensor they do not take raises;
  * 'torch' — the plain PyTorch versions on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_KERNEL_MODES = ("auto", "cuda", "torch")


def _check_kernels(method):
    if method.kernels not in _KERNEL_MODES:
        raise ValueError(
            f"kernels must be one of {_KERNEL_MODES}, got "
            f"{method.kernels!r}")


@dataclasses.dataclass(frozen=True)
class ProxNSCORE:
    """Proximal Newton with self-concordant regularization.

    ``solver``: 'dense' is the reference's direct solve
    (H + λ·diag(Hr)) \\ ∇q; 'cg' is matrix-free Newton-CG (K1 for the
    Hessian weights of a GLM, K5 on a multi-output GLM, else
    forward-over-reverse HVPs); 'auto' is dense up to n = 2048 and CG
    above (steps._resolve_newton_solver). On the epoch cache K2 runs in
    its newton flavour (gres and hvp_w, the true Hessian weights)."""

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
    #: row-sharded CG matvec schedule; kept for parity: a sharded Newton
    #: solve is not ported yet (ROADMAP A11)
    comm_overlap_chunks: int = 1
    #: the static Jacobi preconditioner — not ported yet (ROADMAP A7)
    static_precond: bool = False
    #: epoch-fused greedy path; None = AUTO (steps.epoch_cache_enabled)
    epoch_cache: Optional[bool] = None
    kernels: str = "auto"
    name: str = "prox-newtonscore"
    label: str = "Prox-N-SCORE"

    def __post_init__(self):
        _check_kernels(self)

    def display(self):
        if not self.use_prox:
            return "newtonscore", "Newton-SCORE"
        return self.name, self.label


@dataclasses.dataclass(frozen=True)
class ProxGGNSCORE:
    """Proximal generalized Gauss-Newton with self-concordant
    regularization. ``solver``: 'cg' (matrix-free GGN-CG on a GLM or
    multi-output spec), 'dense_dual' / 'dense_primal' (the reference's
    dense systems over the materialized Jacobian), or 'auto': the
    reference's dense branch up to m·n = 2²⁴ elements of J, CG above
    (steps._resolve_ggn_solver)."""

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
    #: precision-adaptive CG (GLM and multi-output specs): epochs whose
    #: CG forcing tolerance is >= cg_lp_tol run their curvature matvecs
    #: on the problem's low-precision copy of A (Problem.A_lp,
    #: mixed.with_lp_copy: K1 or K5 with A in bfloat16), the others on
    #: A. 0.0 disables. At most the CG floor it is refused with a
    #: warning (steps._lp_tol_refused), except equal to it under the
    #: float32 tightening-only forcing. Multi-output problems: only the
    #: cached path reads the copy (steps._mo_lp_matvec); the uncached
    #: one ignores it, as the JAX package does
    cg_lp_tol: float = 0.0
    #: AUTO precision-adaptive CG (iterate._auto_lp): None attaches the
    #: bf16 copy and sets cg_lp_tol to the CG floor for a float32 GLM
    #: problem whose A lies on a CUDA device and is at least
    #: _AUTO_LP_MIN_BYTES (measured on the H100, PERF.md; a multi-output
    #: one never: _AUTO_LP_MIN_BYTES_MGLM is None, as the copy did not
    #: win clearly there) and fits
    #: twice over; True skips the device, size and memory gates; False
    #: disables. An explicit cg_lp_tol > 0 always wins over AUTO
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
        _check_kernels(self)

    def display(self):
        if not self.use_prox:
            return "ggnscore", "GGN-SCORE"
        return self.name, self.label


@dataclasses.dataclass(frozen=True)
class ProxLQNSCORE:
    """Proximal L-BFGS with self-concordant regularization; ``m`` is the
    L-BFGS memory (the reference's default 10). The two-loop recursion
    runs as the K4 kernel on the card, for any m."""

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
        _check_kernels(self)

    def display(self):
        if not self.use_prox:
            return "lbfgsscore", "LBFGS-SCORE"
        return self.name, self.label


#: the reference's abstract method type: any of the three
ProximalMethod = (ProxNSCORE, ProxGGNSCORE, ProxLQNSCORE)
