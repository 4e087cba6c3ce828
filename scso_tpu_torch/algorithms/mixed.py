"""Mixed precision: the low-precision copy of A for precision-adaptive CG.

Port of `scso_tpu.algorithms.mixed`. At the bench shapes the CG
curvature matvec (K1) is bound by the bytes of A, so a bfloat16 copy of
A halves the bytes of every CG iteration; bf16's ~3 significant digits
bound the matvec's relative error near 1e-3, which is below the CG
forcing tolerance of the bulk epochs. `with_lp_copy` attaches the copy
(`Problem.A_lp`), and `ProxGGNSCORE(cg_lp_tol=...)` or AUTO
(`auto_lp`, `iterate._auto_lp`) decides which epochs use it. The
two-phase `iterate_mixed` (a coarse solve with A itself in bf16, then a
full-precision finish) is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.problems import Problem


def with_lp_copy(model: Problem, dtype=torch.bfloat16) -> Problem:
    """Attach a low-precision copy of the data matrix for
    precision-adaptive CG.

    Pair with ``ProxGGNSCORE(cg_lp_tol=...)``: epochs whose CG forcing
    tolerance is >= ``cg_lp_tol`` run their curvature matvecs on the
    ``dtype`` copy (bf16: half the bytes of A per CG iteration); tighter
    epochs use the full-precision A. Two regimes, as in the JAX package:
      * default float32 (tightening-only endgame forcing): ``cg_lp_tol``
        EQUAL to the CG floor (AUTO 3e-4) — bf16 through the bulk phase,
        float32 once the endgame tightens past it;
      * ``cg_adaptive=True`` (Eisenstat–Walker): a loose threshold such
        as 1e-2 — bf16 only while the forcing is loose.
    The copy costs half of A's memory on A's device. A ``dtype`` equal
    to A's keeps A itself (the same tensor: nothing is copied)."""
    if model.A is None or model.y is None:
        raise ValueError("with_lp_copy requires a data problem (A, y)")
    return dc_replace(model, A_lp=model.A.to(dtype))


def iterate_mixed(method, model: Problem, reg_name: str, h_mu, *,
                  coarse_f_tol: float = 1e-3, coarse_max_epoch: int = 50,
                  coarse_dtype=torch.bfloat16, **kwargs):
    """Two-phase mixed-precision `iterate` (a coarse solve with A in
    ``coarse_dtype``, then the full-precision finish): not ported yet.
    Its coarse phase needs K2, K2s and K5 with a bfloat16 A."""
    raise NotImplementedError(
        "iterate_mixed (the two-phase bf16 coarse solve) is not ported "
        "yet (ROADMAP A10)")
