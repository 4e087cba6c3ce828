"""Mixed precision: a bfloat16 A for the bandwidth-bound passes.

Port of `scso_tpu.algorithms.mixed`. At the bench shapes the CG
curvature matvec (K1, K5) and the epoch prep (K2, K2s) are bound by the
bytes of A, so A in bfloat16 halves them; bf16's ~3 significant digits
bound a product's relative error near 1e-3. Two schemes:
  * `with_lp_copy` attaches a copy (`Problem.A_lp`), and
    `ProxGGNSCORE(cg_lp_tol=...)` or AUTO (`auto_lp`,
    `iterate._auto_lp`) decides which epochs' CG matvecs use it; the
    RHS, the prep and the stats keep A;
  * `iterate_mixed` solves twice: a coarse solve with A itself cast to
    bfloat16 (every pass over A, the kernels' and `ops.dense`'s, at half
    the bytes) to a loose gap, then a full-precision finish from its
    iterate.
"""

from __future__ import annotations

import weakref

import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.problems import Problem

# `iterate` imports this module (for with_lp_copy): iterate_mixed
# imports it when it runs


#: the last cast of `cast_once`: {(id(A), dtype): (weak A, cast)}
_CAST: dict = {}


def cast_once(A: torch.Tensor, dtype) -> torch.Tensor:
    """``A.to(dtype)``, made once for the last A asked for and kept while
    that A lives: the solves of a chain on one A (AUTO's bfloat16 copy,
    `iterate_mixed`'s coarse A) then share one cast, and so the CUDA
    graph captured on it. One cast at a time is kept."""
    key = (id(A), dtype)
    hit = _CAST.get(key)
    if hit is not None and hit[0]() is A:
        return hit[1]
    _CAST.clear()
    out = A.to(dtype)
    _CAST[key] = (weakref.ref(A), out)
    weakref.finalize(A, lambda: _CAST.pop(key, None))
    return out


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
    """Two-phase mixed-precision `iterate`.

    Accepts every `iterate` kwarg for the fine phase (``mode`` included:
    both phases run in it); the coarse phase
    runs with the data matrix cast to ``coarse_dtype`` (x, y and every
    other tensor keep their dtype; an attached ``A_lp`` stays) and stops
    at ``coarse_f_tol`` relative objective gap or after
    ``coarse_max_epoch`` epochs. The fine phase starts from the coarse
    iterate in x0's dtype — the padded one, ``state.x``, so that a
    problem built with ``pad_features`` fits its padded A. The returned
    Solution is the fine phase's (its histories and ``times`` cover the
    fine phase); ``cg_info`` gains ``coarse_epochs`` and
    ``coarse_time_s`` beside the fine solve's own entries. A problem
    without data runs the plain `iterate`. On a row-sharded problem both
    phases run the sharded cached path (each rank casts its rows)."""
    from scso_tpu_torch.algorithms.iterate import iterate

    if model.A is None or model.y is None:
        # nothing bandwidth-bound to downcast: a plain solve
        return iterate(method, model, reg_name, h_mu, **kwargs)

    coarse_prob = dc_replace(model, A=cast_once(model.A, coarse_dtype))
    coarse_kwargs = dict(kwargs, f_tol=coarse_f_tol,
                         max_epoch=coarse_max_epoch)
    coarse = iterate(method, coarse_prob, reg_name, h_mu, **coarse_kwargs)

    fine_prob = dc_replace(model, x0=coarse.state.x.to(model.x0.dtype))
    fine = iterate(method, fine_prob, reg_name, h_mu, **kwargs)
    # merge, don't overwrite: the fine solve's total_cg_iters survives
    fine.cg_info = {
        **(fine.cg_info or {}),
        "coarse_epochs": coarse.epochs,
        "coarse_time_s": (float(coarse.times[-1]) if len(coarse.times)
                          else 0.0),
    }
    return fine
