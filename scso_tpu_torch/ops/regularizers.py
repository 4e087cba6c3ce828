"""True (nonsmooth) regularizer values g(x).

Port of `scso_tpu.ops.regularizers`: 'l1', 'l2', 'indbox' and 'gl'.
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.groups import Groups, lasso_fz


def indbox_f(x, lb, ub):
    """Box indicator: +inf if any coordinate violates [lb, ub], else 0."""
    violated = torch.any(x < lb) | torch.any(x > ub)
    return torch.where(violated, x.new_full((), float("inf")),
                       x.new_zeros(()))


def reg_value(reg_name: str, x, *, lam, lb=None, ub=None,
              groups: Groups = None):
    """g(x): lam·Σ|x| (l1), lam·Σx² (l2), the [lb, ub] indicator, or
    λ₂·Σ_g w_g‖x_g‖ + λ₁·Σ|x| (gl, lam = [λ₁, λ₂])."""
    if reg_name == "l1":
        return lam * torch.sum(torch.abs(x))
    if reg_name == "l2":
        return lam * torch.sum(x * x)
    if reg_name == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox regularizer requires lb/ub (C_set)")
        return indbox_f(x, lb, ub)
    if reg_name == "gl":
        lam = torch.atleast_1d(torch.as_tensor(lam))
        if lam.shape[0] != 2:
            raise ValueError(
                "Please provide exactly two entries for lam, e.g. "
                "[lam1, lam2]")
        if groups is None:
            raise ValueError("gl regularizer requires group structure")
        return lam[1] * lasso_fz(groups, x) + lam[0] * torch.sum(torch.abs(x))
    raise ValueError(f"reg_name {reg_name!r} not valid.")
