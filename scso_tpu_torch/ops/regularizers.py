"""True (nonsmooth) regularizer values g(x).

Port of `scso_tpu.ops.regularizers` for 'l1', 'l2' and 'indbox'; the
group-lasso value is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch


def indbox_f(x, lb, ub):
    """Box indicator: +inf if any coordinate violates [lb, ub], else 0."""
    violated = torch.any(x < lb) | torch.any(x > ub)
    return torch.where(violated, x.new_full((), float("inf")),
                       x.new_zeros(()))


def reg_value(reg_name: str, x, *, lam, lb=None, ub=None):
    """g(x): lam·Σ|x| (l1), lam·Σx² (l2), or the [lb, ub] indicator."""
    if reg_name == "l1":
        return lam * torch.sum(torch.abs(x))
    if reg_name == "l2":
        return lam * torch.sum(x * x)
    if reg_name == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox regularizer requires lb/ub (C_set)")
        return indbox_f(x, lb, ub)
    if reg_name == "gl":
        raise NotImplementedError(
            "the group-lasso regularizer is not ported yet (ROADMAP A8)")
    raise ValueError(f"reg_name {reg_name!r} not valid.")
