"""Scaled (variable-metric) proximal operators.

Port of `scso_tpu.ops.prox`. ``h_scale`` is the INVERSE of the smoother
Hessian diagonal, so the effective threshold is
``t = alpha * lam / h_scale = alpha * lam * Hr_diag``. The group-lasso
prox is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch


def prox_l1(x, h_scale, lam, alpha):
    """Scaled soft-thresholding: sign(x)·max(|x| − t, 0), t = α·λ/h."""
    t = alpha * lam / h_scale
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def prox_l2(x, h_scale, lam, alpha):
    """Scaled l2 shrinkage: x·max(1 − t/x², 0), t = α·λ/h (the
    reference's 1 − t/x² form, kept as the JAX package keeps it)."""
    t = alpha * lam / h_scale
    x2 = x * x
    zero = x2 == 0
    safe = torch.where(zero, torch.ones_like(x2), x2)
    scale = torch.where(zero, torch.zeros_like(x2),
                        torch.clamp_min(1.0 - t / safe, 0.0))
    return x * scale


def prox_indbox(x, lb, ub):
    """Clamp to the box [lb, ub] (metric-independent)."""
    return torch.minimum(torch.maximum(x, lb), ub)


def prox_step(reg_name: str, x, h_scale, lam, alpha, *, lb=None, ub=None):
    """Dispatch on reg_name: 'l1', 'l2' or 'indbox'."""
    if reg_name == "l1":
        return prox_l1(x, h_scale, lam, alpha)
    if reg_name == "l2":
        return prox_l2(x, h_scale, lam, alpha)
    if reg_name == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox prox requires lb/ub (C_set)")
        return prox_indbox(x, lb, ub)
    if reg_name == "gl":
        raise NotImplementedError(
            "the group-lasso prox is not ported yet (ROADMAP A8)")
    raise ValueError(f"reg_name {reg_name!r} not valid.")
