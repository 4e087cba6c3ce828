"""Scaled (variable-metric) proximal operators.

Port of `scso_tpu.ops.prox`. ``h_scale`` is the INVERSE of the smoother
Hessian diagonal, so the effective threshold is
``t = alpha * lam / h_scale = alpha * lam * Hr_diag``; the group-lasso
operator reduces over groups (`ops.groups`).
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.groups import Groups, prox_l2_scaled


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


def prox_group_lasso(x, h_scale, lam, alpha, groups: Groups):
    """Sparse-group-lasso prox: an elementwise soft threshold, then the
    group scaling. ``lam`` is [λ₁, λ₂]:
      u = SoftThreshold(x, λ₁/h)   (no α factor, as in the reference)
      u = ProxL2(u, α·λ₂, h)       (groupwise max(1 − β/(h‖u_g‖), 0))"""
    lam = torch.atleast_1d(torch.as_tensor(lam))
    t = lam[0] / h_scale
    u = torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)
    return prox_l2_scaled(groups, u, alpha * lam[1], h_scale)


def prox_step(reg_name: str, x, h_scale, lam, alpha, *, lb=None, ub=None,
              groups: Groups = None):
    """Dispatch on reg_name: 'l1', 'l2', 'indbox' or 'gl'."""
    if reg_name == "l1":
        return prox_l1(x, h_scale, lam, alpha)
    if reg_name == "l2":
        return prox_l2(x, h_scale, lam, alpha)
    if reg_name == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox prox requires lb/ub (C_set)")
        return prox_indbox(x, lb, ub)
    if reg_name == "gl":
        if groups is None:
            raise ValueError("gl prox requires group structure")
        return prox_group_lasso(x, h_scale, lam, alpha, groups)
    raise ValueError(f"reg_name {reg_name!r} not valid.")
