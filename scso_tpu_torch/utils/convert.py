"""Carry arrays from the JAX package (given as numpy) into the port.

With these a test hands the port the exact (padded) problem and the
primed epoch cache that `scso_tpu` built, and compares one step.
"""

from __future__ import annotations

import numpy as np
import torch

from scso_tpu_torch.algorithms.steps import GLMCache
from scso_tpu_torch.models import losses
from scso_tpu_torch.problems import Problem

_GLMS = {"logistic01": (losses.LOGISTIC01_GLM, losses.logistic01_f)}


def problem_from_numpy(A, y, x0, lam, *, x_star=None, L=None, n_true=None,
                       glm="logistic01", dtype=torch.float64,
                       device="cpu") -> Problem:
    """A :class:`Problem` over arrays that are already as the JAX
    Problem holds them (padded, when ``n_true`` is given — no padding is
    applied here)."""
    if glm not in _GLMS:
        raise ValueError(f"unknown GLM {glm!r}; known: {sorted(_GLMS)}")
    spec, f = _GLMS[glm]
    device = torch.device(device)
    to = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)
    x0 = to(x0)
    return Problem(
        x0=x0, lam=to(lam), A=to(A), y=to(y),
        x_star=to(x_star) if x_star is not None else torch.zeros_like(x0),
        f=f, dtype=dtype, device=device,
        L=None if L is None else to(L), glm=spec, n_true=n_true)


def glm_cache_from_numpy(w, b_raw, hd_raw, loss, *, dtype=torch.float64,
                         device="cpu") -> GLMCache:
    """A :class:`GLMCache` from the JAX package's GLMCache fields."""
    to = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)
    return GLMCache(w=to(w), b_raw=to(b_raw), hd_raw=to(hd_raw),
                    loss=to(loss).reshape(()))

