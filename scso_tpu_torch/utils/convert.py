"""Carry arrays from the JAX package (given as numpy) into the port.

With these a test hands the port the exact (padded) problem, the primed
epoch cache (GLMCache or MOGLMCache) or the L-BFGS memory that
`scso_tpu` built, and compares one step. Like `make_problem`, each
converter puts its tensors on the card unless given a ``device``, and
raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

from scso_tpu_torch.algorithms.steps import GLMCache, MOGLMCache
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory
from scso_tpu_torch.problems import Problem, resolve_device

_GLMS = {"logistic01": (losses.LOGISTIC01_GLM, losses.logistic01_f,
                        losses.logistic01_grad),
         "multinomial": (None, losses.multinom_f, losses.multinom_grad)}


def _to(dtype, device):
    device = resolve_device(device)
    return lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)


def problem_from_numpy(A, y, x0, lam, *, x_star=None, L=None, n_true=None,
                       glm="logistic01", n_out=None, grad_fx=False,
                       dtype=torch.float64, device=None) -> Problem:
    """A :class:`Problem` over arrays that are already as the JAX
    Problem holds them (padded, when ``n_true`` is given — no padding is
    applied here). ``glm='multinomial'`` builds the multi-output problem
    with ``mglm=multinom_mglm(n_out)``. ``grad_fx=True`` passes the
    family's closed-form gradient (else ∇f is autograd through f)."""
    if glm not in _GLMS:
        raise ValueError(f"unknown GLM {glm!r}; known: {sorted(_GLMS)}")
    spec, f, grad = _GLMS[glm]
    mglm = None
    if glm == "multinomial":
        if n_out is None:
            raise ValueError("glm='multinomial' needs n_out (classes)")
        mglm = losses.multinom_mglm(n_out)
    to = _to(dtype, device)
    x0 = to(x0)
    return Problem(
        x0=x0, lam=to(lam), A=to(A), y=to(y),
        x_star=to(x_star) if x_star is not None else torch.zeros_like(x0),
        f=f, dtype=dtype, device=x0.device,
        L=None if L is None else to(L), glm=spec, mglm=mglm,
        grad_fx=grad if grad_fx else None, n_true=n_true)


def glm_cache_from_numpy(w, b_raw, hd_raw, loss, *, dtype=torch.float64,
                         device=None) -> GLMCache:
    """A :class:`GLMCache` from the JAX package's GLMCache fields."""
    to = _to(dtype, device)
    return GLMCache(w=to(w), b_raw=to(b_raw), hd_raw=to(hd_raw),
                    loss=to(loss).reshape(()))


def moglm_cache_from_numpy(Z, grad_vec, hd_raw, loss, *,
                           dtype=torch.float64,
                           device=None) -> MOGLMCache:
    """A :class:`MOGLMCache` from the JAX package's MOGLMCache fields."""
    to = _to(dtype, device)
    return MOGLMCache(Z=to(Z), grad_vec=to(grad_vec), hd_raw=to(hd_raw),
                      loss=to(loss).reshape(()))


def lbfgs_memory_from_numpy(S, Y, pos, count, H0, *, dtype=torch.float64,
                            device=None) -> LBFGSMemory:
    """An :class:`LBFGSMemory` from the JAX package's LBFGSMemory fields
    (pos and count as 0-d int32 tensors)."""
    dev = resolve_device(device)
    to = _to(dtype, dev)
    i32 = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                                 device=dev)
    return LBFGSMemory(S=to(S), Y=to(Y), pos=i32(pos), count=i32(count),
                       H0=to(H0).reshape(()))
