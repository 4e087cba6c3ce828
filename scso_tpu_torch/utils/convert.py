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
from scso_tpu_torch.ops.groups import make_groups
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory
from scso_tpu_torch.problems import Problem, resolve_device

_GLMS = {"logistic01": (losses.LOGISTIC01_GLM, losses.logistic01_f,
                        losses.logistic01_grad),
         "lsq": (losses.LSQ_GLM, losses.lsq_f, losses.lsq_grad),
         "poisson": (losses.POISSON_GLM, losses.poisson_f,
                     losses.poisson_grad),
         "multinomial": (None, losses.multinom_f, losses.multinom_grad)}


def _to(dtype, device):
    device = resolve_device(device)
    return lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)


def problem_from_numpy(A, y, x0, lam, *, x_star=None, L=None, n_true=None,
                       glm="logistic01", n_out=None, grad_fx=False,
                       A_lp=None, groups=None, dtype=torch.float64,
                       device=None, **hooks) -> Problem:
    """A :class:`Problem` over arrays that are already as the JAX
    Problem holds them (padded, when ``n_true`` is given — no padding is
    applied here). ``glm`` names the family: 'logistic01', 'lsq' or
    'poisson' (their GLM specs), or 'multinomial', the multi-output
    problem with ``mglm=multinom_mglm(n_out)``. ``groups`` is the JAX
    Groups' (segment_ids, weights) as numpy arrays (the pad group
    included, when the JAX problem has one). ``grad_fx=True`` passes the
    family's closed-form gradient (else ∇f is autograd through f).

    ``A_lp`` is the JAX problem's low-precision copy of A, given as
    float32 values (``np.asarray(jax_prob.A_lp, np.float32)``); it
    becomes a bfloat16 tensor with the same bits, so that both packages
    solve with the same copy. A value that bfloat16 cannot hold exactly
    raises: rounding A to bfloat16 on each side separately could round
    differently. ``hooks`` are `Problem`'s derivative hooks (hess_fx,
    out_fn, loss_fn, jac_yx, grad_fy, hess_fy, hess_fy_diag, hvp_w,
    ggn_w), passed through as given."""
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
    if groups is not None:
        seg, wts = (np.asarray(g) for g in groups)
        groups = make_groups(seg, wts, n_groups=wts.shape[0], dtype=dtype,
                             device=x0.device)
    return Problem(
        x0=x0, lam=to(lam), A=to(A), y=to(y),
        x_star=to(x_star) if x_star is not None else torch.zeros_like(x0),
        f=f, dtype=dtype, device=x0.device,
        L=None if L is None else to(L), groups=groups, glm=spec, mglm=mglm,
        grad_fx=grad if grad_fx else None, n_true=n_true,
        A_lp=None if A_lp is None else _bf16_exact(A_lp, x0.device),
        **hooks)


def _bf16_exact(a, device):
    """float32 values that bfloat16 holds exactly → a bfloat16 tensor
    with the same values; raises for any other value."""
    src = torch.tensor(np.asarray(a, np.float32), device=device)
    out = src.to(torch.bfloat16)
    if not torch.equal(out.to(torch.float32), src):
        raise ValueError("A_lp: values that bfloat16 cannot hold exactly; "
                         "pass the JAX problem's bfloat16 copy as float32")
    return out


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
