"""Matrix-free linear algebra: preconditioned conjugate gradients.

Port of `scso_tpu.ops.linalg.cg_solve`. The JAX version is a
`lax.while_loop` that never leaves the device; here the loop is an eager
Python loop, and its residual test reads one scalar back to the host on
every iteration (one synchronisation per CG iteration). Everything else
stays on the device: the step scalars are 0-d tensors. The inverse
Barzilai–Borwein step and the Armijo line search (step-size modes 2 and
3) are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    res_norm_sq: torch.Tensor


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor = None,
    *,
    tol=1e-10,
    maxiter: int = 100,
    M_inv: Callable = None,
) -> CGResult:
    """Solve A x = b with (preconditioned) conjugate gradients.

    Args:
      matvec: closure v -> A @ v (A SPD).
      b: right-hand side.
      x0: initial guess (zeros if None).
      tol: relative residual tolerance ‖r‖ ≤ tol·‖b‖ (float or 0-d tensor).
      maxiter: iteration cap.
      M_inv: optional preconditioner closure v -> M⁻¹ v.
    """
    if M_inv is None:
        M_inv = lambda v: v

    atol_sq = (tol * tol) * torch.dot(b, b)
    if x0 is None:
        # zero initial guess: r0 = b, no matvec spent
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = M_inv(r)
    p = z
    rz = torch.dot(r, z)

    k = 0
    # one host read per iteration: the residual test
    while k < maxiter and bool(torch.dot(r, r) > atol_sq):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        dz = denom == 0
        alpha = torch.where(dz, torch.zeros_like(rz),
                            rz / torch.where(dz, torch.ones_like(denom),
                                             denom))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = torch.dot(r, z)
        rz0 = rz == 0
        beta = torch.where(rz0, torch.zeros_like(rz),
                           rz_new / torch.where(rz0, torch.ones_like(rz),
                                                rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x=x, iters=k, res_norm_sq=torch.dot(r, r))
