"""Matrix-free linear algebra and the step-size rules.

Port of `scso_tpu.ops.linalg`: preconditioned conjugate gradients, the
inverse Barzilai–Borwein step and the Armijo line search. The JAX CG is
a `lax.while_loop` that never leaves the device; here the loop is an
eager Python loop, and its residual test reads one scalar back to the
host on every iteration (one synchronisation per CG iteration). The
Armijo loop likewise reads its sufficient-decrease test once per trial.
Everything else stays on the device: the step scalars are 0-d tensors.
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


def inv_bb_step(x, x_prev, grad_x, grad_x_prev):
    """Inverse Barzilai–Borwein step L_est = (γ·γ)/(δ·γ), δ = x − x_prev,
    γ = ∇(x) − ∇(x_prev); δ·γ = 0 divides by 1 instead. The reference
    uses L_est directly as the step size."""
    delta = x - x_prev
    gamma = grad_x - grad_x_prev
    denom = torch.dot(delta, gamma)
    return torch.dot(gamma, gamma) / torch.where(
        denom == 0, torch.ones_like(denom), denom)


def armijo_linesearch(x, d, f: Callable, grad_f: Callable, *, rho=0.5,
                      c=1e-4, max_backtracks: int = 60):
    """Backtracking Armijo line search: the largest α = ρᵏ (k ≤
    max_backtracks) with f(x + α·d) ≤ f(x) + c·α·∇f(x)·d. An eager loop,
    one host read per trial; capped at 60 halvings as in the JAX
    package."""
    fx = f(x)
    slope = torch.dot(grad_f(x), d)
    alpha = torch.ones((), dtype=x.dtype, device=x.device)
    k = 0
    while k < max_backtracks and bool(
            f(x + alpha * d) > fx + c * alpha * slope):
        alpha = rho * alpha
        k += 1
    return alpha
