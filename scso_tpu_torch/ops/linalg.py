"""Matrix-free linear algebra and the step-size rules.

Port of `scso_tpu.ops.linalg`: preconditioned conjugate gradients, the
inverse Barzilai–Borwein step and the Armijo line search. The JAX CG and
Armijo loops are `lax.while_loop`s that never leave the device; here
each is a `graph.device_loop`: its state lives in tensors updated in
place, its iteration count is a 0-d int32 tensor and its test a 0-d bool
tensor on the data's device, so that inside a captured CUDA graph the
loop is one WHILE conditional node and reads nothing back to the host.
On the CPU the same loop runs as a plain ``while``. Under
``torch.func.vmap`` (the batched solve) each loop runs while any
instance's test holds, each instance's state frozen once its own test
fails (`graph.device_loop`'s ``state``): the loops' counters are made
``*_like`` a batched tensor, so that they carry one value an instance.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from scso_tpu_torch.ops.cuda.graph import device_loop

class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor      # 0-d int32, on b's device
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
      maxiter: iteration cap (the loop's test includes it).
      M_inv: optional preconditioner closure v -> M⁻¹ v.
    """
    if M_inv is None:
        M_inv = lambda v: v

    atol_sq = (tol * tol) * torch.dot(b, b)
    if x0 is None:
        # zero initial guess: r0 = b, no matvec spent
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - matvec(x0)
    p = M_inv(r).clone()
    rz = torch.dot(r, p)
    k = torch.zeros_like(rz, dtype=torch.int32)
    live = (torch.dot(r, r) > atol_sq) & (maxiter > 0)

    def iteration():
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        dz = denom == 0
        alpha = torch.where(dz, torch.zeros_like(rz),
                            rz / torch.where(dz, torch.ones_like(denom),
                                             denom))
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Ap)
        z = M_inv(r)
        rz_new = torch.dot(r, z)
        rz0 = rz == 0
        beta = torch.where(rz0, torch.zeros_like(rz),
                           rz_new / torch.where(rz0, torch.ones_like(rz),
                                                rz))
        p.copy_(z + beta * p)
        rz.copy_(rz_new)
        k.add_(1)
        live.copy_((k < maxiter) & (torch.dot(r, r) > atol_sq))

    device_loop(live, maxiter, iteration, state=(x, r, p, rz, k))
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
    max_backtracks) with f(x + α·d) ≤ f(x) + c·α·∇f(x)·d, capped at 60
    halvings as in the JAX package. Returns α, a 0-d tensor; each trial
    is one iteration of a `graph.device_loop`."""
    fx = f(x)
    slope = torch.dot(grad_f(x), d)
    alpha = torch.ones_like(slope)
    k = torch.zeros_like(slope, dtype=torch.int32)
    worse = lambda: f(x + alpha * d) > fx + c * alpha * slope
    live = worse() & (max_backtracks > 0)

    def backtrack():
        alpha.copy_(rho * alpha)
        k.add_(1)
        live.copy_((k < max_backtracks) & worse())

    device_loop(live, max_backtracks, backtrack, state=(alpha, k))
    return alpha
