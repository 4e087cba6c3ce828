"""L-BFGS memory and two-loop recursion with fixed-shape circular buffers.

Port of `scso_tpu.ops.lbfgs_core`. The (s, y) pairs live in fixed (m, n)
buffers addressed by a circular write position. ``pos`` and ``count``
are 0-d int32 tensors on the data's device, not Python ints, so neither
the accept test of :func:`update_memory` nor the two-loop recursion
reads anything back to the host. :func:`two_loop` is the plain version
of the K4 kernel (``ops/cuda/two_loop.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LBFGSMemory(NamedTuple):
    """Circular (s, y) memory.

    S, Y: (m, n) buffers; ``pos`` is the next write slot, ``count`` the
    number of valid pairs (≤ m), ``H0`` the initial inverse-Hessian
    scale — all three 0-d tensors on the buffers' device."""

    S: torch.Tensor
    Y: torch.Tensor
    pos: torch.Tensor
    count: torch.Tensor
    H0: torch.Tensor


def init_memory(n: int, m: int, dtype=torch.float32,
                device="cpu") -> LBFGSMemory:
    """Fresh empty memory."""
    zeros = lambda: torch.zeros((m, n), dtype=dtype, device=device)
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return LBFGSMemory(S=zeros(), Y=zeros(), pos=i32(), count=i32(),
                       H0=torch.ones((), dtype=dtype, device=device))


def _row(M, idx):
    """M[idx] for a 0-d integer tensor idx, without a host read."""
    return M.index_select(0, idx.reshape(1).long())[0]


def two_loop(mem: LBFGSMemory, grad: torch.Tensor) -> torch.Tensor:
    """d = −H·grad via the standard two-loop recursion: the first loop
    newest → oldest accumulating α_i, then r = H0·q, the second loop
    oldest → newest adding s_i(α_i − β_i). Slots k ≥ count are masked to
    no-ops (q and r keep their bits); ρ = 0 where yᵀs = 0. The updates
    q − α·y and r + s·(α − β) are fused multiply-adds (``addcmul``): XLA
    contracts them so in the JAX package's two-loop, and L-BFGS carries
    a one-ulp difference of the direction into the whole run."""
    m = mem.S.shape[0]
    q = grad
    saved = []
    for k in range(m):  # k = 0 is the newest pair
        idx = torch.remainder(mem.pos - 1 - k, m)
        valid = k < mem.count
        s, y = _row(mem.S, idx), _row(mem.Y, idx)
        ys = torch.dot(y, s)
        rho = torch.where(ys != 0, 1.0 / torch.where(ys == 0,
                                                     torch.ones_like(ys), ys),
                          torch.zeros_like(ys))
        alpha = rho * torch.dot(s, q)
        q = torch.where(valid, torch.addcmul(q, alpha, y, value=-1), q)
        saved.append((alpha, rho, s, y, valid))
    r = mem.H0 * q
    for alpha, rho, s, y, valid in reversed(saved):
        beta = rho * torch.dot(y, r)
        r = torch.where(valid, torch.addcmul(r, s, alpha - beta), r)
    return -r


def update_memory(mem: LBFGSMemory, delta, gamma, *,
                  curvature_tol: float = 1e-10) -> LBFGSMemory:
    """Curvature-guarded FIFO update: accept the pair iff δ·γ >
    curvature_tol, evicting the oldest at capacity, and refresh
    H0 = (γ·δ)/(γ·γ). Out of place, as in the JAX package: the old
    memory stays valid."""
    m = mem.S.shape[0]
    dg = torch.dot(delta, gamma)
    accept = dg > curvature_tol
    at = mem.pos.reshape(1).long()
    S = mem.S.index_copy(0, at, torch.where(accept, delta,
                                            _row(mem.S, mem.pos))[None])
    Y = mem.Y.index_copy(0, at, torch.where(accept, gamma,
                                            _row(mem.Y, mem.pos))[None])
    pos = torch.where(accept, torch.remainder(mem.pos + 1, m), mem.pos)
    count = torch.where(accept, torch.clamp_max(mem.count + 1, m), mem.count)
    gg = torch.dot(gamma, gamma)
    H0_new = dg / torch.where(gg == 0, torch.ones_like(gg), gg)
    H0 = torch.where(accept & (gg > 0), H0_new, mem.H0)
    return LBFGSMemory(S=S, Y=Y, pos=pos, count=count, H0=H0)
