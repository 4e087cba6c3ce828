"""Self-concordant smoothing functions h_mu — the main-path slice.

Port of `scso_tpu.ops.smoothers`: the step-damping constant `get_Mg`,
the pseudo-Huber l1/l2 smoother and its elementwise value, gradient and
Hessian diagonal. ``cw`` (the group-structure weight vector) is accepted
and ignored, exactly as in the JAX package. The box-indicator,
Ostrovskii–Bach, exponential, log-exp and group-lasso smoothers are not
ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch

from scso_tpu_torch._src.struct import frozen_dataclass


def get_Mg(Mh, nu, mu, n: int):
    """Generalized self-concordance step-damping constant.

    M_g = n^((3-nu)/2) * mu^(nu/2 - 2) * Mh     for 0 < nu <= 3
    M_g = mu^(4 - 3*nu/2) * Mh                  for nu > 3
    """
    if isinstance(Mh, (int, float)) and Mh < 0:
        raise ValueError("Mh must be nonnegative.")
    if isinstance(mu, (int, float)) and mu <= 0:
        raise ValueError("mu must be positive.")
    if not 0 < nu:
        raise ValueError("nu must be positive.")
    if nu <= 3:
        return n ** ((3.0 - nu) / 2.0) * mu ** (nu / 2.0 - 2.0) * Mh
    return mu ** (4.0 - 3.0 * nu / 2.0) * Mh


class SmootherBase:
    """Common helpers; subclasses define val/grad/hess_diag."""

    Mh: float = 0.0
    nu: float = 2.0

    def val(self, x, cw=None):
        raise NotImplementedError

    def grad(self, x, cw=None):
        raise NotImplementedError

    def hess_diag(self, x, cw=None):
        raise NotImplementedError

    def Mg(self, n: int):
        return get_Mg(self.Mh, self.nu, self.mu, n)


_PHUBER_MH = 2.0
_PHUBER_NU = 2.6


def phuber_val(x, mu):
    """sqrt(mu^2 + x^2) - mu."""
    return torch.sqrt(mu * mu + x * x) - mu


def phuber_grad(x, mu):
    """x / sqrt(mu^2 + x^2)."""
    return x * torch.rsqrt(mu * mu + x * x)


def phuber_hess(x, mu):
    """mu^2 * (mu^2 + x^2)^(-3/2)."""
    s2 = mu * mu + x * x
    return mu * mu * torch.rsqrt(s2) / s2


@frozen_dataclass
class PHuberSmootherL1L2(SmootherBase):
    """Pseudo-Huber smoothing of the l1/l2 regularizer.

    ``mu`` is a Python float (the JAX package traces it as a leaf for
    vmapped sweeps; sweeps are not ported yet, ROADMAP A11)."""

    mu: float
    Mh: float = _PHUBER_MH
    nu: float = _PHUBER_NU

    def val(self, x, cw=None):
        return phuber_val(x, self.mu)

    def grad(self, x, cw=None):
        return phuber_grad(x, self.mu)

    def hess_diag(self, x, cw=None):
        return phuber_hess(x, self.mu)
