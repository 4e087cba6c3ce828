"""Self-concordant smoothing functions h_mu (the SCORE smoother families).

Port of `scso_tpu.ops.smoothers`: the step-damping constant `get_Mg`,
`sanitize_bounds`, and every smoother with its elementwise value,
gradient and Hessian diagonal — `NoSmooth`, the pseudo-Huber and
Ostrovskii–Bach l1/l2 smoothers, the pseudo-Huber, exponential and
log-exp box-indicator smoothers, and the group-lasso smoothers with
the reference's chain rule and inf-convolution values. ``cw`` is the
diagonal of the reference's group matrix ``Cmat`` (an elementwise
weight vector, `ops.groups`); the smoothers that are not group-lasso
ones ignore it, as in the JAX package, whose documented divergences
from the reference (module docstring there) are kept.

``mu`` is a Python float (the JAX package traces it as a leaf for
vmapped sweeps; sweeps are not ported yet, ROADMAP A11). Box bounds are
float64 tensors, taken to x's device and dtype where they are used.
"""

from __future__ import annotations

import abc
import math
from typing import Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import frozen_dataclass
from scso_tpu_torch.ops.groups import Groups, group_norms, spread


def _eps(dtype) -> float:
    """Machine epsilon of the compute dtype (Julia `eps()` analogue)."""
    return float(torch.finfo(dtype).eps)


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


L_INF_CACHE = -1e32
U_INF_CACHE = 1e32


def sanitize_bounds(lb, ub, n: Optional[int] = None):
    """Broadcast box bounds and cache infinities to ±1e32 (the
    reference's bounds_sanity_check). Returns float64 numpy arrays."""
    a = np.atleast_1d(np.asarray(lb, dtype=np.float64))
    b = np.atleast_1d(np.asarray(ub, dtype=np.float64))
    if n is not None:
        if a.size == 1:
            a = np.full((n,), a[0])
        if b.size == 1:
            b = np.full((n,), b[0])
        if a.size != n or b.size != n:
            raise ValueError(
                "Lengths of the bounds do not match that of the variable.")
    a = np.where(np.isneginf(a), L_INF_CACHE, a)
    b = np.where(np.isposinf(b), U_INF_CACHE, b)
    return a, b


class SmootherBase(abc.ABC):
    """Common helpers; subclasses define val/grad/hess_diag. ``mu`` may
    be a number or a 0-d tensor (a per-solve buffer of a captured solve:
    `iterate_continuation` changes it between stages)."""

    Mh: float = 0.0
    nu: float = 2.0

    @abc.abstractmethod
    def val(self, x, cw=None):
        """g_μ(x), elementwise."""

    @abc.abstractmethod
    def grad(self, x, cw=None):
        """∇g_μ(x)."""

    @abc.abstractmethod
    def hess_diag(self, x, cw=None):
        """diag ∇²g_μ(x)."""

    def Mg(self, n: int):
        return get_Mg(self.Mh, self.nu, self.mu, n)


@frozen_dataclass
class NoSmooth(SmootherBase):
    """Degenerate smoother disabling smoothing: val=0, grad=0, hess=eps
    ((Mh, nu) = (0, 2), so that M_g = 0)."""

    mu: float = 1.0
    Mh: float = 0.0
    nu: float = 2.0

    def val(self, x, cw=None):
        return torch.zeros_like(x)

    def grad(self, x, cw=None):
        return torch.zeros_like(x)

    def hess_diag(self, x, cw=None):
        return torch.full_like(x, _eps(x.dtype))


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


def _where(c, a, b, x):
    """torch.where with Python-number branches made tensors like x (as
    jnp.where promotes them)."""
    full = lambda v: v if isinstance(v, torch.Tensor) else torch.full_like(
        x, v)
    return torch.where(c, full(a), full(b))


def _log(mu):
    """log μ, of a number or a tensor."""
    return torch.log(mu) if isinstance(mu, torch.Tensor) else math.log(mu)


def _bounds(sm, x):
    return sm.lb.to(x), sm.ub.to(x)


@frozen_dataclass
class PHuberSmootherIndBox(SmootherBase):
    """Pseudo-Huber smoothing of the box indicator: pseudo-Huber of the
    distance to the violated bound outside [lb, ub]; an eps plateau
    inside (value/hess) and zero gradient inside."""

    lb: torch.Tensor
    ub: torch.Tensor
    mu: float
    Mh: float = _PHUBER_MH
    nu: float = _PHUBER_NU

    def val(self, x, cw=None):
        a, b = _bounds(self, x)
        below = phuber_val(a - x, self.mu)
        above = phuber_val(x - b, self.mu)
        inside = torch.full_like(x, _eps(x.dtype))
        return torch.where(x < a, below, torch.where(x > b, above, inside))

    def grad(self, x, cw=None):
        a, b = _bounds(self, x)
        below = -phuber_grad(a - x, self.mu)  # d/dx phuber(a-x)
        above = phuber_grad(x - b, self.mu)
        return torch.where(x < a, below,
                           torch.where(x > b, above, torch.zeros_like(x)))

    def hess_diag(self, x, cw=None):
        a, b = _bounds(self, x)
        below = phuber_hess(a - x, self.mu)
        above = phuber_hess(x - b, self.mu)
        inside = torch.full_like(x, _eps(x.dtype))
        return torch.where(x <= a, below,
                           torch.where(x >= b, above, inside))


# ---------------------------------------------------------------------------
# Ostrovskii–Bach family (Mh = 2·sqrt(2), nu = 3)
# ---------------------------------------------------------------------------

_OSBA_MH = 2.0 * math.sqrt(2.0)
_OSBA_NU = 3.0


def osba_val(x, mu, lam=1.0):
    """O&B smoothed |x|, safe at x = 0."""
    xs = torch.where(x == 0, torch.ones_like(x), x)
    s = torch.sqrt(mu * mu + 4.0 * xs * xs)
    v = (s / 2.0 - mu / 2.0
         + mu * torch.log((2.0 * xs - s + mu) / xs) / 2.0
         - math.log(2.0) * mu
         + mu * torch.log((s - mu + 2.0 * xs) / xs) / 2.0)
    return lam * torch.where(x == 0, torch.zeros_like(v), v)


def osba_grad(x, mu, lam=1.0):
    """O&B gradient, safe at x = 0 (an odd function)."""
    xs = torch.where(x == 0, torch.ones_like(x), x)
    s = torch.sqrt(mu * mu + 4.0 * xs * xs)
    num = (-(mu**3) + mu * mu * s - 4.0 * xs * xs * mu
           + 2.0 * xs * xs * s) * (mu * s + mu * mu + 4.0 * xs * xs)
    den = 4.0 * mu * mu * xs**3 + 16.0 * xs**5
    q = num / den
    return lam * torch.where(x == 0, torch.zeros_like(q), q)


def osba_hess(x, mu, lam=1.0):
    """O&B Hessian diagonal mu·(s − mu)/(2x²s); the x → 0 limit is
    1/mu."""
    xs = torch.where(x == 0, torch.ones_like(x), x)
    s = torch.sqrt(mu * mu + 4.0 * xs * xs)
    h = (s - mu) * mu / (xs * xs) / s / 2.0
    return lam * _where(x == 0, 1.0 / mu, h, x)


@frozen_dataclass
class OsBaSmootherL1L2(SmootherBase):
    """Ostrovskii & Bach smoothing of l1/l2."""

    mu: float
    Mh: float = _OSBA_MH
    nu: float = _OSBA_NU

    def val(self, x, cw=None):
        return osba_val(x, self.mu)

    def grad(self, x, cw=None):
        return osba_grad(x, self.mu)

    def hess_diag(self, x, cw=None):
        return osba_hess(x, self.mu)


# ---------------------------------------------------------------------------
# Exponential and log-exp smoothers of the box indicator (Mh = 1, nu = 2)
# ---------------------------------------------------------------------------


@frozen_dataclass
class ExponentialSmootherIndBox(SmootherBase):
    """One-sided exponential smoothing mu·exp((a − x)/mu): only the
    lower bound enters, as in the reference."""

    lb: torch.Tensor
    ub: torch.Tensor
    mu: float
    Mh: float = 1.0
    nu: float = 2.0

    def val(self, x, cw=None):
        a, _ = _bounds(self, x)
        return torch.exp((a - x) / self.mu) * self.mu

    def grad(self, x, cw=None):
        a, _ = _bounds(self, x)
        return -torch.exp((a - x) / self.mu)

    def hess_diag(self, x, cw=None):
        a, _ = _bounds(self, x)
        return torch.exp((a - x) / self.mu) / self.mu


@frozen_dataclass
class LogExpSmootherIndBox(SmootherBase):
    """Two-sided quadratic-near-boundary plus log-barrier-outside
    smoothing (with the JAX package's value and Hessian fixes)."""

    lb: torch.Tensor
    ub: torch.Tensor
    mu: float
    Mh: float = 1.0
    nu: float = 2.0

    def val(self, x, cw=None):
        a, b = _bounds(self, x)
        mu = self.mu
        quad = _where(
            x <= a + mu, (a - x + 3.0 * mu) * (a - x + mu) / (2.0 * mu),
            _where(x >= b - mu,
                   (x - b + 3.0 * mu) * (x - b + mu) / (2.0 * mu), 0.0, x),
            x)
        dist_a = _where(x < a, a - x, 1.0, x)
        dist_b = _where(x > b, x - b, 1.0, x)
        barrier = _where(
            x < a, mu * (_log(mu) - torch.log(dist_a)),
            _where(x > b, mu * (_log(mu) - torch.log(dist_b)), 0.0, x),
            x)
        return quad + barrier

    def grad(self, x, cw=None):
        a, b = _bounds(self, x)
        mu = self.mu
        quad = _where(x <= a + mu, (x - a - 2.0 * mu) / mu,
                      _where(x >= b - mu, (x - b + 2.0 * mu) / mu, 0.0, x),
                      x)
        da = _where(x < a, a - x, 1.0, x)
        db = _where(x > b, b - x, -1.0, x)
        barrier = _where(x < a, mu / da, _where(x > b, -mu / db, 0.0, x),
                         x)
        return quad + barrier

    def hess_diag(self, x, cw=None):
        a, b = _bounds(self, x)
        mu = self.mu
        quad = _where(x <= a + mu, 1.0 / mu,
                      _where(x >= b - mu, 1.0 / mu, 0.0, x), x)
        da = _where(x < a, a - x, 1.0, x)
        db = _where(x > b, b - x, 1.0, x)
        barrier = _where(x < a, mu / (da * da),
                         _where(x > b, mu / (db * db), 0.0, x), x)
        # floored at machine eps: strictly inside both margins the
        # reference returns exactly 0, whose inverse metric NaN-poisons
        # the step damping
        return torch.clamp_min(quad + barrier, _eps(x.dtype))


# ---------------------------------------------------------------------------
# Group-lasso chain-rule smoothers
# ---------------------------------------------------------------------------


def _gl_grad(base_val, base_grad, x, cw):
    """grad of the chain h(Cmat·h(x)): h'(cw∘h(x))∘h'(x)."""
    g1 = base_val(x)
    dg1 = base_grad(x)
    z = g1 if cw is None else cw * g1
    return base_grad(z) * dg1


def _gl_hess(base_val, base_grad, base_hess, x, cw):
    """Hessian diagonal of the chained smoother, with the reference's
    scalar dot(Dg, Dg) factor (huber_l2l1_hess), kept exactly."""
    g1 = base_val(x)
    dg1 = base_grad(x)
    ddg1 = base_hess(x)
    z = g1 if cw is None else cw * g1
    return base_hess(z) * torch.dot(dg1, dg1) + base_grad(z) * ddg1


def _infconv_huber(groups: Groups, x, lam, mu):
    """Elementwise inf-convolution value: per group g with weight w,
    z_k = x_k·max(1 − λw/‖x_g‖, 0), then pseudo_huber(z_k; mu)."""
    nrm = spread(groups, group_norms(groups, x))
    lw = lam * groups.element_weights
    zero = nrm == 0
    safe_nrm = torch.where(zero, torch.ones_like(nrm), nrm)
    shrink = torch.where(zero, torch.zeros_like(nrm),
                         torch.clamp_min(1.0 - lw / safe_nrm, 0.0))
    return phuber_val(x * shrink, mu)


def _infconv_osba(groups: Groups, x, lam, mu):
    """Elementwise O&B inf-convolution osba(x_k; mu, λ·w_g) (no group-norm
    shrinkage, as in the reference)."""
    return osba_val(x, mu, lam=lam * groups.element_weights)


@frozen_dataclass
class PHuberSmootherGL(SmootherBase):
    """Pseudo-Huber smoothing for the sparse group-lasso regularizer.
    Build it with the package's ``PHuberSmootherGL(mu, problem)``, or
    directly with groups and lam1/lam2 (0-d tensors)."""

    mu: float
    lam1: torch.Tensor = 0.0
    lam2: torch.Tensor = 0.0
    groups: Optional[Groups] = None
    Mh: float = _PHUBER_MH
    nu: float = _PHUBER_NU

    def val(self, x, cw=None):
        if self.groups is None:
            raise ValueError("PHuberSmootherGL.val requires group structure")
        u = _infconv_huber(self.groups, x, self.lam1, self.mu)
        return _infconv_huber(self.groups, u, self.lam2, self.mu)

    def grad(self, x, cw=None):
        return _gl_grad(lambda v: phuber_val(v, self.mu),
                        lambda v: phuber_grad(v, self.mu), x, cw)

    def hess_diag(self, x, cw=None):
        return _gl_hess(lambda v: phuber_val(v, self.mu),
                        lambda v: phuber_grad(v, self.mu),
                        lambda v: phuber_hess(v, self.mu), x, cw)


@frozen_dataclass
class OsBaSmootherGL(SmootherBase):
    """Ostrovskii & Bach smoothing for the sparse group-lasso
    regularizer."""

    mu: float
    lam1: torch.Tensor = 0.0
    lam2: torch.Tensor = 0.0
    groups: Optional[Groups] = None
    Mh: float = _OSBA_MH
    nu: float = _OSBA_NU

    def val(self, x, cw=None):
        if self.groups is None:
            raise ValueError("OsBaSmootherGL.val requires group structure")
        u = _infconv_osba(self.groups, x, self.lam1, self.mu)
        return _infconv_osba(self.groups, u, self.lam2, self.mu)

    def grad(self, x, cw=None):
        return _gl_grad(lambda v: osba_val(v, self.mu),
                        lambda v: osba_grad(v, self.mu), x, cw)

    def hess_diag(self, x, cw=None):
        return _gl_hess(lambda v: osba_val(v, self.mu),
                        lambda v: osba_grad(v, self.mu),
                        lambda v: osba_hess(v, self.mu), x, cw)


def make_gl_smoother(cls, mu, problem):
    """The reference's call shape ``PHuberSmootherGL(mu, model)``: λ₁, λ₂
    and the groups from the problem."""
    lam = torch.atleast_1d(torch.as_tensor(problem.lam))
    if lam.shape[0] < 2:
        raise ValueError(
            "group-lasso smoother requires lam = [lam1, lam2] on the problem")
    if problem.groups is None:
        raise ValueError("problem must carry group structure (groups=...)")
    return cls(mu=mu, lam1=lam[0], lam2=lam[1], groups=problem.groups)
