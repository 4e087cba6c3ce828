"""Logistic regression with 0/1 labels — the main-path model family.

Port of the logistic01 part of `scso_tpu.models.losses`:
    f(A, y, x) = (1/m)·Σ [softplus(Ax) − y⊙(Ax)]
with closed-form derivatives and its :data:`LOGISTIC01_GLM` spec. The
other families (±1 logistic, least squares, Poisson, multinomial, QP,
Rosenbrock) are not ported yet (ROADMAP A7, A9, B2).

``softplus`` here is ``logaddexp(z, 0)``, the form `jax.nn.softplus`
uses. `torch.nn.functional.softplus` switches to the identity above
``threshold=20``, which breaks float64 parity with the JAX package.
"""

from __future__ import annotations

import torch

from scso_tpu_torch.problems import GLMSpec


def softplus(z):
    """log(1 + exp(z)) for every z, without the identity shortcut."""
    return torch.logaddexp(z, torch.zeros_like(z))


def logistic01_f(A, y, x):
    z = A @ x
    return torch.mean(softplus(z) - y * z)


def logistic01_grad(A, y, x):
    return A.T @ (torch.sigmoid(A @ x) - y) / A.shape[0]


def logistic01_hvp_w(A, y, x):
    """w = σ'(Ax)/m — label-independent GLM Hessian weights."""
    s = torch.sigmoid(A @ x)
    return s * (1.0 - s) / A.shape[0]


def logistic_ggn_w(A, y, x):
    """GGN weights w = (y·(1−ŷ)² + (1−y)·ŷ²)/m, ŷ = σ(Ax), in the
    saturation-stable product form."""
    z = A @ x
    return (y * torch.sigmoid(-z) ** 2
            + (1.0 - y) * torch.sigmoid(z) ** 2) / A.shape[0]


def sigmoid_out(A, x):
    """Model output ŷ = σ(A x)."""
    return torch.sigmoid(A @ x)


def _sig_dlink(z):
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LOGISTIC01_GLM = GLMSpec(
    link=torch.sigmoid,
    dlink=_sig_dlink,
    res=lambda y, yhat: (-(y / yhat) + (1.0 - y) / (1.0 - yhat))
    / yhat.shape[0],
    qdiag=lambda y, yhat: (y / yhat**2 + (1.0 - y) / (1.0 - yhat) ** 2)
    / yhat.shape[0],
    hvp_w=lambda y, z: _sig_dlink(z) / z.shape[0],
    gres=lambda y, z: (torch.sigmoid(z) - y) / z.shape[0],
    ggn_rw=lambda y, z: (torch.sigmoid(z) - y) / z.shape[0],
    ggn_w=lambda y, z: (
        y * torch.sigmoid(-z) ** 2
        + (1.0 - y) * torch.sigmoid(z) ** 2
    ) / z.shape[0],
    loss_z=lambda y, z: torch.mean(softplus(z) - y * z),
    loss_sample=lambda y, z: softplus(z) - y * z,
    kind="logistic01",
)
