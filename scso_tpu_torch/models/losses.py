"""The ported model families.

Port of three parts of `scso_tpu.models.losses`:
  * logistic regression with 0/1 labels (the sparse-logistic path),
    f(A, y, x) = (1/m)·Σ [softplus(Ax) − y⊙(Ax)], its Hessian and its
    :data:`LOGISTIC01_GLM` spec;
  * logistic regression with ±1 labels (the reference's oracle fixture),
    f = (1/m)·Σ softplus(−y⊙(Ax)), with its gradient and Hessian, and
    the dense GGN hooks the reference writes for it (the 0/1
    cross-entropy in ŷ, its residual and curvature, J of ŷ = σ(Ax));
  * multinomial (softmax) regression over the logits split Z = A·W,
    W = x.reshape(p, k), f = (1/m)·Σᵢ [logsumexp(Zᵢ) − yᵢ·Zᵢ], and its
    :data:`MULTINOM_MGLM` spec (per-k: :func:`multinom_mglm`).
The other families (least squares, Poisson, the probability-split
multinomial, QP, Rosenbrock) are not ported yet (ROADMAP A7, A8).

``softplus`` here is ``logaddexp(z, 0)``, the form `jax.nn.softplus`
uses. `torch.nn.functional.softplus` switches to the identity above
``threshold=20``, which breaks float64 parity with the JAX package.

A may be stored in bfloat16 with x in float32 or float64 (the coarse
phase of `iterate_mixed`): its products go through `ops.dense`, which
upcasts A's values exactly, as JAX promotes them.
"""

from __future__ import annotations

import torch

from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.ops.dense import amul, atmul, widen
from scso_tpu_torch.problems import GLMSpec, MOGLMSpec


def softplus(z):
    """log(1 + exp(z)) for every z, without the identity shortcut."""
    return torch.logaddexp(z, torch.zeros_like(z))


def logistic_f(A, y, x):
    return torch.mean(softplus(-y * amul(A, x)))


def logistic_grad(A, y, x):
    s = torch.sigmoid(-y * amul(A, x))
    return atmul(A, -y * s) / A.shape[0]


def logistic_hess(A, y, x):
    s = torch.sigmoid(y * amul(A, x))
    A = widen(A, x.dtype)
    return (A.T * (s * (1.0 - s))) @ A / A.shape[0]


def logistic_loss_01(y, yhat):
    """Cross-entropy in ŷ for 0/1-coded y, −(1/m)·Σ[y log ŷ + (1−y)
    log(1−ŷ)]: the reference's second f method, which it also feeds ±1
    labels (reproduced, as in the JAX package)."""
    m = yhat.shape[0]
    return -torch.sum(y * torch.log(yhat)
                      + (1.0 - y) * torch.log(1.0 - yhat)) / m


def logistic_ggn_residual(A, y, yhat):
    """∇_ŷ of :func:`logistic_loss_01` (divides by ŷ and 1−ŷ: it
    overflows once the link saturates in float32)."""
    return (-(y / yhat) + (1.0 - y) / (1.0 - yhat)) / yhat.shape[0]


def logistic_ggn_qdiag(A, y, yhat):
    """diag ∇²_ŷ of :func:`logistic_loss_01` (it is exactly diagonal)."""
    return (y / yhat**2 + (1.0 - y) / (1.0 - yhat) ** 2) / yhat.shape[0]


def sigmoid_jac(A, y, yhat, x):
    """J = ∂ŷ/∂x = diag(ŷ(1−ŷ))·A."""
    return widen(A, yhat.dtype) * (yhat * (1.0 - yhat))[:, None]


def logistic01_f(A, y, x):
    z = amul(A, x)
    return torch.mean(softplus(z) - y * z)


def logistic01_grad(A, y, x):
    return atmul(A, torch.sigmoid(amul(A, x)) - y) / A.shape[0]


def logistic01_hess(A, y, x):
    s = torch.sigmoid(amul(A, x))
    A = widen(A, x.dtype)
    return (A.T * (s * (1.0 - s))) @ A / A.shape[0]


def logistic01_hvp_w(A, y, x):
    """w = σ'(Ax)/m — label-independent GLM Hessian weights."""
    s = torch.sigmoid(amul(A, x))
    return s * (1.0 - s) / A.shape[0]


def logistic_ggn_w(A, y, x):
    """GGN weights w = (y·(1−ŷ)² + (1−y)·ŷ²)/m, ŷ = σ(Ax), in the
    saturation-stable product form."""
    z = amul(A, x)
    return (y * torch.sigmoid(-z) ** 2
            + (1.0 - y) * torch.sigmoid(z) ** 2) / A.shape[0]


def sigmoid_out(A, x):
    """Model output ŷ = σ(A x)."""
    return torch.sigmoid(amul(A, x))


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


def multinom_f(A, y, x):
    """Softmax cross-entropy in x, in the logsumexp form."""
    z = amul(A, x.reshape(A.shape[1], -1))
    return (torch.sum(torch.logsumexp(z, dim=-1)) - torch.sum(y * z)
            ) / A.shape[0]


def multinom_grad(A, y, x):
    """∇_x f = vec(Aᵀ(ŷ − y))/m."""
    p = torch.softmax(amul(A, x.reshape(A.shape[1], -1)), dim=-1)
    return (atmul(A, p - y) / A.shape[0]).reshape(-1)


def _softmax_quad(y, Z, U):
    """Per-sample softmax curvature action Qᵢuᵢ = (diag(pᵢ) − pᵢpᵢᵀ)uᵢ/m,
    applied rowwise without forming the k×k blocks."""
    P = torch.softmax(Z, dim=-1)
    PU = P * U
    return (PU - P * torch.sum(PU, dim=-1, keepdim=True)) / Z.shape[0]


def _softmax_qdiag(y, Z):
    P = torch.softmax(Z, dim=-1)
    return P * (1.0 - P) / Z.shape[0]


#: Multinomial softmax regression over the logits split Z = A·W. f is
#: convex in Z and Z is linear in x, so AᵀQA is the exact Hessian and
#: ProxGGNSCORE(solver='cg') on this spec is Newton-CG. ``n_out`` is a
#: placeholder: build the spec per k with :func:`multinom_mglm`.
MULTINOM_MGLM = MOGLMSpec(
    n_out=0,
    gres=lambda y, Z: (torch.softmax(Z, dim=-1) - y) / Z.shape[0],
    quad=_softmax_quad,
    qdiag_w=_softmax_qdiag,
    loss_z=lambda y, Z: (torch.sum(torch.logsumexp(Z, dim=-1))
                         - torch.sum(y * Z)) / Z.shape[0],
    loss_sample=lambda y, Z: (torch.logsumexp(Z, dim=-1)
                              - torch.sum(y * Z, dim=-1)),
    kind="multinomial",
)


def multinom_mglm(k: int) -> MOGLMSpec:
    """The multinomial spec for k classes (n_out fixes the
    x.reshape(n_features, k) layout)."""
    return replace(MULTINOM_MGLM, n_out=int(k))
