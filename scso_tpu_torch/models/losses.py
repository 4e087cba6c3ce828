"""The ported model families.

Port of six parts of `scso_tpu.models.losses`:
  * least squares, f(A, y, x) = (1/(2m))·‖Ax − y‖², its gradient,
    Hessian, GGN hooks and :data:`LSQ_GLM` spec (the group-lasso path);
  * Poisson regression with the canonical log link,
    f(A, y, x) = (1/m)·Σ [exp(Ax) − y⊙(Ax)], its gradient, Hessian, GGN
    hooks and :data:`POISSON_GLM` spec;
  * logistic regression with 0/1 labels (the sparse-logistic path),
    f(A, y, x) = (1/m)·Σ [softplus(Ax) − y⊙(Ax)], its Hessian and its
    :data:`LOGISTIC01_GLM` spec;
  * logistic regression with ±1 labels (the reference's oracle fixture),
    f = (1/m)·Σ softplus(−y⊙(Ax)), with its gradient and Hessian, and
    the dense GGN hooks the reference writes for it (the 0/1
    cross-entropy in ŷ, its residual and curvature, J of ŷ = σ(Ax));
  * multinomial (softmax) regression over the logits split Z = A·W,
    W = x.reshape(p, k), f = (1/m)·Σᵢ [logsumexp(Zᵢ) − yᵢ·Zᵢ], and its
    :data:`MULTINOM_MGLM` spec (per-k: :func:`multinom_mglm`);
  * the problems without data: the quadratic program
    f(x) = ½xᵀQx + cᵀx (:func:`qp_f`, with Q and c bound by the caller)
    and the Rosenbrock function.
The probability-split multinomial family is not ported.

``softplus`` here is ``logaddexp(z, 0)``, the form `jax.nn.softplus`
uses. `torch.nn.functional.softplus` switches to the identity above
``threshold=20``, which breaks float64 parity with the JAX package.

A may be stored in bfloat16 with x in float32 or float64 (the coarse
phase of `iterate_mixed`): its products go through `ops.dense`, which
upcasts A's values exactly, as JAX promotes them. Every function here
reaches A only through `ops.dense` (the dense Hessians through its Gram
product, the Jacobians through ``widen``), so each also runs on a
column-sharded A (`parallel.shard_problem_features`).
"""

from __future__ import annotations

import torch

from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.ops.dense import amul, atmul, gram, widen
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
    return gram(A, s * (1.0 - s)) / A.shape[0]


def logistic_hvp(A, y, x, v):
    """∇²f·v of :func:`logistic_f`, without forming ∇²f."""
    s = torch.sigmoid(y * amul(A, x))
    return atmul(A, s * (1.0 - s) * amul(A, v)) / A.shape[0]


def logistic_hvp_w(A, y, x):
    """The weights w of ∇²f·v = Aᵀ(w∘(A·v)) for :func:`logistic_f`:
    σ(1−σ)/m."""
    s = torch.sigmoid(y * amul(A, x))
    return s * (1.0 - s) / A.shape[0]


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
    return gram(A, s * (1.0 - s)) / A.shape[0]


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


def lsq_f(A, y, x):
    r = amul(A, x) - y
    return 0.5 * torch.sum(r * r) / A.shape[0]


def lsq_grad(A, y, x):
    return atmul(A, amul(A, x) - y) / A.shape[0]


def lsq_hess(A, y, x):
    return gram(widen(A, x.dtype)) / A.shape[0]


def linear_out(A, x):
    return amul(A, x)


def lsq_loss(y, yhat):
    r = yhat - y
    return 0.5 * torch.sum(r * r) / yhat.shape[0]


def lsq_ggn_residual(A, y, yhat):
    return (yhat - y) / yhat.shape[0]


def lsq_ggn_qdiag(A, y, yhat):
    return torch.full_like(yhat, 1.0 / yhat.shape[0])


def linear_jac(A, y, yhat, x):
    return widen(A, yhat.dtype)


def lsq_hvp_w(A, y, x):
    """∇²f·v = Aᵀ(w∘(Av)) with w = 1/m for least squares."""
    return torch.full((A.shape[0],), 1.0 / A.shape[0], dtype=x.dtype,
                      device=x.device)


lsq_ggn_w = lsq_hvp_w  # J = A, Q = I/m


LSQ_GLM = GLMSpec(
    link=lambda z: z,
    dlink=torch.ones_like,
    res=lambda y, yhat: (yhat - y) / yhat.shape[0],
    qdiag=lambda y, yhat: torch.full_like(yhat, 1.0 / yhat.shape[0]),
    hvp_w=lambda y, z: torch.full_like(z, 1.0 / z.shape[0]),
    gres=lambda y, z: (z - y) / z.shape[0],
    ggn_rw=lambda y, z: (z - y) / z.shape[0],
    ggn_w=lambda y, z: torch.full_like(z, 1.0 / z.shape[0]),
    loss_z=lambda y, z: 0.5 * torch.sum((z - y) ** 2) / z.shape[0],
    loss_sample=lambda y, z: 0.5 * (z - y) ** 2,
    kind="lsq",
)


# exp overflows float32 at z ≈ 88.7, in the JAX spec as here: keep the
# data scaled so that the linear predictor stays moderate


def poisson_f(A, y, x):
    z = amul(A, x)
    return torch.mean(torch.exp(z) - y * z)


def poisson_grad(A, y, x):
    return atmul(A, torch.exp(amul(A, x)) - y) / A.shape[0]


def poisson_hess(A, y, x):
    w = torch.exp(amul(A, x))
    return gram(A, w) / A.shape[0]


def poisson_hvp_w(A, y, x):
    """GLM Hessian weights: ∇²f·v = Aᵀ(w∘(Av)), w = exp(Ax)/m."""
    return torch.exp(amul(A, x)) / A.shape[0]


def exp_out(A, x):
    """Model output ŷ = exp(A x), the canonical Poisson mean."""
    return torch.exp(amul(A, x))


def poisson_loss(y, yhat):
    """(1/m)·Σ [ŷ − y log ŷ], the Poisson NLL in ŷ."""
    return torch.mean(yhat - y * torch.log(yhat))


def poisson_ggn_residual(A, y, yhat):
    """∇_ŷ of :func:`poisson_loss`: (1 − y/ŷ)/m."""
    return (1.0 - y / yhat) / yhat.shape[0]


def poisson_ggn_qdiag(A, y, yhat):
    """diag ∇²_ŷ of :func:`poisson_loss`: (y/ŷ²)/m."""
    return y / yhat**2 / yhat.shape[0]


def exp_jac(A, y, yhat, x):
    """J = ∂ŷ/∂x = diag(ŷ)·A."""
    return widen(A, yhat.dtype) * yhat[:, None]


def poisson_ggn_w(A, y, x):
    """GGN weights w = ŷ²·qdiag = y/m: the counts, no link evaluation
    (the product form cancels both exponentials)."""
    return torch.broadcast_to(y / A.shape[0], (A.shape[0],))


POISSON_GLM = GLMSpec(
    link=torch.exp,
    dlink=torch.exp,
    res=lambda y, yhat: (1.0 - y / yhat) / yhat.shape[0],
    qdiag=lambda y, yhat: y / yhat**2 / yhat.shape[0],
    hvp_w=lambda y, z: torch.exp(z) / z.shape[0],
    gres=lambda y, z: (torch.exp(z) - y) / z.shape[0],
    # product forms: ŷ·res = (ŷ−y)/m (no division) and ŷ²·qdiag = y/m
    ggn_rw=lambda y, z: (torch.exp(z) - y) / z.shape[0],
    ggn_w=lambda y, z: torch.broadcast_to(y / z.shape[0], z.shape),
    loss_z=lambda y, z: torch.mean(torch.exp(z) - y * z),
    loss_sample=lambda y, z: torch.exp(z) - y * z,
    kind="poisson",
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


def qp_f(Q, c, x):
    """½xᵀQx + cᵀx."""
    return 0.5 * torch.dot(x, Q @ x) + torch.dot(c, x)


def qp_grad(Q, c, x):
    return 0.5 * (Q + Q.T) @ x + c


def qp_hess(Q, c, x):
    return 0.5 * (Q + Q.T)


def rosenbrock(x):
    """100·(x₁ − x₀²)² + (1 − x₀)²."""
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
