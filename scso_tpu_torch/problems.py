"""Problem containers: minimize f(x) + λ·g(x).

Port of `scso_tpu.problems`, in its two flavours: a data problem
f(A, y, x) over a data matrix (``make_problem(A, y, x0, f, lam)``, with
an optional test set ``Atest``/``ytest``), and a problem without data,
f(x) (``make_problem(x0, f, lam)``); ``make_problem()`` is the
reference's empty :class:`ProblemLike`. A :class:`Problem` is a frozen
dataclass of tensors that all live on one ``device`` in one ``dtype``;
both are explicit fields, because PyTorch has no global x64 switch (the
CPU tests pass ``torch.float64`` and ``device='cpu'``; the device
defaults to the card). ∇f is the user's ``grad_fx``, else autograd
through ``f`` (``torch.func.grad``); ∇²f the user's ``hess_fx``, else
``torch.func.hessian``; the Hessian-vector product forward-over-reverse.
The dense GGN step reads (ŷ, J, residual, Q) from the user's ``jac_yx``,
``grad_fy`` and ``hess_fy``, else from autograd of ``out_fn`` and
``loss_fn``; the matrix-free one applies J by ``torch.func.jvp`` and
``vjp`` of ``out_fn``. ``groups`` is the group structure of the sparse
group lasso ('gl'); ``col_sumsq`` (:func:`with_col_sumsq`) diag(AᵀA)
for the static Jacobi preconditioner.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import frozen_dataclass
from scso_tpu_torch.ops.groups import Groups, make_groups
from scso_tpu_torch.ops.regularizers import reg_value


@frozen_dataclass
class GLMSpec:
    """Generalized-linear-model structure: everything derived from z = A·x.

    Fields (all elementwise in z / yhat; the residual and weight forms
    divide by len(z), the 1/m loss normalization):
      link, dlink:     z -> yhat, dyhat/dz
      res, qdiag:      (y, yhat) -> dloss/dyhat, d2loss/dyhat2
      hvp_w, gres:     (y, z) -> Newton weights, gradient residual
      ggn_rw, ggn_w:   (y, z) -> σ'·res and σ'²·qdiag in stable forms
      loss_z:          (y, z) -> f at z = A·x, same scale as Problem.f
      loss_sample:     (y, z) -> per-sample loss, unnormalized
    ``kind`` names the family, so a CUDA kernel specialised on it can be
    chosen (the TPU kernels trace the Python callables instead)."""

    link: Callable
    dlink: Callable
    res: Callable
    qdiag: Callable
    hvp_w: Callable
    gres: Callable
    ggn_rw: Optional[Callable] = None
    ggn_w: Optional[Callable] = None
    sample_normalized: bool = True
    loss_z: Optional[Callable] = None
    loss_sample: Optional[Callable] = None
    kind: Optional[str] = None


@frozen_dataclass
class MOGLMSpec:
    """Multi-output GLM structure: everything derived from Z = A·W with
    W = x.reshape(n_features, n_out) — vector model outputs such as
    multinomial (softmax) regression with k classes per sample. Each CG
    matvec applies the per-sample k×k curvature actions matrix-free.

    Fields (Z is (m, k); all rowwise):
      n_out:   k — outputs per sample.
      gres:    (y, Z) -> (m, k) residual dL/dZ (∇f = vec(Aᵀ·gres)).
      quad:    (y, Z, U) -> (m, k) curvature action Q(Z)[U].
      qdiag_w: (y, Z) -> (m, k) diagonal of the per-sample curvature
               blocks (Jacobi weights: diag(AᵀQA) ≈ Σᵢ wᵢ·Aᵢⱼ²).
      loss_z:  (y, Z) -> f, same scale as Problem.f.
      loss_sample: (y, Z) -> (m,) per-sample loss, unnormalized.
    ``sample_normalized``: gres/quad/qdiag_w divide by Z.shape[0].
    ``kind`` names the family, so a CUDA kernel specialised on it can be
    chosen (the TPU kernel traces ``quad`` instead)."""

    n_out: int
    gres: Callable
    quad: Callable
    qdiag_w: Callable
    loss_z: Optional[Callable] = None
    loss_sample: Optional[Callable] = None
    sample_normalized: bool = True
    kind: Optional[str] = None


@frozen_dataclass
class Problem:
    """Composite convex problem over a data matrix: f(A, y, x) + λ·g(x).

    ``x_star`` is the ground truth used for relative-error reporting
    (zeros by default, as in the JAX package). ``n_true`` is set by
    ``make_problem(pad_features=True)``: the unpadded feature count.

    ``mesh`` and ``data_axis`` are set by `parallel.shard_problem` (and
    `parallel.load_problem_rows_sharded`): A and y then hold this rank's
    rows only, and ``m_total`` is the row count of all ranks together —
    the m of every 1/m loss normalization. Unsharded, ``m_total`` is
    A's row count.

    ``A_lp`` is an optional low-precision copy of A (bfloat16, built by
    `algorithms.mixed.with_lp_copy` or by AUTO, `ProxGGNSCORE.auto_lp`)
    for precision-adaptive CG: epochs whose CG forcing tolerance is at
    least ``ProxGGNSCORE.cg_lp_tol`` run their curvature matvecs on it,
    at half the bytes of A. It has A's (padded) shape and, on a row
    shard, A's rows; the RHS and the prep always use A."""

    x0: torch.Tensor
    lam: torch.Tensor
    A: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    x_star: torch.Tensor
    f: Callable
    dtype: torch.dtype
    device: torch.device
    L: Optional[torch.Tensor] = None
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None
    groups: Optional[Groups] = None
    glm: Optional[GLMSpec] = None
    mglm: Optional[MOGLMSpec] = None
    grad_fx: Optional[Callable] = None
    n_true: Optional[int] = None
    mesh: Optional[Any] = None
    data_axis: str = "data"
    m_total: Optional[int] = None
    A_lp: Optional[torch.Tensor] = None
    #: the reference's derivative hooks, as in the JAX package:
    #: hess_fx(A, y, x) → ∇²f; out_fn(A, x) → ŷ and loss_fn(y, ŷ) → f
    #: for the dense GGN step's autograd fallback; jac_yx(A, y, ŷ, x),
    #: grad_fy(A, y, ŷ), hess_fy(A, y, ŷ) and hess_fy_diag(A, y, ŷ) its
    #: user forms; hvp_w(A, y, x) → w with ∇²f·v = Aᵀ(w∘(A·v)) and
    #: ggn_w(A, y, x) the GGN analogue (the CG systems of a problem
    #: without a GLM spec)
    hess_fx: Optional[Callable] = None
    out_fn: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    jac_yx: Optional[Callable] = None
    grad_fy: Optional[Callable] = None
    hess_fy: Optional[Callable] = None
    hess_fy_diag: Optional[Callable] = None
    hvp_w: Optional[Callable] = None
    ggn_w: Optional[Callable] = None
    #: a test set, on the problem's device: each stats record also holds
    #: f(Atest, ytest, x) (``Solution.fvaltest``)
    Atest: Optional[torch.Tensor] = None
    ytest: Optional[torch.Tensor] = None
    #: diag(AᵀA), for the static Jacobi preconditioner
    #: (``static_precond=True``; :func:`with_col_sumsq`)
    col_sumsq: Optional[torch.Tensor] = None
    name: Optional[str] = None

    def __post_init__(self):
        if self.m_total is None and self.A is not None:
            object.__setattr__(self, "m_total", int(self.A.shape[0]))

    @property
    def has_data(self) -> bool:
        """True for the data flavour f(A, y, x), False for f(x)."""
        return self.A is not None

    @property
    def has_test(self) -> bool:
        return self.Atest is not None and self.ytest is not None

    def f_val(self, As, ys, x):
        """f at x on the given batch (f(x) without data)."""
        if self.has_data:
            return self.f(As, ys, x)
        return self.f(x)

    def grad_f(self, As, ys, x):
        """∇f — the user's ``grad_fx``, else ``torch.func.grad`` through
        ``f``."""
        if self.grad_fx is not None:
            return (self.grad_fx(As, ys, x) if self.has_data
                    else self.grad_fx(x))
        return torch.func.grad(lambda v: self.f_val(As, ys, v))(x)

    def hess_f(self, As, ys, x):
        """∇²f — the user's ``hess_fx``, else ``torch.func.hessian``
        through ``f``."""
        if self.hess_fx is not None:
            return (self.hess_fx(As, ys, x) if self.has_data
                    else self.hess_fx(x))
        return torch.func.hessian(lambda v: self.f_val(As, ys, v))(x)

    def hvp_f(self, As, ys, x, v):
        """∇²f(x)·v without forming ∇²f: forward-over-reverse, the jvp
        of ∇f."""
        return torch.func.jvp(lambda u: self.grad_f(As, ys, u), (x,),
                              (v,))[1]

    def out(self, As, x):
        if self.out_fn is None:
            raise ValueError("ProxGGNSCORE requires out_fn on the problem")
        return self.out_fn(As, x)

    def ggn_pieces(self, As, ys, x):
        """(ŷ, J, residual, Q) for the dense GGN step: the user's
        (jac_yx, grad_fy, hess_fy), else autograd of out_fn and
        loss_fn."""
        yhat = self.out(As, x)
        if all(fn is not None
               for fn in (self.jac_yx, self.grad_fy, self.hess_fy)):
            return (yhat, self.jac_yx(As, ys, yhat, x),
                    self.grad_fy(As, ys, yhat), self.hess_fy(As, ys, yhat))
        if self.loss_fn is None:
            raise ValueError(
                "GGN AD fallback requires loss_fn(y, yhat) on the problem "
                "(the reference's second f method)")
        loss = lambda yh: self.loss_fn(ys, yh)
        J = torch.func.jacfwd(lambda v: self.out(As, v))(x)
        return (yhat, J, torch.func.grad(loss)(yhat),
                torch.func.hessian(loss)(yhat))

    def ggn_residual_qdiag(self, As, ys, x):
        """(ŷ, residual, diag Q) for a matrix-free GGN system:
        ``hess_fy_diag`` when given, else the diagonal of ``hess_fy`` or
        of the autograd Hessian of loss_fn."""
        yhat = self.out(As, x)
        loss = lambda yh: self.loss_fn(ys, yh)
        if self.grad_fy is not None:
            residual = self.grad_fy(As, ys, yhat)
        elif self.loss_fn is not None:
            residual = torch.func.grad(loss)(yhat)
        else:
            raise ValueError("GGN requires grad_fy or loss_fn")
        if self.hess_fy_diag is not None:
            q_diag = self.hess_fy_diag(As, ys, yhat)
        elif self.hess_fy is not None:
            q_diag = torch.diagonal(self.hess_fy(As, ys, yhat))
        elif self.loss_fn is not None:
            q_diag = torch.diagonal(torch.func.hessian(loss)(yhat))
        else:
            raise ValueError("GGN requires hess_fy(_diag) or loss_fn")
        return yhat, residual, q_diag

    def jvp_out(self, As, x, v):
        """J·v, J the Jacobian of out_fn at x, without forming J."""
        return torch.func.jvp(lambda u: self.out(As, u), (x,), (v,))[1]

    def vjp_out(self, As, x):
        """(ŷ, u ↦ Jᵀ·u) without forming J."""
        yhat, vjp = torch.func.vjp(lambda u: self.out(As, u), x)
        return yhat, lambda u: vjp(u)[0]

    def reg(self, reg_name: str, x):
        return reg_value(reg_name, x, lam=self.lam, lb=self.lb, ub=self.ub,
                         groups=self.groups)

    def obj(self, reg_name: str, x, As=None, ys=None):
        """f(x) + λ·g(x), on the full data by default."""
        As = self.A if As is None else As
        ys = self.y if ys is None else ys
        return self.f_val(As, ys, x) + self.reg(reg_name, x)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card. Without a CUDA device a
    missing ``device`` raises: the port never moves to the CPU unless
    the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: scso_tpu_torch puts data on the card unless "
            "told otherwise; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class Interval(NamedTuple):
    """Closed interval [lower, upper], accepted as ``C_set`` alone (scalar
    bounds) or as a tuple/list of per-coordinate intervals. Any object
    with ``lower``/``upper`` attributes works too."""

    lower: float
    upper: float


def is_interval_set(obj) -> bool:
    """True for an :class:`Interval` (or any ``.lower``/``.upper``
    object) or a non-empty tuple/list of them."""
    has_lu = lambda o: hasattr(o, "lower") and hasattr(o, "upper")
    if has_lu(obj):
        return True
    return (isinstance(obj, (tuple, list)) and len(obj) > 0
            and all(has_lu(o) for o in obj))


def _resolve_bounds(C_set, dtype, device):
    """``C_set`` → (lb, ub) tensors. Three forms:

      * one :class:`Interval` — scalar bounds, normalised to min/max;
      * a tuple/list of n intervals — per-coordinate bounds, each
        normalised;
      * ``[lb, ub]`` / ``(lb, ub)`` — scalars or length-n arrays, as
        given. A bare nested sequence keeps this meaning: intervals are
        told apart by type, never by length.

    Infinities are kept (the prox and the regularizer read the raw
    bounds; only the smoothers sanitize them)."""
    if C_set is None:
        return None, None
    to = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    if is_interval_set(C_set):
        if hasattr(C_set, "lower"):
            lo, hi = C_set.lower, C_set.upper
            return to(min(lo, hi)), to(max(lo, hi))
        return (to([min(i.lower, i.upper) for i in C_set]),
                to([max(i.lower, i.upper) for i in C_set]))
    return to(C_set[0]), to(C_set[1])


def _pad_groups(grp: Groups, pad: int) -> Groups:
    """``grp`` with ONE zero-weight group of the ``pad`` padded elements
    appended. Zeros stay exactly zero through a solve: the zero-padded A
    keeps the gradient and CG right-hand side at 0 there, the GL
    smoother's chain-rule gradient and Hessian carry the element weight
    (0), and both prox stages map 0 to 0."""
    seg = grp.segment_ids.cpu().numpy()
    w = grp.weights.cpu()
    return make_groups(
        np.concatenate([seg, np.full((pad,), grp.n_groups, dtype=np.int64)]),
        torch.cat([w, torch.zeros((1,), dtype=w.dtype)]).numpy(),
        n_groups=grp.n_groups + 1, dtype=w.dtype)


def with_col_sumsq(prob: Problem) -> Problem:
    """``prob`` with diag(AᵀA) attached (one pass over A, made once) for
    the static Jacobi preconditioner (``static_precond=True``): the
    per-epoch diagonal Σᵢ wᵢAᵢⱼ² is then (Σw/m)·diag(AᵀA), O(m + n) an
    epoch in place of a pass over A."""
    if not prob.has_data:
        raise ValueError("with_col_sumsq requires a data problem")
    from scso_tpu_torch._src.struct import replace as dc_replace
    from scso_tpu_torch.ops.dense import widen

    A = widen(prob.A, prob.dtype)
    return dc_replace(prob, col_sumsq=torch.einsum("ij,ij->j", A, A))


class ProblemLike:
    """The empty model of the reference's zero-argument ``Problem()``:
    no state; it keeps that constructor's arity working."""

    def __repr__(self):
        return "ProblemLike()"


def make_problem(*args, Atest=None, ytest=None, L=None, sol=None,
                 C_set=None, P=None, groups=None, glm=None,
                 mglm=None, grad_fx=None, hess_fx=None, out_fn=None,
                 loss_fn=None, jac_yx=None, grad_fy=None, hess_fy=None,
                 hess_fy_diag=None, hvp_w=None, ggn_w=None, name=None,
                 dtype=None, device=None, pad_features=False):
    """Build a :class:`Problem`, in the reference's call shapes:

      * ``make_problem(A, y, x0, f, lam)`` — a data problem, f(A, y, x);
        ``Atest``/``ytest`` an optional test set (padded with A);
      * ``make_problem(x0, f, lam)`` — a problem without data, f(x)
        (``grad_fx(x)``, ``hess_fx(x)``);
      * ``make_problem()`` — the empty :class:`ProblemLike`.

    Arrays may be numpy arrays or tensors; they are converted to
    ``dtype`` (default: x0's floating type, else float32) on ``device``
    (default: the card; without one, pass ``device='cpu'`` — a missing
    device raises there). ``pad_features=True`` zero-pads the feature axis
    to a multiple of 128 on the host before the transfer — the padded
    coordinates stay exactly 0 for l1/l2/no-prox solves, and
    ``Solution.x`` is sliced back to ``n_true``. ``grad_fx(A, y, x)`` is
    ∇f (L-BFGS, and the BB and Armijo step sizes; autograd through ``f``
    when absent); ``mglm`` cannot be padded. The derivative hooks
    ``hess_fx``, ``out_fn``, ``loss_fn``, ``jac_yx``, ``grad_fy``,
    ``hess_fy``, ``hess_fy_diag``, ``hvp_w`` and ``ggn_w`` are the JAX
    package's (see :class:`Problem`). ``P``/``groups`` take a
    :class:`~scso_tpu_torch.ops.groups.Groups` (the reference's `get_P`
    object); it is moved to ``device`` with its weights in ``dtype``,
    and under padding gets one zero-weight group of the padded
    coordinates.
    """
    if len(args) == 0:
        return ProblemLike()
    if len(args) == 3:
        x0, f, lam = args
        A = y = None
    elif len(args) == 5:
        A, y, x0, f, lam = args
    else:
        raise TypeError("make_problem takes (), (x0, f, lam, ...) or "
                        "(A, y, x0, f, lam, ...)")
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.as_tensor(x0).dtype
        if not dtype.is_floating_point:
            dtype = torch.float32

    grp = groups if groups is not None else P
    n_true = None
    if pad_features:
        n = x0.shape[-1]
        pad = (-n) % 128
        if pad:
            if A is None:
                raise ValueError(
                    "pad_features requires a data problem (A, y): only a "
                    "zero-padded data matrix keeps the padded coordinates "
                    "out of f; an f(x) would optimize over them")
            if C_set is not None:
                raise ValueError(
                    "pad_features cannot be combined with box bounds "
                    "(C_set): the indbox prox clamps the padded "
                    "coordinates into [lb, ub]")
            if mglm is not None:
                raise ValueError(
                    "pad_features cannot be combined with mglm: padding "
                    "appends to the flat x while the multi-output model "
                    "reads x.reshape(n_features, n_out)")
            if grp is not None:
                grp = _pad_groups(grp, pad)
            n_true = n

            def zpad(v):
                if v is None:
                    return None
                if isinstance(v, torch.Tensor):
                    return torch.nn.functional.pad(v, (0, pad))
                vv = np.asarray(v)
                out = np.zeros(vv.shape[:-1] + (vv.shape[-1] + pad,),
                               dtype=vv.dtype)
                out[..., :vv.shape[-1]] = vv
                return out

            x0, sol, A, Atest = zpad(x0), zpad(sol), zpad(A), zpad(Atest)

    def to(v):
        # python scalars go through numpy (float64): a direct as_tensor
        # would round them to float32 first
        if v is None:
            return None
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(device=device, dtype=dtype).contiguous()

    x0 = to(x0)
    lb, ub = _resolve_bounds(C_set, dtype, device)
    return Problem(
        x0=x0,
        lam=to(lam),
        A=to(A),
        y=to(y),
        x_star=to(sol) if sol is not None else torch.zeros_like(x0),
        f=f,
        dtype=dtype,
        device=device,
        L=None if L is None else to(L),
        lb=lb,
        ub=ub,
        groups=None if grp is None else grp.to(device=device, dtype=dtype),
        glm=glm,
        mglm=mglm,
        grad_fx=grad_fx,
        n_true=n_true,
        hess_fx=hess_fx,
        out_fn=out_fn,
        loss_fn=loss_fn,
        jac_yx=jac_yx,
        grad_fy=grad_fy,
        hess_fy=hess_fy,
        hess_fy_diag=hess_fy_diag,
        hvp_w=hvp_w,
        ggn_w=ggn_w,
        Atest=to(Atest),
        ytest=to(ytest),
        name=name,
    )

