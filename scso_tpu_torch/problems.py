"""Problem containers: minimize f(A, y, x) + λ·g(x) — the data flavour.

Port of `scso_tpu.problems`. A :class:`Problem` is a frozen dataclass of
tensors that all live on one ``device`` in one ``dtype``; both are
explicit fields, because PyTorch has no global x64 switch (the CPU tests
pass ``torch.float64`` and ``device='cpu'``; the device defaults to the
card). ∇f is the user's ``grad_fx``, else autograd
through ``f`` (``torch.func.grad``). The generic ``f(x)`` flavour, the
Hessian fallbacks, group structure, test data and the dense GGN hooks
are not ported yet (ROADMAP A7, A8).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import frozen_dataclass
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
    A's row count."""

    x0: torch.Tensor
    lam: torch.Tensor
    A: torch.Tensor
    y: torch.Tensor
    x_star: torch.Tensor
    f: Callable
    dtype: torch.dtype
    device: torch.device
    L: Optional[torch.Tensor] = None
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None
    glm: Optional[GLMSpec] = None
    mglm: Optional[MOGLMSpec] = None
    grad_fx: Optional[Callable] = None
    n_true: Optional[int] = None
    mesh: Optional[Any] = None
    data_axis: str = "data"
    m_total: Optional[int] = None

    def __post_init__(self):
        if self.m_total is None and self.A is not None:
            object.__setattr__(self, "m_total", int(self.A.shape[0]))

    def f_val(self, As, ys, x):
        """f at x on the given batch."""
        return self.f(As, ys, x)

    def grad_f(self, As, ys, x):
        """∇f — the user's ``grad_fx``, else ``torch.func.grad`` through
        ``f``."""
        if self.grad_fx is not None:
            return self.grad_fx(As, ys, x)
        return torch.func.grad(lambda v: self.f_val(As, ys, v))(x)

    def reg(self, reg_name: str, x):
        return reg_value(reg_name, x, lam=self.lam, lb=self.lb, ub=self.ub)

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


def _resolve_bounds(C_set, dtype, device):
    """``[lb, ub]`` (scalars or length-n arrays) → (lb, ub) tensors."""
    if C_set is None:
        return None, None
    to = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return to(C_set[0]), to(C_set[1])


def make_problem(*args, L=None, sol=None, C_set=None, glm=None,
                 mglm=None, grad_fx=None, dtype=None, device=None,
                 pad_features=False, **unported) -> Problem:
    """Build a data :class:`Problem`: ``make_problem(A, y, x0, f, lam)``.

    Arrays may be numpy arrays or tensors; they are converted to
    ``dtype`` (default: x0's floating type, else float32) on ``device``
    (default: the card; without one, pass ``device='cpu'`` — a missing
    device raises there). ``pad_features=True`` zero-pads the feature axis
    to a multiple of 128 on the host before the transfer — the padded
    coordinates stay exactly 0 for l1/l2/no-prox solves, and
    ``Solution.x`` is sliced back to ``n_true``. ``grad_fx(A, y, x)`` is
    ∇f (L-BFGS, and the BB and Armijo step sizes; autograd through ``f``
    when absent); ``mglm`` cannot be padded.
    """
    if unported:
        raise NotImplementedError(
            f"make_problem options {sorted(unported)} are not ported yet "
            "(ROADMAP A7, A8)")
    if len(args) != 5:
        raise NotImplementedError(
            "only the data flavour make_problem(A, y, x0, f, lam) is "
            "ported (ROADMAP A7)")
    A, y, x0, f, lam = args
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.as_tensor(x0).dtype
        if not dtype.is_floating_point:
            dtype = torch.float32

    n_true = None
    if pad_features:
        n = x0.shape[-1]
        pad = (-n) % 128
        if pad:
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

            x0, sol, A = zpad(x0), zpad(sol), zpad(A)

    def to(v):
        # python scalars go through numpy (float64): a direct as_tensor
        # would round them to float32 first
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
        glm=glm,
        mglm=mglm,
        grad_fx=grad_fx,
        n_true=n_true,
    )

