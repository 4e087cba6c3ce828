"""Problem containers: minimize f(A, y, x) + λ·g(x) — the data flavour.

Port of `scso_tpu.problems`. A :class:`Problem` is a frozen dataclass of
tensors that all live on one ``device`` in one ``dtype``; both are
explicit fields, because PyTorch has no global x64 switch (the CPU tests
pass ``torch.float64``). The generic ``f(x)`` flavour, AD fallbacks,
group structure, test data and the dense GGN hooks are not ported yet
(ROADMAP A7, A8).
"""

from __future__ import annotations

from typing import Callable, Optional

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
class Problem:
    """Composite convex problem over a data matrix: f(A, y, x) + λ·g(x).

    ``x_star`` is the ground truth used for relative-error reporting
    (zeros by default, as in the JAX package). ``n_true`` is set by
    ``make_problem(pad_features=True)``: the unpadded feature count."""

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
    n_true: Optional[int] = None

    def f_val(self, As, ys, x):
        """f at x on the given batch."""
        return self.f(As, ys, x)

    def reg(self, reg_name: str, x):
        return reg_value(reg_name, x, lam=self.lam, lb=self.lb, ub=self.ub)


def _resolve_bounds(C_set, dtype, device):
    """``[lb, ub]`` (scalars or length-n arrays) → (lb, ub) tensors."""
    if C_set is None:
        return None, None
    to = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return to(C_set[0]), to(C_set[1])


def make_problem(*args, L=None, sol=None, C_set=None, glm=None,
                 dtype=None, device=None, pad_features=False,
                 **unported) -> Problem:
    """Build a data :class:`Problem`: ``make_problem(A, y, x0, f, lam)``.

    Arrays may be numpy arrays or tensors; they are converted to
    ``dtype`` (default: x0's floating type, else float32) on ``device``
    (default: the CPU). ``pad_features=True`` zero-pads the feature axis
    to a multiple of 128 on the host before the transfer — the padded
    coordinates stay exactly 0 for l1/l2/no-prox solves, and
    ``Solution.x`` is sliced back to ``n_true``.
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
    device = torch.device("cpu" if device is None else device)
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
        n_true=n_true,
    )

