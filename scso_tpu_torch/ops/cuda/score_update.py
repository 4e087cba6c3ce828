"""K3: the SCORE damped-prox update.

Port of `scso_tpu/ops/pallas/score_update.py` (`_fused_update`), the
tail of every epoch:

    η     = sqrt(Σ lgr²/hr)   (a term with lgr = 0 counts as 0)
    α     = ss/(1 + M_g·η);  safe = min(1, α)
    x⁺    = prox(x + safe·d; t = ss·λ·hr)   for 'l1', 'l2', 'indbox', 'none'
    pri   = ‖x⁺ − x‖

The CUDA kernel is ``csrc/score_update.cu``; :func:`score_update_torch`
is the plain version, and the one the solver's 'torch' path runs. λ and
ss come in, and pri, safe, η go out, as 0-d tensors on the device, so
neither version waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scso_tpu_torch.ops.cuda import build, counters, launch

REG_CODES = {"l1": 0, "l2": 1, "indbox": 2, "none": 3}
#: one block loops over n; past this a multi-block form would pay off
MAX_N = 1 << 24


class ScoreUpdate(NamedTuple):
    x_new: torch.Tensor   # (n,)
    pri: torch.Tensor     # ()  ‖x⁺ − x‖
    safe: torch.Tensor    # ()  min(1, α)
    eta: torch.Tensor     # ()  η


def _reg_kind(reg_name: str, use_prox: bool) -> str:
    reg = reg_name if use_prox else "none"
    if reg not in REG_CODES:
        raise ValueError(f"score_update does not support reg {reg_name!r}")
    return reg


def score_update_torch(x, d, lgr, hr, lam, ss, Mg, reg_name: str,
                       use_prox: bool = True, lb=None, ub=None
                       ) -> ScoreUpdate:
    """Plain PyTorch damped-prox update (same arithmetic as the kernel).

    ``torch.where`` evaluates both branches, so the lgr = 0 guard selects
    0 for those terms whatever lgr²/hr gives there (0/0 at hr = 0)."""
    reg = _reg_kind(reg_name, use_prox)
    terms = torch.where(lgr == 0, torch.zeros_like(lgr), lgr * lgr / hr)
    eta = torch.sqrt(torch.sum(terms))
    alpha = ss / (1.0 + Mg * eta)
    safe = torch.clamp_max(alpha, 1.0)
    xs = x + safe * d
    if reg == "l1":
        t = ss * lam * hr
        xn = torch.sign(xs) * torch.clamp_min(torch.abs(xs) - t, 0.0)
    elif reg == "l2":
        t = ss * lam * hr
        xs2 = xs * xs
        zero = xs2 == 0
        scale = torch.where(
            zero, torch.zeros_like(xs2),
            torch.clamp_min(1.0 - t / torch.where(zero, torch.ones_like(xs2),
                                                  xs2), 0.0))
        xn = xs * scale
    elif reg == "indbox":
        xn = torch.minimum(torch.maximum(xs, lb), ub)
    else:
        xn = xs
    return ScoreUpdate(xn, torch.linalg.vector_norm(xn - x), safe, eta)


def score_update(x, d, lgr, hr, lam, ss, Mg, reg_name: str,
                 use_prox: bool = True, lb=None, ub=None) -> ScoreUpdate:
    """Damped-prox update — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``lam`` and ``ss`` are 0-d tensors (or
    floats, moved to the device), ``Mg`` a float; ``lb``/``ub`` (indbox
    only) broadcast to (n,)."""
    if launch.on_cpu(x, "score_update"):
        return score_update_torch(x, d, lgr, hr, lam, ss, Mg, reg_name,
                                  use_prox, lb, ub)
    reg = _reg_kind(reg_name, use_prox)
    (n,) = x.shape
    if n > MAX_N:
        raise ValueError(f"score_update: n = {n} exceeds {MAX_N}")
    dev, dt = x.device, x.dtype
    scalar = lambda s: torch.as_tensor(s, dtype=dt, device=dev).reshape(())
    lam, ss = scalar(lam), scalar(ss)
    if reg == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox prox requires lb/ub (C_set)")
        full = lambda b: torch.broadcast_to(
            torch.as_tensor(b, dtype=dt, device=dev), (n,)).contiguous()
        bounds = dict(lb=full(lb), ub=full(ub))
    else:
        bounds = {}
    launch.check_operands("score_update", dt, dev, x=x, d=d, lgr=lgr,
                          hr=hr, lam=lam, ss=ss, **bounds)
    for arg, t in (("d", d), ("lgr", lgr), ("hr", hr)):
        if t.shape != (n,):
            raise ValueError(f"score_update: {arg} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
    x_new = torch.empty_like(x)
    stats = torch.empty((3,), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = launch.entry("scso_score_update", dt)(
            x.data_ptr(), d.data_ptr(), lgr.data_ptr(), hr.data_ptr(),
            ptr(bounds.get("lb")), ptr(bounds.get("ub")), lam.data_ptr(),
            ss.data_ptr(), float(Mg), REG_CODES[reg], x_new.data_ptr(),
            stats.data_ptr(), n, launch.stream(dev))
    build.check(rc, "score_update")
    counters.bump("score_update")
    return ScoreUpdate(x_new, stats[0], stats[1], stats[2])

