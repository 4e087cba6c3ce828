"""K3: the SCORE damped-prox update.

Port of `scso_tpu/ops/pallas/score_update.py` (`_fused_update`), the
tail of every epoch:

    η     = sqrt(Σ lgr²/hr)   (a term with lgr = 0 counts as 0)
    α     = ss/(1 + M_g·η);  safe = min(1, α)
    x⁺    = prox(x + safe·d; t = ss·λ·hr)   for 'l1', 'l2', 'indbox', 'none'
    pri   = ‖x⁺ − x‖

The CUDA kernel is ``csrc/score_update.cu``: one launch of one
thread-block cluster, of one block below :data:`CLUSTER_N` and of the
card's largest size up to :data:`GRID_N`, three grid launches from it on
(:func:`update_form`); :func:`score_update_torch` is the plain version,
and the one the
solver's 'torch' path runs. λ and ss come in, and pri, safe, η go out,
as 0-d tensors on the device, so neither version waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.cuda import build, counters, launch

REG_CODES = {"l1": 0, "l2": 1, "indbox": 2, "none": 3}
#: from this n on, one cluster of the card's largest size (16 blocks on
#: the H100); below it one block (a cluster of one). Swept on the H100
#: (PERF.md §6): one block is ahead at n = 1024, 16 blocks from 4096
CLUSTER_N = 4096
#: from this n on, the grid form (three launches over the whole card),
#: which the sweep puts ahead of one cluster from 2²⁰ (PERF.md §6)
GRID_N = 1 << 20
#: a cluster block's slice is a multiple of this many values
_SLICE_ALIGN = 32
#: elements a block of the grid form owns, at least
_BLOCK_ELEMS = 1 << 16
_MAX_BLOCKS = 1024


class UpdateForm(NamedTuple):
    blocks: int   # the cluster's blocks, or the grid's
    chunk: int    # values of n each block owns (the last may own fewer)
    grid: bool    # the three-launch grid form


def update_blocks(n: int) -> int:
    """Blocks of K3's grid form for n values; 0 (the cluster form) below
    :data:`GRID_N`. Each block owns a contiguous slice of at least 65536
    values; at most 1024 blocks, so the fixed-order sums over the
    blocks' partials stay one block's loop."""
    if n < GRID_N:
        return 0
    return min(_MAX_BLOCKS, -(-n // _BLOCK_ELEMS))


def cluster_slice(n: int, blocks: int) -> int:
    """Values of n a block of a ``blocks``-block cluster owns: the even
    share rounded up to :data:`_SLICE_ALIGN`, so every slice but the last
    starts on a 128-byte line in float32."""
    share = max(1, -(-n // blocks))
    return -(-share // _SLICE_ALIGN) * _SLICE_ALIGN


def update_form(n: int, max_cluster: int = 16) -> UpdateForm:
    """K3's form for n values on a card whose largest cluster of this
    kernel is ``max_cluster`` blocks (``launch.max_cluster``): one block
    below :data:`CLUSTER_N`, one cluster of ``max_cluster`` blocks below
    :data:`GRID_N`, the grid form from it on."""
    nblk = update_blocks(n)
    if nblk:
        return UpdateForm(nblk, -(-n // nblk), True)
    blocks = 1 if n < CLUSTER_N else max_cluster
    return UpdateForm(blocks, cluster_slice(n, blocks), False)


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
    version for CPU tensors. ``lam``, ``ss`` and ``Mg`` are 0-d tensors
    (or floats, moved to the device; a tensor M_g, from a smoother whose
    μ is a tensor, is read by the kernel on the card, so that a captured
    solve's μ can change between replays); ``lb``/``ub`` (indbox only)
    broadcast to (n,)."""
    if launch.on_cpu(x, "score_update"):
        return score_update_torch(x, d, lgr, hr, lam, ss, Mg, reg_name,
                                  use_prox, lb, ub)
    return _launch(x, d, lgr, hr, lam, ss, Mg, reg_name, use_prox, lb, ub)


def _scalar(s, dt, dev) -> torch.Tensor:
    """``s`` as a 0-d tensor of ``dt`` on ``dev``, as it is if it is one;
    a number by a fill on the device (no copy from the host, which a
    capture refuses)."""
    if (isinstance(s, torch.Tensor) and s.dtype == dt and s.device == dev
            and s.dim() == 0):
        return s
    if not isinstance(s, torch.Tensor):
        return torch.full((), float(s), dtype=dt, device=dev)
    return s.to(device=dev, dtype=dt).reshape(())


def _launch(x, d, lgr, hr, lam, ss, Mg, reg_name: str, use_prox=True,
            lb=None, ub=None, form: UpdateForm = None) -> ScoreUpdate:
    """The kernel on CUDA tensors, in ``form`` (default: update_form's;
    chip_smoke.py sweeps the forms with it)."""
    reg = _reg_kind(reg_name, use_prox)
    (n,) = x.shape
    dev, dt = x.device, x.dtype
    lam, ss, Mg = (_scalar(v, dt, dev) for v in (lam, ss, Mg))
    if reg == "indbox":
        if lb is None or ub is None:
            raise ValueError("indbox prox requires lb/ub (C_set)")
        full = lambda b: torch.broadcast_to(
            torch.as_tensor(b, dtype=dt, device=dev), (n,)).contiguous()
        lb, ub = full(lb), full(ub)
        launch.check_operands("score_update", dt, dev, x=x, d=d, lgr=lgr,
                              hr=hr, lam=lam, ss=ss, Mg=Mg, lb=lb, ub=ub)
    else:
        lb = ub = None
        launch.check_operands("score_update", dt, dev, x=x, d=d, lgr=lgr,
                              hr=hr, lam=lam, ss=ss, Mg=Mg)
    for arg, t in (("d", d), ("lgr", lgr), ("hr", hr)):
        if t.shape != (n,):
            raise ValueError(f"score_update: {arg} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
    if form is None:
        form = update_form(n, launch.max_cluster("scso_score_update", dt,
                                                 dev.index))
    if launch.use_ops():
        x_new, stats = torch.ops.scso.score_update(
            x, d, lgr, hr, lb, ub, lam, ss, Mg, REG_CODES[reg], form.blocks,
            form.chunk, int(form.grid))
        return ScoreUpdate(x_new, *stats.unbind())
    x_new = torch.empty_like(x)
    stats = torch.empty((3,), dtype=dt, device=dev)
    # grid form: the blocks' partials of Σ lgr²/hr and ‖x⁺ − x‖²
    partials = (torch.empty((2 * form.blocks,), dtype=torch.float64,
                            device=dev) if form.grid else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = launch.call(
        dev, launch.entry("scso_score_update", dt), x.data_ptr(),
        d.data_ptr(), lgr.data_ptr(), hr.data_ptr(), ptr(lb), ptr(ub),
        lam.data_ptr(), ss.data_ptr(), Mg.data_ptr(), REG_CODES[reg],
        x_new.data_ptr(), stats.data_ptr(), ptr(partials), n, form.blocks,
        form.chunk, int(form.grid), launch.stream(dev))
    build.check(rc, "score_update")
    counters.bump("score_update")
    nancheck.check("score_update", (x_new, stats),
                   (x, d, lgr, hr, lb, ub, lam, ss, Mg))
    return ScoreUpdate(x_new, *stats.unbind())
