"""The solve loop: epochs, histories and the Solution record.

Port of the full-batch path of `scso_tpu.algorithms.iterate`, for
ProxNSCORE and ProxGGNSCORE (cached or uncached) and ProxLQNSCORE — the
default method when ``method`` is None — in the JAX package's two modes
(``Options.mode``):

  * 'fused' (the default). The JAX package runs the solve as one jitted
    `lax.while_loop` over epochs. Here the loop's state lives in fixed
    tensors on the data's device (`_Fused`: the carry, and the histories
    preallocated with ``max_epoch + 1`` entries and a record counter, as
    the JAX package's `_init_hist` and `_record`), and one body updates
    them in place: with ``stats_every = 1`` a stats record and an epoch,
    with ``stats_every = K > 1`` a round (a stats record, then K epochs),
    behind ``live = ~done & (k < max_epoch)``, each epoch of a round
    behind its own (`graph.device_if`). On a CUDA problem the body is
    captured once into a CUDA graph, cached for the method, options,
    smoother and problem data (`_capture_key`), and replayed: the CG and
    Armijo loops inside it are conditional nodes (`ops.linalg`), the host
    enqueues batches of replays and reads ``live`` once a batch (a
    replay past the end skips its body), then reads the results once.
    What changes from solve to solve (x0, x*, λ, L, the bounds) is
    copied into the graph's buffers before its replays, and the cache
    is primed at x0 eagerly. On the CPU the same body runs as plain
    Python. Nothing is printed per epoch.
  * 'timed': the JAX package's `_solve_python`, the observability loop:
    a Python loop around the step with a stats record, a wall-clock time
    and a host stop test every epoch, and the ``verbose > 1`` printing.
    As there, GGN and Newton steps run without the epoch cache and
    full-batch L-BFGS carries its gradient. On a CUDA problem the step
    and the stats record are captured graphs too, replayed once an
    epoch. On a row-sharded problem timed mode is the public mode (see
    below): its step is the cached GGN-CG step, the only one ported
    there, and it runs uncaptured.

Stopping is the reference's triple test: ‖x⁺−x‖ < x_tol·max(‖x‖, 1),
relative objective gap ≤ f_tol, or primal residual < x_tol. Records are
taken at x_0 … plus a final record at the terminating iterate. With the
epoch cache the f_tol test between records uses the exact per-epoch gap
(``gap_now``; off the cache, the round's gap). Off the cache a stats
record costs one f(x) pass over A.

A row-sharded problem (`parallel.shard_problem`) is solved SPMD, one
process per rank, on the cached GGN-CG path: ``obj_star`` and every
stats record come from the all-reduced cache, and every test reads
replicated values, so all ranks take the same CG iterations and epochs.
Everything else raises on it before the first collective. Fused mode
captures it on one NCCL rank only, and raises over a gloo group (gloo
reduces CUDA tensors through the host) or over more than one NCCL rank
(the collectives inside the graph's conditional nodes fail to
instantiate). Timed mode runs it on any group: there the step and the
stats record run uncaptured (`graph.eager`; the CG loop reads the card
once an iteration), with the cached step and the cache's loss in each
record, so that its epochs are those of the fused mode.

Not ported yet: mini-batches, metrics, test data and resume (ROADMAP
A7, A12).
"""

from __future__ import annotations

import dataclasses
import math
import time
from contextlib import nullcontext
from typing import Any, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProxNSCORE)
from scso_tpu_torch.algorithms.mixed import cast_once
from scso_tpu_torch.algorithms.steps import (
    GLMCache, MOGLMCache, _cg_tol, _cw, _lam_scalar, _resolve_ggn_solver,
    epoch_cache_enabled, lbfgs_step, make_step_fn, prime_glm_cache)
from scso_tpu_torch.ops.cuda import graph
from scso_tpu_torch.ops.cuda.graph import device_if
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, init_memory
from scso_tpu_torch.problems import Problem


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-solve configuration (the ported subset of the JAX Options)."""

    max_epoch: int = 1000
    x_tol: float = 1e-10
    f_tol: float = 1e-10
    stats_every: int = 1  # record histories every K epochs (1 = parity)
    verbose: int = 1
    mode: str = "fused"   # 'fused' (captured device loop) | 'timed'


class History(NamedTuple):
    """The records; in the fused loop, buffers of ``max_epoch + 1``
    entries on the device and the count ``n_rec`` written so far."""

    fval: torch.Tensor
    obj: torch.Tensor
    rel: torch.Tensor
    objrel: torch.Tensor
    prires: torch.Tensor
    n_rec: Any = None


class Carry(NamedTuple):
    """Solver state between epochs (the JAX while_loop carry): every
    field a tensor on the data's device."""

    x: torch.Tensor
    x_prev: torch.Tensor
    gq: torch.Tensor          # ∇q at x (L-BFGS; zeros otherwise)
    gq_prev: torch.Tensor     # ∇q at x_prev
    d_prev: torch.Tensor      # previous raw direction — CG warm start
    cg_total: torch.Tensor    # cumulative CG iterations (int64)
    bnorm_prev: torch.Tensor  # forcing s_ref (NaN until set)
    frel: torch.Tensor        # last recorded relative objective gap
    k: torch.Tensor           # epochs taken (int32)
    pri_res: torch.Tensor
    done: torch.Tensor        # bool
    mem: LBFGSMemory          # L-BFGS memory (size 1, unused, for GGN)
    fcache: Optional[Union[GLMCache, MOGLMCache]]  # None off the cache


@dataclasses.dataclass
class Solution:
    """Result record; field names mirror the JAX package's Solution.
    Histories are CPU tensors; ``x`` (sliced back to ``n_true``) stays on
    the problem's device, and in fused mode ``state`` (the final carry,
    copied out of the loop's buffers) keeps the padded iterate
    ``state.x`` for a warm start. Fused mode reports the total wall
    clock in ``times[-1]``, timed mode one time a record."""

    x: Any
    obj: Any
    fval: Any
    pri_res_norm: Any
    rel: Any
    objrel: Any
    times: Any
    epochs: int
    model: Problem
    cg_info: Optional[dict] = None
    state: Any = None

    def __repr__(self):
        obj = float(self.obj[-1]) if len(self.obj) else float("nan")
        rel = float(self.rel[-1]) if len(self.rel) else float("nan")
        return (f"Solution(epochs={self.epochs}, obj={obj:.6e}, "
                f"rel={rel:.3e}, n={self.x.shape[-1]})")


def _stats(prob: Problem, reg_name: str, x, obj_star, x_tol, f_tol,
           fval=None):
    """One record: (fval, obj, rel, objrel, raw_frel), all 0-d tensors.
    ``fval`` is the cached data loss when the epoch cache carries one;
    None evaluates f(x), one pass over A (never on a row shard, where it
    would be this rank's f alone)."""
    if fval is None:
        if prob.mesh is not None:
            raise NotImplementedError(
                "f(x) on a row-sharded problem off the epoch cache is not "
                "ported yet (ROADMAP A11)")
        fval = prob.f_val(prob.A, prob.y, x)
    obj = fval + prob.reg(reg_name, x)
    x_star = prob.x_star
    if reg_name == "gl":
        # the mean squared error, over the TRUE n under feature padding
        # (the padded coordinates of x and x_star are both exactly 0)
        n_eff = prob.n_true if prob.n_true is not None else x.shape[-1]
        rel = torch.sum((x_star - x) ** 2) / n_eff
    else:
        rel = torch.clamp_min(
            torch.linalg.vector_norm(x - x_star)
            / torch.clamp_min(torch.linalg.vector_norm(x_star), 1.0), x_tol)
    raw_frel = torch.abs(obj - obj_star) / torch.abs(obj_star)
    objrel = torch.clamp_min(raw_frel, f_tol)
    return fval, obj, rel, objrel, raw_frel


def _resolve_kernels(method, prob: Problem):
    """'auto' → 'cuda' for data on a CUDA device, 'torch' otherwise.
    'cuda' on data that is not on a CUDA device raises."""
    on_cuda = prob.A.device.type == "cuda"
    if method.kernels == "auto":
        return dc_replace(method, kernels="cuda" if on_cuda else "torch")
    if method.kernels == "cuda" and not on_cuda:
        raise ValueError(
            f"kernels='cuda' needs the problem's data on a CUDA device; it "
            f"is on {prob.A.device} (use kernels='torch' or 'auto')")
    return method


def _check_sharded(method, prob: Problem, reg_name: str):
    """A row-sharded problem runs the cached GGN-CG path only. Anything
    else (ProxNSCORE included) raises here, before the first collective:
    ranks that parted at a collective would wait for each other
    forever."""
    if prob.mesh is None:
        return
    what = None
    if not isinstance(method, ProxGGNSCORE):
        what = type(method).__name__
    elif prob.mglm is not None:
        what = "a multi-output (mglm) problem"
    elif not epoch_cache_enabled(method, prob, reg_name, True):
        what = ("the uncached GGN-CG path (ss_type 2 or 3, "
                "epoch_cache=False, or a spec without loss_sample)")
    if what is not None:
        raise NotImplementedError(
            f"{what} on a row-sharded problem is not ported yet: only "
            "the cached GGN-CG path runs sharded (ROADMAP A11)")


def _effective_L(prob: Problem, alpha):
    """The alpha kwarg overrides L as L = 1/alpha."""
    if alpha is not None:
        return dc_replace(prob, L=torch.tensor(1.0 / alpha, dtype=prob.dtype,
                                               device=prob.device))
    return prob


# AUTO precision-adaptive CG engages from this many bytes of A (of this
# rank's rows): the smallest A at which the cached chain with the bf16
# copy beat the chain without it on the H100 (chip_smoke.py phase 11,
# PERF.md). The JAX package's 2 GiB was measured on a TPU v5e.
_AUTO_LP_MIN_BYTES = 2 * 1024**3
# The same for a multi-output problem, on its cached path, or None: AUTO
# attaches no copy there. On the H100 the cached multinomial chain with
# the copy did not beat the chain without it at 49152×1024×16, and at
# 196608×1024×16 only in some runs (chip_smoke.py phase 13(c), PERF.md).
# The JAX package's 512 MiB was measured on a TPU v5e.
_AUTO_LP_MIN_BYTES_MGLM = None


def _auto_lp(method, prob: Problem, reg_name: str = "l1"):
    """Resolve ProxGGNSCORE.auto_lp: maybe attach a bfloat16 copy of A
    and set cg_lp_tol to the CG floor (precision-adaptive CG through the
    bulk epochs, float32 once the endgame tightens past the floor).

    The JAX package's gates, in its order: ProxGGNSCORE; no explicit
    cg_lp_tol, no cg_adaptive, no curvature_rows; a 2-D data problem
    without a copy yet; a float32 GLM or multi-output GLM (the port
    solves full batches only); the resolved solver 'cg'; a row mesh
    (the port's only kind of mesh, whose copy ``shard_problem`` shards
    with A); for a multi-output problem its cached path, where the copy
    acts (`steps._mo_lp_matvec`). ``auto_lp=None`` then adds the
    measured-win gates: A on a CUDA device (where the JAX package asks
    for a TPU), at least ``_AUTO_LP_MIN_BYTES`` of this rank's rows
    (``_AUTO_LP_MIN_BYTES_MGLM`` for a multi-output problem; None:
    never),
    and 1.55 times A (A, the copy and slack) within 0.85 of the card's
    memory. True skips those three; False disables. A that is already
    bfloat16 (the coarse phase of `iterate_mixed`) gets itself as the
    copy, as in the JAX package."""
    auto = method.auto_lp if isinstance(method, ProxGGNSCORE) else False
    if auto is False:
        return method, prob
    if method.cg_lp_tol != 0.0 or method.cg_adaptive or method.curvature_rows:
        return method, prob
    if prob.A is None or prob.A.ndim != 2 or prob.A_lp is not None:
        return method, prob
    if ((prob.glm is None and prob.mglm is None)
            or prob.x0.dtype != torch.float32):
        return method, prob
    if _resolve_ggn_solver(method, prob, prob.x0) != "cg":
        return method, prob
    if prob.mglm is not None and not epoch_cache_enabled(method, prob,
                                                         reg_name, True):
        return method, prob  # the uncached mglm path never reads a copy
    if auto is None:
        A = prob.A
        if A.device.type != "cuda":
            return method, prob
        nbytes = A.numel() * A.element_size()  # this rank's rows
        min_bytes = (_AUTO_LP_MIN_BYTES_MGLM if prob.mglm is not None
                     else _AUTO_LP_MIN_BYTES)
        if min_bytes is None or nbytes < min_bytes:
            return method, prob
        _, total = torch.cuda.mem_get_info(A.device)
        if nbytes * 1.55 > 0.85 * total:
            return method, prob
    method = dc_replace(method, cg_lp_tol=_cg_tol(method, prob.x0.dtype))
    # one copy for the solves of a chain on one A (and one captured graph)
    return method, dc_replace(prob, A_lp=cast_once(prob.A, torch.bfloat16))


def solve(method, prob: Problem, reg_name: str, sm, opts: Options,
          alpha=None, capture: bool = True) -> Solution:
    """Run one solve; returns a :class:`Solution`. ``capture=False`` runs
    the CUDA graphs' bodies eagerly instead (`graph.eager`): the
    reference form of a captured solve, for checks on the card."""
    if not isinstance(method, (ProxNSCORE, ProxGGNSCORE, ProxLQNSCORE)):
        raise TypeError(f"unknown method {method!r}")
    if opts.mode not in ("fused", "timed"):
        raise ValueError(f"mode must be 'fused' or 'timed', not "
                         f"{opts.mode!r}")
    if prob.A is None or prob.y is None:
        raise NotImplementedError(
            "a problem without data (the f(x) flavour) is not ported yet "
            "(ROADMAP A7)")
    prob = _effective_L(prob, alpha)
    method = _resolve_kernels(method, prob)
    method, prob = _auto_lp(method, prob, reg_name)
    _check_sharded(method, prob, reg_name)
    return _solve_impl(method, prob, reg_name, sm, opts, capture)


def _solve_impl(method, prob: Problem, reg_name: str, sm, opts: Options,
                capture: bool = True) -> Solution:
    """The solve of a resolved method (`solve` after its checks). Timed
    mode on a row shard runs uncaptured: its collectives cannot sit in a
    captured graph's conditional nodes (`_check_capturable`)."""
    t0 = time.perf_counter()
    on_card = prob.device.type == "cuda"
    timed = opts.mode == "timed"
    if timed and prob.mesh is not None:
        capture = False
    eager = graph.eager() if on_card and not capture else nullcontext()
    with eager:
        if timed:
            return _solve_timed(method, prob, reg_name, sm, opts,
                                on_card and capture, t0)
        if on_card and capture:
            return _solve_captured(method, prob, reg_name, sm, opts, t0)
        loop = _Fused(method, reg_name, sm, opts)
        loop.load(prob, sm)
        _replays(lambda: loop.round(prob), loop.live, loop.max_rounds)
        return loop.finish(prob, t0)


#: the per-solve tensors of a problem: a captured loop reads its own
#: buffers of them (`_Buffers`), filled before each solve's replays
_COPIED = ("x0", "x_star", "lam", "L", "lb", "ub")


def _tensor_fields(sm) -> dict:
    """The smoother's own tensor fields (bounds, the GL smoother's λ₁
    and λ₂): per-solve tensors too."""
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if isinstance(getattr(sm, f.name), torch.Tensor)}


class _Buffers:
    """The tensors a captured solve reads in place of each solve's own
    per-solve tensors: `_COPIED` of the problem and the smoother's
    tensor fields, filled (:meth:`fill`) before the solve's replays."""

    def __init__(self, prob: Problem, sm):
        self.prob = {f: torch.empty_like(getattr(prob, f)) for f in _COPIED
                     if isinstance(getattr(prob, f), torch.Tensor)}
        self.sm = {name: torch.empty_like(t)
                   for name, t in _tensor_fields(sm).items()}

    def static(self, prob: Problem, sm):
        """The problem and smoother a capture reads: these buffers in
        place of their per-solve tensors."""
        return dc_replace(prob, **self.prob), dc_replace(sm, **self.sm)

    def fill(self, prob: Problem, sm) -> None:
        for name, buf in self.prob.items():
            buf.copy_(getattr(prob, name))
        for name, buf in self.sm.items():
            buf.copy_(getattr(sm, name))


#: replays enqueued before the host first reads ``live``; each later
#: batch is twice the one before
_FIRST_BATCH = 4


def _replays(replay, live, count: int) -> None:
    """``replay()`` up to ``count`` times, in batches: read ``live()``
    once after each batch (one host read on the card) and stop when it
    is false. A replay past the end skips its body."""
    done, batch = 0, _FIRST_BATCH
    while done < count:
        n = min(batch, count - done)
        for _ in range(n):
            replay()
        done += n
        flag = live()
        if flag.device.type == "cuda":
            graph.host_read()
        if not bool(flag):
            return
        batch *= 2


def _leaves(tree):
    """The tensors of a (nested) tuple, in order; None is skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _clone_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone_tree(t) for t in tree))


def _assign(dst, src) -> None:
    """Copy the tensors of ``src`` into the buffers ``dst`` (the same
    structure). A tensor that is its own buffer stays; one that shares
    storage with any buffer is cloned before the first copy."""
    dsts, srcs = _leaves(dst), _leaves(src)
    if len(dsts) != len(srcs):
        raise ValueError("the carry changed its structure")
    ptrs = {d.untyped_storage().data_ptr() for d in dsts}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in ptrs
              else s) for d, s in zip(dsts, srcs) if s is not d]
    for d, s in pairs:
        d.copy_(s)


class _Fused:
    """The fused solve's loop: its carry and histories live in fixed
    tensors, and :meth:`round` (one replay of the captured graph) updates
    them in place. :meth:`load` starts a solve, :meth:`finish` reads it
    out. ``sm`` is the smoother the loop steps with: a captured loop's
    reads ``buffers`` (`_Buffers`, filled at each load; None where each
    solve's own problem and smoother are read: on the CPU and in the
    eager form)."""

    def __init__(self, method, reg_name: str, sm, opts: Options,
                 buffers: Optional[_Buffers] = None):
        self.method, self.reg_name, self.sm, self.opts = (
            method, reg_name, sm, opts)
        self.buffers = buffers
        self.is_lbfgs = isinstance(method, ProxLQNSCORE)
        self.step = make_step_fn(method)
        self.carry = self.hist = self.obj_star = self.use_fcache = None
        K = max(opts.stats_every, 1)
        self.max_rounds = math.ceil(opts.max_epoch / K)

    def load(self, prob: Problem, sm) -> None:
        """Start a solve of ``prob`` with smoother ``sm``, eagerly: their
        per-solve tensors into the buffers, the epoch cache primed at x0,
        ``obj_star``, and the carry and histories reset (made on the
        first call)."""
        if self.buffers is not None:
            self.buffers.fill(prob, sm)
        method, reg_name, sm = self.method, self.reg_name, self.sm
        dt, dev = prob.dtype, prob.device
        scalar = lambda v: torch.tensor(v, dtype=dt, device=dev)
        count = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        self.use_fcache = epoch_cache_enabled(method, prob, reg_name, True)
        if self.use_fcache:
            # obj_star through the SAME evaluation path as the cached
            # fval: the kernel-accumulated loss and a separate reduction
            # differ by a few ulp-sums, and a mixed-path gap would inherit
            # that offset as a floor
            obj_star = (prime_glm_cache(method, prob, prob.x_star).loss
                        + prob.reg(reg_name, prob.x_star))
        else:
            obj_star = prob.obj(reg_name, prob.x_star)
        x0 = prob.x0
        lam, cw = _lam_scalar(prob.lam), _cw(prob, reg_name)
        # full-batch L-BFGS carries ∇q(x⁺) into the next epoch
        gq0 = (prob.grad_f(prob.A, prob.y, x0) + lam * sm.grad(x0, cw)
               if self.is_lbfgs else torch.zeros_like(x0))
        carry = Carry(
            x=x0, x_prev=x0, gq=gq0, gq_prev=torch.zeros_like(x0),
            d_prev=torch.zeros_like(x0), cg_total=count(torch.int64),
            bnorm_prev=scalar(float("nan")), frel=scalar(float("inf")),
            k=count(torch.int32), pri_res=scalar(float("nan")),
            done=count(torch.bool),
            mem=init_memory(x0.shape[-1],
                            method.m if self.is_lbfgs else 1, dt, dev),
            fcache=(prime_glm_cache(method, prob, x0) if self.use_fcache
                    else None))
        cap = self.opts.max_epoch + 1
        zeros = torch.zeros(cap, dtype=dt, device=dev)
        hist = History(fval=zeros, obj=zeros, rel=zeros, objrel=zeros,
                       prires=torch.full((cap,), float("nan"), dtype=dt,
                                         device=dev),
                       n_rec=count(torch.int32))
        if self.carry is None:
            self.carry, self.hist = _clone_tree(carry), _clone_tree(hist)
            self.obj_star = obj_star.clone()
        else:
            _assign(self.carry, carry)
            _assign(self.hist, hist)
            self.obj_star.copy_(obj_star)

    def live(self) -> torch.Tensor:
        c = self.carry
        return ~c.done & (c.k < self.opts.max_epoch)

    def record(self, prob: Problem) -> torch.Tensor:
        """One stats record at the carry's iterate, written at n_rec;
        returns the raw relative gap."""
        c, h = self.carry, self.hist
        fval, obj, rel, objrel, raw_frel = _stats(
            prob, self.reg_name, c.x, self.obj_star, self.opts.x_tol,
            self.opts.f_tol, c.fcache.loss if self.use_fcache else None)
        at = h.n_rec.reshape(1).long()
        for buf, v in zip(h[:5], (fval, obj, rel, objrel, c.pri_res)):
            buf.index_copy_(0, at, v.reshape(1).to(buf.dtype))
        h.n_rec.add_(1)
        return raw_frel

    def step_epoch(self, prob: Problem, raw_frel) -> None:
        c, method = self.carry, self.method
        it = c.k + 1  # 1-based like the reference epoch_t
        A, y = prob.A, prob.y
        if self.is_lbfgs:
            out = lbfgs_step(method, prob, self.reg_name, self.sm, A, y,
                             c.x, c.x_prev, c.gq_prev, it, c.mem,
                             gq_cached=c.gq)
        else:
            out = self.step(method, prob, self.reg_name, self.sm, A, y, c.x,
                            c.x_prev, it, d_prev=c.d_prev,
                            bnorm_prev=c.bnorm_prev, fcache=c.fcache,
                            gq_prev=c.gq_prev, mem=c.mem)
        x, x_tol = out.x_new, self.opts.x_tol
        conv = ((torch.linalg.vector_norm(x - c.x)
                 < x_tol * torch.clamp_min(torch.linalg.vector_norm(c.x),
                                           1.0))
                | (raw_frel <= self.opts.f_tol)
                | (out.pri_res_norm < x_tol))
        _assign(c, Carry(
            x=x, x_prev=c.x, gq=out.gq_new, gq_prev=out.gq, d_prev=out.d,
            cg_total=c.cg_total + out.cg_iters, bnorm_prev=out.bnorm,
            frel=raw_frel, k=c.k + 1, pri_res=out.pri_res_norm, done=conv,
            mem=out.mem, fcache=out.fcache))

    def gap_now(self, prob: Problem):
        """The per-epoch gap between stats rounds: exact from the cached
        loss (O(n)); off the cache the round's gap (a fresh one would
        cost a pass over A)."""
        c = self.carry
        if not self.use_fcache:
            return c.frel
        obj_now = c.fcache.loss + prob.reg(self.reg_name, c.x)
        return torch.abs(obj_now - self.obj_star) / torch.abs(self.obj_star)

    def round(self, prob: Problem) -> None:
        """The loop's body, one replay: behind ``live``, a stats record
        and an epoch, or with ``stats_every = K > 1`` a stats record and
        K epochs, each behind ``live`` again (a finished solve skips the
        rest of its round)."""
        K = self.opts.stats_every

        def body():
            raw_frel = self.record(prob)
            if K <= 1:
                self.step_epoch(prob, raw_frel)
                return
            self.carry.frel.copy_(raw_frel)
            for _ in range(K):
                device_if(self.live(), lambda: self.step_epoch(
                    prob, self.gap_now(prob)))

        device_if(self.live(), body)

    def finish(self, prob: Problem, t0: float) -> Solution:
        """The final record at the terminating iterate, then everything
        read back at once (one host read on the card)."""
        self.record(prob)
        c, h = self.carry, self.hist
        cap = h.fval.shape[0]
        packed = torch.cat([torch.stack(h[:5]).to(torch.float64).reshape(-1),
                            torch.stack([h.n_rec, c.k, c.cg_total]).to(
                                torch.float64)])
        if packed.device.type == "cuda":
            graph.host_read()
        packed = packed.cpu()
        n_rec, epochs, cg_total = (int(v) for v in packed[5 * cap:])
        cols = packed[:5 * cap].reshape(5, cap)[:, :n_rec].to(prob.dtype)
        x_out = c.x.clone()
        if prob.n_true is not None:
            x_out = x_out[..., : prob.n_true]  # drop feature padding
        times = torch.zeros(n_rec, dtype=torch.float64)
        times[-1] = time.perf_counter() - t0
        return Solution(
            x=x_out, obj=cols[1], fval=cols[0], pri_res_norm=cols[4],
            rel=cols[2], objrel=cols[3], times=times, epochs=epochs,
            model=prob,
            cg_info={"total_cg_iters": cg_total} if cg_total else None,
            state=_clone_tree(c))


class _Entry:
    """A cached captured solve: its loop and its graphs by name."""

    def __init__(self, loop, graphs: dict):
        self.loop, self.graphs = loop, graphs


def _capture_key(kind: str, method, prob: Problem, reg_name: str, sm,
                 opts: Options, refs: list):
    """What a captured graph depends on: the method, options (not
    verbose), smoother and problem — their data, specs and structure by
    identity (the objects appended to ``refs``), their per-solve
    tensors (`_Buffers`) by shape, dtype and device only."""
    def fields(obj, copied):
        out = [type(obj)]
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name in copied and isinstance(v, torch.Tensor):
                out.append((f.name, tuple(v.shape), v.dtype, str(v.device)))
            else:
                out.append((f.name, graph.identity_key(v, refs)))
        return tuple(out)

    return (kind, method, reg_name, dataclasses.replace(opts, verbose=0),
            fields(sm, _tensor_fields(sm)), fields(prob, _COPIED))


def _check_capturable(prob: Problem) -> None:
    """Raise before the first collective where a row-sharded solve cannot
    be captured: a gloo group reduces CUDA tensors through the host,
    which a capture refuses, and NCCL's collectives across two ranks or
    more made their graph fail to instantiate inside its conditional
    nodes (four H100s over NVLink). One NCCL rank captures. Timed mode
    runs either uncaptured."""
    if prob.mesh is None:
        return
    if dist.get_backend(prob.mesh.group) == "gloo":
        raise NotImplementedError(
            "a captured (mode='fused') solve on a row-sharded problem over "
            "gloo is not ported (ROADMAP A11): use mode='timed'")
    if prob.mesh.size > 1:
        raise NotImplementedError(
            "a captured (mode='fused') solve on a problem row-sharded over "
            "more than one rank is not ported (ROADMAP A11): NCCL's "
            "collectives inside the graph's conditional nodes fail to "
            "instantiate; use mode='timed'")


def _captured(kind: str, method, prob: Problem, reg_name: str, sm,
              opts: Options, make):
    """The cached capture of ``kind`` for this solve, or a new one:
    ``make(buffers, static_prob, static_sm)`` builds the loop on the
    static smoother, loads this solve (before any capture) and returns
    (loop, {name: fn}) of the bodies to capture on the static problem."""
    _check_capturable(prob)
    refs = []
    key = _capture_key(kind, method, prob, reg_name, sm, opts, refs)
    entry = graph.cached(key)
    if entry is not None:
        entry.loop.load(prob, sm)
        return entry
    buffers = _Buffers(prob, sm)
    loop, bodies = make(buffers, *buffers.static(prob, sm))
    entry = _Entry(loop, {name: graph.capture(fn, prob.device)
                          for name, fn in bodies.items()})
    graph.store(key, entry, refs)
    return entry


def _solve_captured(method, prob: Problem, reg_name: str, sm,
                    opts: Options, t0: float) -> Solution:
    def make(buffers, static, static_sm):
        loop = _Fused(method, reg_name, static_sm, opts, buffers)
        loop.load(prob, sm)
        return loop, {"round": lambda: loop.round(static)}

    entry = _captured("fused", method, prob, reg_name, sm, opts, make)
    loop = entry.loop
    _replays(entry.graphs["round"].replay, loop.live, loop.max_rounds)
    return loop.finish(prob, t0)


class _Timed:
    """The timed loop's state between epochs in fixed tensors: the
    iterate and what the step carries (the JAX package's Python loop
    variables), the epoch index, and what one stats record
    (:meth:`stats`) and one step (:meth:`step`) leave for the host to
    read. On a CUDA problem both are captured graphs, except on a row
    shard: there the step is the cached GGN-CG step (the only sharded
    step ported) and each record reads the cache's all-reduced loss."""

    def __init__(self, method, reg_name: str, sm, opts: Options,
                 buffers: Optional[_Buffers] = None):
        self.method, self.reg_name, self.sm, self.opts = (
            method, reg_name, sm, opts)
        self.buffers = buffers
        self.is_lbfgs = isinstance(method, ProxLQNSCORE)
        self.step_fn = make_step_fn(method)
        self.state = None
        self.cached = False

    def load(self, prob: Problem, sm) -> None:
        if self.buffers is not None:
            self.buffers.fill(prob, sm)
        dt, dev = prob.dtype, prob.device
        x0 = prob.x0
        lam, cw = _lam_scalar(prob.lam), _cw(prob, self.reg_name)
        # off the cache f(x) would be this rank's alone (`_check_sharded`
        # kept only the cached path for a row shard)
        self.cached = prob.mesh is not None
        if self.cached:
            obj_star = (prime_glm_cache(self.method, prob, prob.x_star).loss
                        + prob.reg(self.reg_name, prob.x_star))
        else:
            obj_star = prob.obj(self.reg_name, prob.x_star)
        gq0 = (prob.grad_f(prob.A, prob.y, x0) + lam * self.sm.grad(x0, cw)
               if self.is_lbfgs else torch.zeros_like(x0))
        state = _TimedState(
            x=x0, x_prev=x0, gq=gq0, gq_prev=torch.zeros_like(x0),
            d_prev=torch.zeros_like(x0),
            bnorm_prev=torch.tensor(float("nan"), dtype=dt, device=dev),
            mem=init_memory(x0.shape[-1],
                            self.method.m if self.is_lbfgs else 1, dt, dev),
            it=torch.zeros((), dtype=torch.int32, device=dev),
            obj_star=obj_star,
            stats=torch.zeros(5, dtype=dt, device=dev),
            check=torch.zeros(3, dtype=dt, device=dev),
            fcache=(prime_glm_cache(self.method, prob, x0) if self.cached
                    else None))
        if self.state is None:
            self.state = _clone_tree(state)
        else:
            _assign(self.state, state)

    def stats(self, prob: Problem) -> None:
        """(fval, obj, rel, objrel, raw gap) at x, into ``stats``."""
        st = self.state
        st.stats.copy_(torch.stack(_stats(
            prob, self.reg_name, st.x, st.obj_star, self.opts.x_tol,
            self.opts.f_tol, st.fcache.loss if self.cached else None)))

    def step(self, prob: Problem) -> None:
        """One step from x at epoch ``it``, as the JAX package's timed
        loop takes it (no epoch cache; on a row shard the cached step);
        (‖x⁺‖-test terms and the primal residual) into ``check``."""
        st, method = self.state, self.method
        A, y = prob.A, prob.y
        if self.is_lbfgs:
            out = lbfgs_step(method, prob, self.reg_name, self.sm, A, y,
                             st.x, st.x_prev, st.gq_prev, st.it, st.mem,
                             gq_cached=st.gq)
        else:
            out = self.step_fn(method, prob, self.reg_name, self.sm, A, y,
                               st.x, st.x_prev, st.it, d_prev=st.d_prev,
                               bnorm_prev=st.bnorm_prev,
                               gq_prev=st.gq_prev, mem=st.mem,
                               fcache=st.fcache)
        check = torch.stack([out.pri_res_norm,
                             torch.linalg.vector_norm(out.x_new - st.x),
                             torch.linalg.vector_norm(st.x)])
        _assign(st, st._replace(
            x=out.x_new, x_prev=st.x, gq=out.gq_new, gq_prev=out.gq,
            d_prev=out.d, bnorm_prev=out.bnorm, mem=out.mem, check=check,
            fcache=out.fcache if self.cached else None))


class _TimedState(NamedTuple):
    x: torch.Tensor
    x_prev: torch.Tensor
    gq: torch.Tensor
    gq_prev: torch.Tensor
    d_prev: torch.Tensor
    bnorm_prev: torch.Tensor
    mem: LBFGSMemory
    it: torch.Tensor        # the epoch index the next step takes (int32)
    obj_star: torch.Tensor
    stats: torch.Tensor     # (fval, obj, rel, objrel, raw gap)
    check: torch.Tensor     # (pri_res, ‖x⁺ − x‖, ‖x‖)
    fcache: Optional[GLMCache] = None  # a row shard's epoch cache


def _solve_timed(method, prob: Problem, reg_name: str, sm, opts: Options,
                 capture: bool, t0: float) -> Solution:
    """The JAX package's `_solve_python`: every epoch a stats record
    (one host read), its wall-clock time, the step (captured on the card
    off a row shard) and the stop test on the host (one read)."""
    if capture:
        def make(buffers, static, static_sm):
            loop = _Timed(method, reg_name, static_sm, opts, buffers)
            loop.load(prob, sm)
            return loop, {"stats": lambda: loop.stats(static),
                          "step": lambda: loop.step(static)}

        entry = _captured("timed", method, prob, reg_name, sm, opts, make)
        loop = entry.loop
        run_stats = entry.graphs["stats"].replay
        run_step = entry.graphs["step"].replay
    else:
        loop = _Timed(method, reg_name, sm, opts)
        loop.load(prob, sm)
        run_stats = lambda: loop.stats(prob)
        run_step = lambda: loop.step(prob)
    st = loop.state
    on_card = prob.device.type == "cuda"

    def read(t):
        if on_card:
            graph.host_read()
        return t.tolist()

    _, label = method.display()
    recs, times = [], []
    t_loop = time.perf_counter()
    epochs, pri, conv = 0, float("nan"), False

    def record():
        run_stats()
        fval, obj, rel, objrel, raw_frel = read(st.stats)
        recs.append((fval, obj, rel, objrel, pri))
        times.append(time.perf_counter() - t_loop)
        if opts.verbose > 1:
            print("-" * 32)
            print(f"Optimizer = {label}")
            print("\n".join([
                f"epoch = {epochs}", f"obj = {obj}", f"fval = {fval}",
                f"pri_res_norm = {pri}", f"rel_error = {rel}",
                f"\u0394time = {times[-1]:.3f}s"]))
        return raw_frel

    for epoch_t in range(1, opts.max_epoch + 1):
        raw_frel = record()
        st.it.fill_(epoch_t)
        run_step()
        pri, dxn, xn = read(st.check)
        conv = (dxn < opts.x_tol * max(xn, 1.0) or raw_frel <= opts.f_tol
                or pri < opts.x_tol)
        epochs += 1
        if conv:
            break
    record()
    if opts.verbose > 1:
        if conv:
            print("The algorithm terminated after a relative tolerance "
                  f"was reached at epoch {epochs}.")
        else:
            print("The algorithm reached its maximum number of epochs "
                  f"({opts.max_epoch}).")
    cols = torch.tensor(recs, dtype=prob.dtype).T
    x_out = st.x.clone()
    if prob.n_true is not None:
        x_out = x_out[..., : prob.n_true]  # drop feature padding
    return Solution(
        x=x_out, obj=cols[1], fval=cols[0], pri_res_norm=cols[4],
        rel=cols[2], objrel=cols[3],
        times=torch.tensor(times, dtype=torch.float64), epochs=epochs,
        model=prob)


def iterate(method, model: Problem, reg_name: str, h_mu, *, alpha=None,
            max_epoch=1000, x_tol=1e-10, f_tol=1e-10, verbose=1,
            stats_every=1, mode="fused", _capture=True,
            **unported) -> Solution:
    """Run a SCORE solve — the JAX package's ``iterate`` entry point for
    full-batch ProxNSCORE, ProxGGNSCORE and ProxLQNSCORE solves, in
    ``mode`` 'fused' or 'timed'. ``method=None`` runs ProxLQNSCORE(), the
    reference's intended default. ``_capture=False`` (private) runs a
    CUDA problem's graph bodies eagerly: the reference form of a
    captured solve, for checks on the card."""
    if unported:
        raise NotImplementedError(
            f"iterate options {sorted(unported)} are not ported yet "
            "(ROADMAP A7, A12)")
    if method is None:
        method = ProxLQNSCORE()
    opts = Options(max_epoch=max_epoch, x_tol=x_tol, f_tol=f_tol,
                   stats_every=stats_every, verbose=verbose, mode=mode)
    if verbose > 0 and method.ss_type == 1 and model.L is None \
            and alpha is None:
        print("Neither L nor alpha is set for the problem... "
              "Now fixing alpha = 0.5...")
    return solve(method, model, reg_name, h_mu, opts, alpha=alpha,
                 capture=_capture)
