"""The solve loop: epochs, mini-batches, histories and the Solution record.

Port of `scso_tpu.algorithms.iterate`, for ProxNSCORE, ProxGGNSCORE
(cached or uncached) and ProxLQNSCORE — the default method when
``method`` is None — on data problems and problems without data, in the
JAX package's two modes (``Options.mode``):

  * 'fused' (the default). The JAX package runs the solve as one jitted
    `lax.while_loop` over epochs. Here the loop's state lives in fixed
    tensors on the data's device (`_Fused`: the carry, and the histories
    preallocated with ``max_epoch + 1`` entries or more and a record
    counter, as the JAX package's `_init_hist` and `_record`), and one
    body updates them in place: with ``stats_every = 1`` a stats record
    and an epoch, with ``stats_every = K > 1`` a round (a stats record
    at a multiple of K epochs, then epochs up to the next multiple),
    behind ``live = ~done & (k < max_epoch)``, each epoch of a round
    behind its own (`graph.device_if`). On a CUDA problem the body is
    captured once into a CUDA graph, cached for the method, options
    (but ``max_epoch``, a buffer of its own), smoother, metrics and
    problem data (`_capture_key`), and replayed: the CG and Armijo loops
    inside it, and the loop over an epoch's mini-batches, are
    conditional nodes (`ops.linalg`, `graph.device_loop`), the host
    enqueues batches of replays and reads ``live`` once a batch (a
    replay past the end skips its body), then reads the results once.
    What changes from solve to solve (x0, x*, λ, L, the bounds, the
    smoother's μ, the budget, a resumed state, each epoch's permutation
    of the rows) is copied into the graph's buffers before its replays,
    and the cache is primed at x0 eagerly. On the CPU the same body runs
    as plain Python. Nothing is printed per epoch.
  * 'timed': the JAX package's `_solve_python`, the observability loop:
    a Python loop around the step with a stats record, a wall-clock time
    and a host stop test every epoch (every mini-batch), the metrics
    called on the host at each record, and the ``verbose > 1`` printing
    (``verbose > 2``: a tick a mini-batch). As there, GGN and Newton
    steps run without the epoch cache and full-batch L-BFGS carries its
    gradient. On a CUDA problem the step and the stats record are
    captured graphs too, replayed once an epoch (a mini-batch). On a
    row-sharded problem they run uncaptured (see below).

Mini-batches (``batch_size``, or ``slice_samples``: one row a batch;
``batch_size`` first) are the JAX package's `_make_batches`: ⌊m/bs⌋ full
batches of each epoch's permutation of the rows and a final partial one
of the remaining rows, each an uncached step (the epoch cache needs the
full batch), with the reference's per-batch stop test, which freezes the
epoch's remaining batches. Both modes draw each epoch's permutation on
the host, ``np.random.default_rng(rng_seed).permutation(m)`` (the JAX
package's timed mode; its fused mode draws with `jax.random`), so the
port's two modes take the same batches.

Stopping is the reference's triple test: ‖x⁺−x‖ < x_tol·max(‖x‖, 1),
relative objective gap ≤ f_tol, or primal residual < x_tol. Records are
taken at x_0 … plus a final record at the terminating iterate, with the
test loss f(Atest, ytest, x) and the metrics beside them. With the
epoch cache the f_tol test between records uses the exact per-epoch gap
(``gap_now``; off the cache, the round's gap). Off the cache a stats
record costs one f(x) pass over A.

``Solution.state`` is the whole carry (`Carry`: the iterate, the
gradient caches, the CG warm start and forcing reference, the L-BFGS
memory, the epoch cache, the epoch count, the histories and the state of
the permutations' generator); ``resume_state=`` continues from it bit
for bit as the uninterrupted solve would, in either mode (a fused
resume loads it into the captured graph's buffers and replays that
graph). `utils.checkpoint` saves and loads it.

A row-sharded problem (`parallel.shard_problem`) is solved SPMD, one
process per rank, by every method and option of a single solve: each
function of the rows is this rank's share summed over the ranks
(`Problem.f_val` and its siblings, the steps' packed all_reduces), and
every test reads replicated values, so all ranks take the same CG
iterations, line-search trials and epochs. Mini-batches are the
unsharded solve's (one permutation of all ranks' rows, drawn alike on
every rank); each rank steps on its rows of a batch, zero-padded to
min(batch size, its rows) so that the captured loop keeps its shapes
(`_Batches`, `Problem.rows`). Fused mode captures it over NCCL: on one
rank always, over more ranks where the communicator was made under
NCCL_GRAPH_MIXING_SUPPORT=0 (`Mesh.captures`; the collectives then sit
inside the graph's conditional nodes), and it raises without that
setting before any collective (`_check_capturable`); over gloo, which
reduces CUDA tensors through the host, it runs the same program
uncaptured (`_uncaptured`). Timed mode runs on any group,
uncaptured (`graph.eager`; the CG loop reads the card once an
iteration); where the epoch cache acts it takes the cached step and the
cache's loss in each record, so that its epochs are those of the fused
mode. A mesh may have more axes (the rows on its data axis), and the
problem may be feature-sharded (`parallel.shard_problem_features`,
alone or with a row shard on a ('data', 'model') mesh): every method
and option runs there too (mini-batches gather this rank's columns of
each batch's rows); what a capture refuses, and timed mode's uncaptured
run, follow the problem's mesh (`Problem.comm_mesh`) whichever axis it
shards.
"""

from __future__ import annotations

import dataclasses
import math
import time
from contextlib import nullcontext
from typing import Any, NamedTuple, Optional, Union

import numpy as np
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
from scso_tpu_torch.ops.cuda.graph import device_if, device_loop
from scso_tpu_torch.ops.dense import is_colshard
from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, init_memory
from scso_tpu_torch.problems import Problem, RowSet


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-solve configuration (the JAX package's Options).
    ``local_max_iter`` makes a solve one epoch over the first that many
    mini-batches (the reference's federated knob); ``vmap_safe`` is
    accepted and changes nothing here: the JAX package's where-mask
    stands in for a conditional that faults under vmap on a TPU, while
    this driver's conditional node already leaves a finished solve's
    carry as it is, and the batched solve (`batched`) masks its epochs
    whatever the flag says; ``comm_rounds`` is stored and unused, as in
    the reference."""

    max_epoch: int = 1000
    x_tol: float = 1e-10
    f_tol: float = 1e-10
    stats_every: int = 1  # record histories every K epochs (1 = parity)
    batch_size: Optional[int] = None
    slice_samples: bool = False
    shuffle_batch: bool = True
    local_max_iter: Optional[int] = None
    comm_rounds: int = 100
    verbose: int = 1
    mode: str = "fused"   # 'fused' (captured device loop) | 'timed'
    vmap_safe: bool = False


class History(NamedTuple):
    """The records: buffers with room for ``max_epoch + 1`` entries or
    more (``metrics``: one row a metric) and the count ``n_rec`` written
    so far."""

    fval: torch.Tensor
    obj: torch.Tensor
    rel: torch.Tensor
    objrel: torch.Tensor
    prires: torch.Tensor
    fvaltest: torch.Tensor    # zeros without a test set
    metrics: torch.Tensor     # (n_metrics, cap)
    n_rec: torch.Tensor       # int32


class Carry(NamedTuple):
    """Solver state between epochs (the JAX while_loop carry), and
    ``Solution.state``: every field a tensor on the data's device but
    ``rng``, the state of the permutations' generator (CPU int64)."""

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
    hist: History
    rng: torch.Tensor         # `_rng_pack` of the generator


@dataclasses.dataclass
class Solution:
    """Result record; field names mirror the JAX package's Solution.
    Histories are CPU tensors (``metricvals``: name → tensor,
    ``fvaltest`` empty without a test set); ``x`` (sliced back to
    ``n_true``) stays on the problem's device, and ``state`` (a
    :class:`Carry`, copied out of the loop's buffers) keeps the padded
    iterate ``state.x`` for a warm start and resumes the solve
    (``iterate(..., resume_state=sol.state)``). Fused mode reports the
    total wall clock in ``times[-1]``, timed mode one time a record."""

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
    fvaltest: Any = None
    metricvals: dict = dataclasses.field(default_factory=dict)

    def __repr__(self):
        obj = float(self.obj[-1]) if len(self.obj) else float("nan")
        rel = float(self.rel[-1]) if len(self.rel) else float("nan")
        return (f"Solution(epochs={self.epochs}, obj={obj:.6e}, "
                f"rel={rel:.3e}, n={self.x.shape[-1]})")


def _stats(prob: Problem, reg_name: str, x, obj_star, x_tol, f_tol,
           fval=None):
    """One record: (fval, obj, rel, objrel, raw_frel, fvaltest), all 0-d
    tensors. ``fval`` is the cached data loss when the epoch cache
    carries one; None evaluates f(x), one pass over A (on a row shard
    this rank's share, summed over the ranks). ``fvaltest`` is f on the
    test set (its rows of all ranks on a shard), zero without one."""
    if fval is None:
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
    fvaltest = (prob.f_val(prob.Atest, prob.ytest, x) if prob.has_test
                else torch.zeros_like(fval))
    return fval, obj, rel, objrel, raw_frel, fvaltest


def _record(prob: Problem, reg_name: str, opts: Options, x, obj_star,
            loss, pri_res):
    """A stats record at x: the six values of `History` in its order
    (fval, obj, rel, objrel, prires, fvaltest) and the raw relative gap.
    ``loss`` is the epoch cache's, or None (`_stats`). The fused loop
    and the batched solve (`batched`, under vmap) both write this."""
    fval, obj, rel, objrel, raw_frel, ftst = _stats(
        prob, reg_name, x, obj_star, opts.x_tol, opts.f_tol, loss)
    return (fval, obj, rel, objrel, pri_res, ftst), raw_frel


def _gap(prob: Problem, reg_name: str, x, loss, obj_star):
    """The relative gap at x from the epoch cache's loss (O(n))."""
    obj_now = loss + prob.reg(reg_name, x)
    return torch.abs(obj_now - obj_star) / torch.abs(obj_star)


def _stopped(x_new, x, raw_frel, pri_res, opts: Options):
    """An epoch's stop test on its last step, x → x_new: the iterate
    settled (relative to max(‖x‖, 1)), the gap within f_tol, or the
    primal residual under x_tol."""
    x_tol = opts.x_tol
    return ((torch.linalg.vector_norm(x_new - x)
             < x_tol * torch.clamp_min(torch.linalg.vector_norm(x), 1.0))
            | (raw_frel <= opts.f_tol)
            | (pri_res < x_tol))


def _step_carry(method, step, prob: Problem, reg_name: str, sm,
                opts: Options, As, ys, c, it, raw_frel, use_fcache: bool,
                gq_cached=None):
    """One step of a solve on the rows (As, ys) from the carry ``c`` (a
    `Carry`, or one instance's state in the batched solve): (the
    carry's new fields, the step's stop test). ``step`` is
    ``make_step_fn(method)``; L-BFGS takes ``gq_cached``."""
    if isinstance(method, ProxLQNSCORE):
        out = lbfgs_step(method, prob, reg_name, sm, As, ys, c.x, c.x_prev,
                         c.gq_prev, it, c.mem, gq_cached=gq_cached)
    else:
        out = step(method, prob, reg_name, sm, As, ys, c.x, c.x_prev, it,
                   d_prev=c.d_prev, bnorm_prev=c.bnorm_prev,
                   fcache=c.fcache if use_fcache else None,
                   gq_prev=c.gq_prev, mem=c.mem)
    conv = _stopped(out.x_new, c.x, raw_frel, out.pri_res_norm, opts)
    return dict(
        x=out.x_new, x_prev=c.x, gq=out.gq_new, gq_prev=out.gq, d_prev=out.d,
        cg_total=c.cg_total + out.cg_iters, bnorm_prev=out.bnorm,
        pri_res=out.pri_res_norm, mem=out.mem,
        fcache=out.fcache if use_fcache else None), conv


def _metric_values(prob: Problem, x, metric_fns):
    """The metrics at x as one tensor (n_metrics,) in x's dtype: each a
    torch function ``fn(prob, x)`` returning a 0-d tensor (in fused mode
    it runs inside the captured graph)."""
    if not metric_fns:
        return torch.zeros((0,), dtype=x.dtype, device=x.device)
    vals = []
    for fn in metric_fns:
        v = fn(prob, x)
        if not isinstance(v, torch.Tensor):
            raise TypeError(
                "a metric in mode='fused' must return a 0-d tensor on the "
                f"problem's device, not {type(v).__name__}; a host "
                "function runs in mode='timed'")
        vals.append(v.reshape(()).to(x.dtype))
    return torch.stack(vals)


def _resolve_kernels(method, prob: Problem):
    """'auto' → 'cuda' for a problem on a CUDA device, 'torch' otherwise.
    'cuda' on a problem that is not on a CUDA device raises. On a column
    shard 'cuda' launches K3 and K4; the steps take the products route
    in place of K1, K1s, K2, K2s and K5 there (`steps._kernel`)."""
    on_cuda = prob.device.type == "cuda"
    if method.kernels == "auto":
        return dc_replace(method, kernels="cuda" if on_cuda else "torch")
    if method.kernels == "cuda" and not on_cuda:
        raise ValueError(
            f"kernels='cuda' needs the problem's data on a CUDA device; it "
            f"is on {prob.device} (use kernels='torch' or 'auto')")
    return method


def _check_sharded(method, prob: Problem, reg_name: str,
                   opts: Optional[Options] = None):
    """Every method and option of a single solve runs on a row shard (a
    mesh of any axes, the rows on ``data_axis``), on a column shard and
    on both (a 2-D ('data', 'model') mesh). What does not fit raises
    here, the same on every rank, before the first collective: ranks
    that parted at a collective would wait for each other forever."""
    mesh = prob.mesh
    if mesh is not None and prob.data_axis not in mesh.axis_names:
        raise ValueError(f"the problem's rows are on axis "
                         f"{prob.data_axis!r}, which is not in the mesh's "
                         f"{tuple(mesh.axis_names)}")
    if is_colshard(prob.A) and mesh is not None and prob.A.mesh is not mesh:
        raise ValueError("a problem's rows and columns shard over one "
                         "mesh (shard_problem, then shard_problem_features "
                         "on the same mesh)")


def _effective_L(prob: Problem, alpha):
    """The alpha kwarg overrides L as L = 1/alpha."""
    if alpha is not None:
        return dc_replace(prob, L=torch.tensor(1.0 / alpha, dtype=prob.dtype,
                                               device=prob.device))
    return prob


def _make_batches(prob: Problem, opts: Options):
    """(full batches, batch size, rows of the partial last batch), or
    None for a full-batch solve: ``batch_size`` first, else one row a
    batch under ``slice_samples``; a batch size of m rows or more is the
    full batch (the JAX package's `_make_batches`). ``local_max_iter``
    truncates an epoch's list of batches to its first that many, where
    the partial batch counts as the last entry of the list."""
    if not prob.has_data:
        return None
    m = prob.m_total  # all ranks' rows on a row shard
    bs = opts.batch_size
    if bs is None and opts.slice_samples:
        bs = 1
    if bs is None or bs >= m:
        return None
    if bs < 1:
        raise ValueError(f"batch_size must be positive, got {bs}")
    nb, rem = divmod(m, bs)
    cap = opts.local_max_iter
    if cap is not None and int(cap) > 0 and int(cap) <= nb:
        nb, rem = int(cap), 0  # the partial batch is truncated away too
    return nb, bs, rem


_U64 = (1 << 64) - 1


def _rng_pack(gen: np.random.Generator) -> torch.Tensor:
    """The state of a PCG64 generator (numpy's default) as six int64
    words: state and increment (high, low 64 bits), has_uint32,
    uinteger."""
    st = gen.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"the permutations' generator is PCG64, not "
                         f"{st['bit_generator']}")
    words = []
    for v in (st["state"]["state"], st["state"]["inc"]):
        words += [(v >> 64) & _U64, v & _U64]
    words += [int(st["has_uint32"]), int(st["uinteger"])]
    return torch.tensor([w - (1 << 64) if w >= (1 << 63) else w
                         for w in words], dtype=torch.int64)


def _rng_unpack(t: torch.Tensor) -> np.random.Generator:
    """The generator of a `_rng_pack` state."""
    w = [int(v) & _U64 for v in t.reshape(-1).tolist()]
    bg = np.random.PCG64()
    bg.state = {"bit_generator": "PCG64",
                "state": {"state": (w[0] << 64) | w[1],
                          "inc": (w[2] << 64) | w[3]},
                "has_uint32": int(w[4]), "uinteger": int(w[5])}
    return np.random.Generator(bg)


def _refit_history(h: History, cap: int) -> History:
    """Every buffer of ``h`` refit to ``cap`` entries: padded with the
    field's fill (NaN for prires, 0 elsewhere) or truncated."""
    def fit(a, fill=0.0):
        pad = cap - a.shape[-1]
        if pad > 0:
            return torch.cat([a, torch.full(a.shape[:-1] + (pad,), fill,
                                            dtype=a.dtype, device=a.device)],
                             dim=-1)
        return a[..., :cap]

    return h._replace(fval=fit(h.fval), obj=fit(h.obj), rel=fit(h.rel),
                      objrel=fit(h.objrel),
                      prires=fit(h.prires, float("nan")),
                      fvaltest=fit(h.fvaltest), metrics=fit(h.metrics))


def _new_history(cap: int, n_metrics: int, dt, dev) -> History:
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    return History(
        fval=zeros(cap), obj=zeros(cap), rel=zeros(cap), objrel=zeros(cap),
        prires=torch.full((cap,), float("nan"), dtype=dt, device=dev),
        fvaltest=zeros(cap), metrics=zeros(n_metrics, cap),
        n_rec=torch.zeros((), dtype=torch.int32, device=dev))


def _on(t, like: torch.Tensor):
    """``t`` as a tensor on ``like``'s device (a resumed state may come
    from a checkpoint or another device)."""
    return torch.as_tensor(t).to(like.device)


def _resume_tree(tree, like):
    """The tensors of ``tree`` moved to ``like``'s device."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or not isinstance(tree, tuple):
        return _on(tree, like)
    items = [_resume_tree(t, like) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


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


def _auto_lp(method, prob: Problem, reg_name: str = "l1",
             opts: Optional[Options] = None):
    """Resolve ProxGGNSCORE.auto_lp: maybe attach a bfloat16 copy of A
    and set cg_lp_tol to the CG floor (precision-adaptive CG through the
    bulk epochs, float32 once the endgame tightens past the floor).

    The JAX package's gates, in its order: ProxGGNSCORE; no explicit
    cg_lp_tol, no cg_adaptive, no curvature_rows; a 2-D data problem
    without a copy yet; a float32 GLM or multi-output GLM; full batches
    (no ``batch_size`` or ``slice_samples`` in ``opts``: a batch has no
    copy of its rows); the resolved solver 'cg'; a row mesh
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
    if is_colshard(prob.A):
        return method, prob  # no copy on a column shard, as in the JAX package
    if ((prob.glm is None and prob.mglm is None)
            or prob.x0.dtype != torch.float32):
        return method, prob
    if opts is not None and (opts.batch_size is not None
                             or opts.slice_samples):
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
          metric_fns: tuple = (), metric_names: tuple = (), alpha=None,
          rng_seed: int = 0, resume_state=None,
          capture: bool = True) -> Solution:
    """Run one solve; returns a :class:`Solution`. ``metric_fns`` are
    recorded beside the histories under ``metric_names``;
    ``resume_state`` (a ``Solution.state``, or a checkpoint loaded onto
    one) continues that solve. ``capture=False`` runs the CUDA graphs'
    bodies eagerly instead (`graph.eager`): the reference form of a
    captured solve, for checks on the card."""
    if not isinstance(method, (ProxNSCORE, ProxGGNSCORE, ProxLQNSCORE)):
        raise TypeError(f"unknown method {method!r}")
    if opts.mode not in ("fused", "timed"):
        raise ValueError(f"mode must be 'fused' or 'timed', not "
                         f"{opts.mode!r}")
    if opts.local_max_iter is not None:
        # one local round: a single epoch over the truncated batch list
        # (`_make_batches`), the JAX package's rule
        opts = dataclasses.replace(opts, max_epoch=1)
    if len(metric_fns) != len(metric_names):
        raise ValueError("one name a metric")
    prob = _effective_L(prob, alpha)
    method = _resolve_kernels(method, prob)
    method, prob = _auto_lp(method, prob, reg_name, opts)
    _check_sharded(method, prob, reg_name, opts)
    return _solve_impl(method, prob, reg_name, sm, opts, tuple(metric_fns),
                       tuple(metric_names), rng_seed, resume_state, capture)


def _solve_impl(method, prob: Problem, reg_name: str, sm, opts: Options,
                metric_fns=(), metric_names=(), rng_seed: int = 0,
                resume_state=None, capture: bool = True) -> Solution:
    """The solve of a resolved method (`solve` after its checks). Timed
    mode on a row shard runs uncaptured: a gloo group, or NCCL without
    NCCL_GRAPH_MIXING_SUPPORT=0, cannot put its collectives in a captured
    graph's conditional nodes (`_check_capturable`). So does the fused
    mode over gloo on the card (`_uncaptured`), and every solve under
    `utils.debug.sanitize`."""
    t0 = time.perf_counter()
    on_card = prob.device.type == "cuda"
    timed = opts.mode == "timed"
    if ((timed and prob.comm_mesh is not None) or nancheck.uncaptured()
            or _uncaptured(prob)):
        capture = False
    run = _Run(metric_fns, metric_names, rng_seed, resume_state)
    eager = graph.eager() if on_card and not capture else nullcontext()
    with eager:
        if timed:
            return _solve_timed(method, prob, reg_name, sm, opts, run,
                                on_card and capture, t0)
        if on_card and capture:
            return _solve_captured(method, prob, reg_name, sm, opts, run,
                                   t0)
        loop = _Fused(method, reg_name, sm, opts, run.metric_fns,
                      opts.max_epoch + 1)
        loop.load(prob, sm, run)
        _replays(loop.round_of(lambda: loop.round(prob)), loop.live,
                 loop.max_rounds)
        return loop.finish(prob, t0, run)


def solve_program(method, prob: Problem, reg_name: str, sm, opts: Options,
                  perms: Optional[torch.Tensor] = None):
    """The fused solve of a resolved method as one program, for
    ``torch.export`` (`utils.deploy.export_solver`, under
    `graph.export_trace`): the loop of :class:`_Fused` that a captured
    solve replays, its rounds one ``while_loop`` on ``live`` whose carry
    is the loop's state (the iterate, the epoch count, the histories, the
    epoch cache, the L-BFGS memory), then the final record. Returns the
    JAX package's serving triple (x sliced to ``n_true``, the epochs, the
    final objective). A program cannot draw on the host: a mini-batch
    solve reads epoch k's permutation of the rows from row k of
    ``perms`` ((max_epoch, m) int64, drawn as `_Batches` draws them,
    `utils.deploy.permutations`), and raises ValueError without it."""
    if (_make_batches(prob, opts) is None) != (perms is None):
        raise ValueError(
            "solve_program: a mini-batch solve takes each epoch's "
            "permutation of the rows (perms), a full-batch solve none")
    loop = _Fused(method, reg_name, sm, opts)
    loop.load(prob, sm, perms=perms)
    live = loop.live()

    def rounds():
        loop.round(prob)
        live.copy_(loop.live())

    device_loop(live, loop.max_rounds, rounds, state=loop.state())
    loop.record(prob)
    c, h = loop.carry, loop.hist
    obj = h.obj.index_select(0, (h.n_rec.long() - 1).reshape(1))
    x = c.x if prob.n_true is None else c.x[..., : prob.n_true]
    return x.clone(), c.k.clone(), obj.reshape(())


class _Run(NamedTuple):
    """What a solve adds to its method, problem and options."""

    metric_fns: tuple
    metric_names: tuple
    rng_seed: int
    resume: Any


_NO_RUN = _Run((), (), 0, None)

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
        # on the problem's device: a smoother's bounds may be made on the
        # host, and a capture refuses to copy them over each replay
        self.sm = {name: torch.empty_like(t, device=prob.device)
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
    storage with any buffer is cloned before the first copy (under
    export, whose traced tensors have no storage to compare, every one
    is)."""
    dsts, srcs = _leaves(dst), _leaves(src)
    if len(dsts) != len(srcs):
        raise ValueError("the carry changed its structure")
    if graph.exporting():
        pairs = [(d, s.clone()) for d, s in zip(dsts, srcs) if s is not d]
        for d, s in pairs:
            d.copy_(s)
        return
    ptrs = {d.untyped_storage().data_ptr() for d in dsts}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in ptrs
              else s) for d, s in zip(dsts, srcs) if s is not d]
    for d, s in pairs:
        d.copy_(s)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU (one host read on the card)."""
    if t.device.type == "cuda":
        graph.host_read()
    return t.cpu()


def _copy_rows(dst: torch.Tensor, src) -> None:
    """``src`` (a numpy array) into the device buffer ``dst``: on the
    card from pinned memory, ordered on the stream after the replays
    enqueued before it."""
    src = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def _resumed_cache(method, prob: Problem, x, saved):
    """The epoch cache of a resumed solve: the saved one where its shapes
    fit this problem, else primed afresh at the resumed iterate."""
    m = prob.A.shape[0]
    if prob.mglm is not None:
        ok = (isinstance(saved, tuple) and len(saved) == 4
              and tuple(saved[0].shape) == (m, int(prob.mglm.n_out)))
        cls = MOGLMCache
    else:
        ok = (isinstance(saved, tuple) and len(saved) == 4
              and tuple(saved[0].shape) == (m,))
        cls = GLMCache
    if ok:
        return cls(*_resume_tree(tuple(saved), x))
    return prime_glm_cache(method, prob, x)


def _take(A, rows, out) -> None:
    """The rows ``rows`` of A into the buffer ``out`` (of a column
    shard, its block's)."""
    if is_colshard(A):
        A, out = A.block, out.block
    torch.index_select(A, 0, rows, out=out)


class _Batches:
    """The buffers of a mini-batch solve on the data's device: the rows'
    permutation of each epoch of a round (``perm``, one row a slot,
    epoch k in slot k mod K) and the gathered rows of a full batch and
    of the partial last batch; and, on the host, the generator of the
    permutations with its state after each epoch's draw (``snaps``), so
    that a solve's state holds the generator as its last epoch left it,
    whatever was drawn ahead for replays past the end.

    On a row shard the permutation is of all ranks' rows, drawn alike on
    every rank, so the batches are the unsharded solve's. A rank holds a
    number of each batch's rows that varies from batch to batch, while a
    captured loop needs fixed shapes: each rank's rows of a batch are
    gathered in the permutation's order into a buffer of min(batch size,
    its rows) rows — as many as it can ever own — and the rest is zero
    rows. A zero row adds nothing to K1's product, the RHS Aᵀρ or the
    diagonal Σ wA², but it does to a loss (ℓ(y, 0) = ln 2 for
    logistic01): the step reads the pad count and a row mask
    (`Problem.rows`), which take each pad row's share out of f and its
    derivatives and zero it in the per-row forms (`Problem.share`,
    `Problem.row_form`). The host works out each slot's local row
    indices, mask and pad count as it draws the permutation (``fill``);
    on one rank they are the permutation itself, with no pad."""

    def __init__(self, prob: Problem, batching, slots: int):
        nb, bs, rem = batching
        A, y, dev = prob.A, prob.y, prob.device
        m = prob.m_total
        self.batching, self.m, self.mesh = batching, m, prob.mesh
        self.by_epoch = False
        self.bi = torch.zeros((), dtype=torch.int64, device=dev)
        self.blive = torch.zeros((), dtype=torch.bool, device=dev)
        full, rest = bs, rem
        if self.mesh is None:
            self.perm = torch.empty((slots, m), dtype=torch.int64,
                                    device=dev)
        else:
            m_r = A.shape[0]
            self.lo = self.mesh.axis_rank(prob.data_axis) * m_r
            self.m_r = m_r
            full, rest = min(bs, m_r), min(rem, m_r)
            index = lambda *shape: torch.zeros(shape, dtype=torch.int64,
                                               device=dev)
            keep = lambda *shape: torch.zeros(shape, dtype=torch.bool,
                                              device=dev)
            self.idx, self.keep, self.npad = (
                index(slots, nb, full), keep(slots, nb, full),
                index(slots, nb))
            self.ridx, self.rkeep, self.rnpad = (
                index(slots, rest), keep(slots, rest), index(slots))
            mask = lambda r: torch.zeros((r,), dtype=prob.dtype, device=dev)
            self.mb, self.pb = mask(full), index()
            self.mr, self.pr = mask(rest), index()
        if is_colshard(A):
            # a column shard's batch: the rows of this rank's columns
            self.Ab = A.with_block(A.block.new_empty((full, A.width)))
            self.Ar = A.with_block(A.block.new_empty((rest, A.width)))
        else:
            self.Ab = A.new_empty((full,) + tuple(A.shape[1:]))
            self.Ar = A.new_empty((rest,) + tuple(A.shape[1:]))
        self.yb = y.new_empty((full,) + tuple(y.shape[1:]))
        self.yr = y.new_empty((rest,) + tuple(y.shape[1:]))
        self.gen, self.snaps, self.k_host = None, {}, 0

    @property
    def slots(self) -> int:
        return (self.perm if self.mesh is None else self.idx).shape[0]

    def given(self, perms: torch.Tensor) -> None:
        """Every epoch's permutation given, epoch k's in row k (an
        exported program's input): nothing is drawn on the host."""
        self.perm, self.by_epoch = perms, True

    def start(self, rng: torch.Tensor, k0: int, shuffle: bool) -> None:
        self.gen = _rng_unpack(rng)
        self.snaps = {k0: rng.clone()}
        self.k_host, self.shuffle = k0, shuffle
        if not shuffle:
            self.fill(0, np.tile(np.arange(self.m), (self.slots, 1)))

    def fill(self, lo: int, perms: np.ndarray) -> None:
        """The permutations ``perms`` (one row an epoch) into the slots
        from ``lo``; on a row shard this rank's rows of each batch."""
        if self.mesh is None:
            _copy_rows(self.perm[lo:lo + len(perms)], perms)
            return
        nb, bs, rem = self.batching
        k = len(perms)

        def local(rows, width):
            # this rank's rows of each batch, in the permutation's order
            # (a stable sort puts them first), then zero-row pads
            own = (rows >= self.lo) & (rows < self.lo + self.m_r)
            order = np.argsort(~own, axis=-1, kind="stable")[..., :width]
            kept = np.take_along_axis(own, order, -1)
            idx = np.where(kept, np.take_along_axis(rows, order, -1)
                           - self.lo, 0)
            return idx, kept, width - kept.sum(-1)

        at = slice(lo, lo + k)
        for dst, src in zip((self.idx, self.keep, self.npad), local(
                perms[:, :nb * bs].reshape(k, nb, bs), self.idx.shape[-1])):
            _copy_rows(dst[at], src)
        if rem:
            for dst, src in zip((self.ridx, self.rkeep, self.rnpad), local(
                    perms[:, nb * bs:nb * bs + rem], self.ridx.shape[-1])):
                _copy_rows(dst[at], src)

    def draw(self, upto: int) -> None:
        """The permutations of the epochs from ``k_host`` to ``upto``
        (exclusive), into their slots (one contiguous run of slots)."""
        if not self.shuffle or upto <= self.k_host:
            return
        perms = []
        for k in range(self.k_host, upto):
            perms.append(self.gen.permutation(self.m))
            self.snaps[k + 1] = _rng_pack(self.gen)
        self.fill(self.k_host % self.slots, np.stack(perms))
        self.k_host = upto

    def rng_at(self, k: int, initial: torch.Tensor) -> torch.Tensor:
        return self.snaps.get(k, initial).clone()

    def rows(self, slot):
        """The epoch in ``slot`` (an int, or a 0-d tensor on the data's
        device): its permutation, or on a row shard this rank's rows of
        its batches (indices, kept, pad counts; the partial batch's)."""
        if isinstance(slot, int):
            pick = lambda t: t[slot]
        else:
            at = slot.reshape(1).long()
            pick = lambda t: t.index_select(0, at)[0]
        if self.mesh is None:
            return pick(self.perm)
        return tuple(pick(t) for t in (self.idx, self.keep, self.npad,
                                       self.ridx, self.rkeep, self.rnpad))

    def _gather(self, prob: Problem, rows, kept, npad, A, y, mask, pad,
                total: int):
        """This rank's rows ``rows`` of A and y into the buffers (A, y),
        the pad rows zeroed: (the problem that reads them, A, y)."""
        _take(prob.A, rows, A)
        torch.index_select(prob.y, 0, rows, out=y)
        drop = ~kept
        blk = A.block if is_colshard(A) else A
        blk.masked_fill_(drop.reshape((-1,) + (1,) * (blk.ndim - 1)), 0)
        y.masked_fill_(drop.reshape((-1,) + (1,) * (y.ndim - 1)), 0)
        mask.copy_(kept)
        pad.copy_(npad.reshape(()))
        view = dc_replace(prob, rows=RowSet(A=A, y=y, total=total, pad=pad,
                                            mask=mask))
        return view, A, y

    def gather_full(self, prob: Problem, epoch):
        """Batch ``bi`` of ``epoch`` into (Ab, yb): (the problem its step
        reads, Ab, yb)."""
        nb, bs, _ = self.batching
        b = self.bi.reshape(1)
        if self.mesh is None:
            rows = epoch[:nb * bs].view(nb, bs).index_select(0, b).reshape(-1)
            _take(prob.A, rows, self.Ab)
            torch.index_select(prob.y, 0, rows, out=self.yb)
            return prob, self.Ab, self.yb
        idx, keep, npad = epoch[:3]
        return self._gather(
            prob, idx.index_select(0, b).reshape(-1),
            keep.index_select(0, b).reshape(-1), npad.index_select(0, b),
            self.Ab, self.yb, self.mb, self.pb, bs)

    def gather_rest(self, prob: Problem, epoch):
        """The partial last batch of ``epoch`` into (Ar, yr): (the
        problem its step reads, Ar, yr)."""
        nb, bs, rem = self.batching
        if self.mesh is None:
            rows = epoch[nb * bs:]
            _take(prob.A, rows, self.Ar)
            torch.index_select(prob.y, 0, rows, out=self.yr)
            return prob, self.Ar, self.yr
        return self._gather(prob, *epoch[3:], self.Ar, self.yr, self.mr,
                            self.pr, rem)


class _Fused:
    """The fused solve's loop: its carry and histories live in fixed
    tensors, and :meth:`round` (one replay of the captured graph) updates
    them in place. :meth:`load` starts a solve, :meth:`finish` reads it
    out. ``sm`` is the smoother the loop steps with: a captured loop's
    reads ``buffers`` (`_Buffers`, filled at each load; None where each
    solve's own problem and smoother are read: on the CPU and in the
    eager form). ``cap`` is the histories' room, at least ``max_epoch +
    1`` of every solve the loop runs."""

    def __init__(self, method, reg_name: str, sm, opts: Options,
                 metric_fns: tuple = (), cap: Optional[int] = None,
                 buffers: Optional[_Buffers] = None):
        self.method, self.reg_name, self.sm, self.opts = (
            method, reg_name, sm, opts)
        self.metric_fns, self.buffers = metric_fns, buffers
        self.cap = opts.max_epoch + 1 if cap is None else cap
        self.is_lbfgs = isinstance(method, ProxLQNSCORE)
        self.step = make_step_fn(method)
        self.K = max(opts.stats_every, 1)
        self.carry = self.obj_star = self.use_fcache = None
        self.batching = self.batches = self.max_epoch = None
        self.max_rounds = 0

    @property
    def hist(self) -> History:
        return self.carry.hist

    def load(self, prob: Problem, sm, run: Optional[_Run] = None,
             max_epoch: Optional[int] = None,
             perms: Optional[torch.Tensor] = None) -> None:
        """Start a solve of ``prob`` with smoother ``sm``, eagerly: their
        per-solve tensors into the buffers, the epoch cache primed at x0,
        ``obj_star``, and the carry and histories reset, or loaded from
        ``run.resume`` (made on the first call). ``perms``: every epoch's
        permutation of the rows, given (`solve_program`)."""
        run = _NO_RUN if run is None else run
        if self.buffers is not None:
            self.buffers.fill(prob, sm)
        method, reg_name, sm = self.method, self.reg_name, self.sm
        dev = prob.device
        max_epoch = self.opts.max_epoch if max_epoch is None else max_epoch
        self.batching = _make_batches(prob, self.opts)
        self.use_fcache = epoch_cache_enabled(method, prob, reg_name,
                                              self.batching is None)
        if self.use_fcache:
            # obj_star through the SAME evaluation path as the cached
            # fval: the kernel-accumulated loss and a separate reduction
            # differ by a few ulp-sums, and a mixed-path gap would inherit
            # that offset as a floor
            obj_star = (prime_glm_cache(method, prob, prob.x_star).loss
                        + prob.reg(reg_name, prob.x_star))
        else:
            obj_star = prob.obj(reg_name, prob.x_star)
        if run.resume is None:
            carry = self._fresh(prob, sm, run.rng_seed)
        else:
            carry = self._resumed(prob, run.resume)
        if self.carry is None:
            self.carry = _clone_tree(carry)
            self.obj_star = obj_star.clone()
            self.max_epoch = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            _assign(self.carry, carry)
            self.obj_star.copy_(obj_star)
        self.max_epoch.fill_(max_epoch)
        k0 = 0 if run.resume is None else int(_to_host(self.carry.k))
        self.max_rounds = math.ceil(max(max_epoch - k0, 0) / self.K) + 1
        if self.batching is not None:
            if self.batches is None:
                self.batches = _Batches(prob, self.batching, self.K)
            if perms is not None:
                self.batches.given(perms)
            else:
                self.batches.start(self.carry.rng, k0,
                                   self.opts.shuffle_batch)

    def _fresh(self, prob: Problem, sm, rng_seed: int) -> Carry:
        dt, dev = prob.dtype, prob.device
        scalar = lambda v: torch.tensor(v, dtype=dt, device=dev)
        count = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        x0 = prob.x0
        lam, cw = _lam_scalar(prob.lam), _cw(prob, self.reg_name)
        # full-batch L-BFGS carries ∇q(x⁺) into the next epoch
        cache_grads = self.is_lbfgs and self.batching is None
        gq0 = (prob.grad_f(prob.A, prob.y, x0) + lam * sm.grad(x0, cw)
               if cache_grads else torch.zeros_like(x0))
        return Carry(
            x=x0, x_prev=x0, gq=gq0, gq_prev=torch.zeros_like(x0),
            d_prev=torch.zeros_like(x0), cg_total=count(torch.int64),
            bnorm_prev=scalar(float("nan")), frel=scalar(float("inf")),
            k=count(torch.int32), pri_res=scalar(float("nan")),
            done=count(torch.bool),
            mem=init_memory(x0.shape[-1],
                            self.method.m if self.is_lbfgs else 1, dt, dev),
            fcache=(prime_glm_cache(self.method, prob, x0)
                    if self.use_fcache else None),
            hist=_new_history(self.cap, len(self.metric_fns), dt, dev),
            rng=_rng_pack(np.random.default_rng(rng_seed)))

    def _resumed(self, prob: Problem, r) -> Carry:
        """The carry of a resumed solve, from a saved one: the saved
        run's final record is this run's next one, so the record count
        steps back by one (the JAX package's rule); histories refit to
        ``cap``; the epoch cache is the saved one, or primed at x."""
        x = _on(r.x, prob.x0).to(prob.dtype)
        h = _resume_tree(r.hist, x)
        if h.metrics.shape[0] != len(self.metric_fns):
            raise ValueError(
                f"the resumed state records {h.metrics.shape[0]} metrics; "
                f"this solve has {len(self.metric_fns)}")
        h = _refit_history(h, self.cap)._replace(
            n_rec=torch.clamp_min(h.n_rec.to(torch.int32) - 1, 0))
        fc = (_resumed_cache(self.method, prob, x, r.fcache)
              if self.use_fcache else None)
        like = lambda t, dtype=None: _on(t, x).to(
            dtype if dtype is not None else prob.dtype)
        return Carry(
            x=x, x_prev=like(r.x_prev), gq=like(r.gq), gq_prev=like(r.gq_prev),
            d_prev=like(r.d_prev), cg_total=like(r.cg_total, torch.int64),
            bnorm_prev=like(r.bnorm_prev), frel=like(r.frel),
            k=like(r.k, torch.int32), pri_res=like(r.pri_res),
            done=like(r.done, torch.bool), mem=_resume_tree(r.mem, x),
            fcache=fc, hist=h,
            rng=torch.as_tensor(r.rng).to("cpu", torch.int64).clone())

    def live(self) -> torch.Tensor:
        c = self.carry
        return ~c.done & (c.k < self.max_epoch)

    def state(self) -> tuple:
        """The tensors a round writes: the carry's (but the generator's
        state, which only the host advances) and, with mini-batches,
        the batch loop's."""
        out = tuple(_leaves(self.carry._replace(rng=None)))
        b = self.batches
        if b is not None:
            bufs = (b.Ab, b.yb, b.Ar, b.yr) + tuple(
                getattr(b, f, None) for f in ("mb", "pb", "mr", "pr"))
            out += (b.bi, b.blive) + tuple(
                t.block if is_colshard(t) else t for t in bufs
                if t is not None)
        return out

    def record(self, prob: Problem) -> torch.Tensor:
        """One stats record at the carry's iterate, written at n_rec;
        returns the raw relative gap."""
        c, h = self.carry, self.carry.hist
        vals, raw_frel = _record(
            prob, self.reg_name, self.opts, c.x, self.obj_star,
            c.fcache.loss if self.use_fcache else None, c.pri_res)
        at = h.n_rec.reshape(1).long()
        for buf, v in zip(h[:6], vals):
            buf.index_copy_(0, at, v.reshape(1).to(buf.dtype))
        if self.metric_fns:
            mvals = _metric_values(prob, c.x, self.metric_fns)
            h.metrics.index_copy_(1, at, mvals.reshape(-1, 1))
        h.n_rec.add_(1)
        return raw_frel

    def _step_on(self, prob: Problem, As, ys, it, raw_frel,
                 gq_cached=None):
        """One step on the rows (As, ys), into the carry; returns the
        stop test of the step."""
        c = self.carry
        new, conv = _step_carry(self.method, self.step, prob, self.reg_name,
                                self.sm, self.opts, As, ys, c, it, raw_frel,
                                self.use_fcache, gq_cached)
        _assign(c, c._replace(**new))
        return conv

    def step_epoch(self, prob: Problem, raw_frel) -> None:
        c = self.carry
        it = c.k + 1  # 1-based like the reference epoch_t
        if self.batching is None:
            conv = self._step_on(prob, prob.A, prob.y, it, raw_frel,
                                 gq_cached=c.gq if self.is_lbfgs else None)
            _assign(c, c._replace(frel=raw_frel, k=c.k + 1, done=conv))
            return
        self._step_batches(prob, it, raw_frel)

    def _step_batches(self, prob: Problem, it, raw_frel) -> None:
        """One epoch of mini-batches: the full batches as one loop on the
        device (its batch index a counter there, frozen once a batch's
        stop test fires), then the partial last batch, then the epoch's
        stop test on the last step taken (the JAX package's scan)."""
        c, b = self.carry, self.batches
        nb, _, rem = self.batching
        perm = b.rows(c.k if b.by_epoch else torch.remainder(c.k, self.K))

        def batch():
            c.done.copy_(self._step_on(*b.gather_full(prob, perm), it,
                                       raw_frel))
            b.bi.add_(1)
            b.blive.copy_((b.bi < nb) & ~c.done)

        b.bi.zero_()
        b.blive.copy_(~c.done)
        state = self.state()
        device_loop(b.blive, nb, batch,
                    state=tuple(t for t in state if t is not b.blive))
        if rem:
            device_if(~c.done, lambda: c.done.copy_(self._step_on(
                *b.gather_rest(prob, perm), it, raw_frel)), state)
        conv = _stopped(c.x, c.x_prev, raw_frel, c.pri_res, self.opts)
        _assign(c, c._replace(frel=raw_frel, k=c.k + 1, done=conv))

    def gap_now(self, prob: Problem):
        """The per-epoch gap between stats rounds: exact from the cached
        loss (O(n)); off the cache the round's gap (a fresh one would
        cost a pass over A)."""
        c = self.carry
        if not self.use_fcache:
            return c.frel
        return _gap(prob, self.reg_name, c.x, c.fcache.loss, self.obj_star)

    def round(self, prob: Problem) -> None:
        """The loop's body, one replay: behind ``live``, a stats record
        and an epoch, or with ``stats_every = K > 1`` a round: a stats
        record where k is a multiple of K, then epochs, each behind
        ``live`` again, up to the next multiple of K (a finished solve
        skips the rest of its round; a solve resumed off that grid first
        takes the epochs back to it, with its saved gap, as the JAX
        package's resume does)."""
        K = self.K
        c = self.carry
        state = self.state()

        def body():
            if K <= 1:
                self.step_epoch(prob, self.record(prob))
                return
            device_if(torch.remainder(c.k, K) == 0,
                      lambda: c.frel.copy_(self.record(prob)), state)
            for j in range(K):
                live = self.live()
                if j:
                    live = live & (torch.remainder(c.k, K) != 0)
                device_if(live, lambda: self.step_epoch(
                    prob, self.gap_now(prob)), state)

        device_if(self.live(), body, state)

    def round_of(self, replay):
        """``replay`` (a run of :meth:`round`) with the permutations of
        its epochs drawn and copied to the card before it."""
        if self.batches is None:
            return replay
        b, K = self.batches, self.K

        def run():
            b.draw((b.k_host // K + 1) * K)
            replay()

        return run

    def finish(self, prob: Problem, t0: float,
               run: Optional[_Run] = None) -> Solution:
        """The final record at the terminating iterate, then everything
        read back at once (one host read on the card)."""
        run = _NO_RUN if run is None else run
        self.record(prob)
        c = self.carry
        h = c.hist
        cap, nm = h.fval.shape[0], h.metrics.shape[0]
        packed = _to_host(torch.cat([
            torch.stack(h[:6]).to(torch.float64).reshape(-1),
            h.metrics.to(torch.float64).reshape(-1),
            torch.stack([h.n_rec.to(torch.int64), c.k.to(torch.int64),
                         c.cg_total]).to(torch.float64)]))
        n_rec, epochs, cg_total = (int(v) for v in packed[(6 + nm) * cap:])
        cols = packed[:6 * cap].reshape(6, cap)[:, :n_rec].to(prob.dtype)
        mets = packed[6 * cap:(6 + nm) * cap].reshape(nm, cap)[:, :n_rec]
        x_out = c.x.clone()
        if prob.n_true is not None:
            x_out = x_out[..., : prob.n_true]  # drop feature padding
        times = torch.zeros(n_rec, dtype=torch.float64)
        times[-1] = time.perf_counter() - t0
        rng = (c.rng.clone() if self.batches is None
               else self.batches.rng_at(epochs, c.rng))
        return Solution(
            x=x_out, obj=cols[1], fval=cols[0], pri_res_norm=cols[4],
            rel=cols[2], objrel=cols[3], times=times, epochs=epochs,
            model=prob,
            cg_info={"total_cg_iters": cg_total} if cg_total else None,
            state=_clone_tree(c)._replace(rng=rng),
            fvaltest=(cols[5] if prob.has_test
                      else torch.zeros((0,), dtype=prob.dtype)),
            metricvals={name: mets[i].to(prob.dtype)
                        for i, name in enumerate(run.metric_names)})


class _Entry:
    """A cached captured solve: its loop, its graphs by name, and the
    room of its histories."""

    def __init__(self, loop, graphs: dict, cap: int = 0):
        self.loop, self.graphs, self.cap = loop, graphs, cap


def _capture_key(kind: str, method, prob: Problem, reg_name: str, sm,
                 opts: Options, metric_fns: tuple, refs: list):
    """What a captured graph depends on: the method, options (not
    verbose, and not max_epoch, a buffer of the graph), smoother,
    metrics and problem — their data, specs, functions and structure by
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

    return (kind, method, reg_name,
            dataclasses.replace(opts, verbose=0, max_epoch=0),
            fields(sm, _tensor_fields(sm)), fields(prob, _COPIED),
            tuple(graph.identity_key(fn, refs) for fn in metric_fns))


def _uncaptured(prob: Problem) -> bool:
    """True where a fused solve of a sharded problem on the card runs its
    program uncaptured (`graph.eager`: the same bodies, the kernels
    launched one by one, a host read a predicate): over gloo, whose
    collectives reduce CUDA tensors through the host, which a capture
    cannot hold."""
    mesh = prob.comm_mesh
    if mesh is None or prob.device.type != "cuda":
        return False
    return dist.get_backend(mesh.group) == "gloo"


def _check_capturable(prob: Problem) -> None:
    """Raise before the first collective where a sharded solve over NCCL
    cannot be captured: NCCL's collectives across two ranks or more sit
    inside the graph's conditional nodes, which NCCL allows only when the
    communicator was made under NCCL_GRAPH_MIXING_SUPPORT=0 (on four
    H100s over NVLink the graph failed to instantiate without it;
    `Mesh.captures` records the setting as it was then). One NCCL rank
    always captures, and so does the overlapped K1s schedule
    (``comm_overlap_chunks > 1``: its chunks' all-reduces in order on
    the capturing stream, `ops.cuda.matvec._sharded`). A gloo group
    never gets here (:func:`_uncaptured`). Timed mode runs uncaptured on
    any group."""
    mesh = prob.comm_mesh
    if mesh is None:
        return
    if mesh.size > 1 and not mesh.captures:
        raise RuntimeError(
            "a captured (mode='fused') solve on a problem sharded over "
            "more than one NCCL rank needs NCCL_GRAPH_MIXING_SUPPORT=0 in "
            "the environment when the mesh's process groups are made: "
            "NCCL's collectives inside the graph's conditional nodes fail "
            "to instantiate without it; set it before distributed_init, or "
            "use mode='timed'")


def _quiesce(prob: Problem) -> None:
    """Wait for the card where a captured solve's NCCL collectives meet
    uncaptured ones on the same communicator (a multi-rank row shard):
    under NCCL_GRAPH_MIXING_SUPPORT=0 NCCL guarantees nothing while a
    graph with collectives still runs and an eager collective is issued,
    so every eager collective (a solve's priming and records, the next
    solve, a timed solve) starts after the replays have ended, and every
    capture after the eager collectives before it."""
    mesh = prob.comm_mesh
    if mesh is not None and mesh.size > 1 and prob.device.type == "cuda":
        torch.cuda.synchronize(prob.device)


def _captured(kind: str, method, prob: Problem, reg_name: str, sm,
              opts: Options, run: _Run, make, cap: int = 0):
    """The cached capture of ``kind`` for this solve, or a new one:
    ``make(buffers, static_prob, static_sm, cap)`` builds the loop on
    the static smoother, loads this solve (before any capture) and
    returns (loop, {name: fn}) of the bodies to capture on the static
    problem. A cached loop whose histories hold fewer than ``cap``
    records is captured again, with room for ``cap``. A body that
    cannot be captured (a function that reads the card from the host)
    raises."""
    _check_capturable(prob)
    _quiesce(prob)
    refs = []
    key = _capture_key(kind, method, prob, reg_name, sm, opts,
                       run.metric_fns, refs)
    entry = graph.cached(key)
    if entry is not None and entry.cap >= cap:
        entry.loop.load(prob, sm, run, opts.max_epoch)
        return entry
    buffers = _Buffers(prob, sm)
    loop, bodies = make(buffers, *buffers.static(prob, sm), cap)
    _quiesce(prob)
    try:
        graphs = {name: graph.capture(fn, prob.device)
                  for name, fn in bodies.items()}
    except RuntimeError as e:
        raise RuntimeError(
            f"the solve's {kind!r} body could not be captured into a CUDA "
            "graph. Every function a solve runs on the card (f and its "
            "hooks, out_fn, and in mode='fused' the metrics) must run "
            "without reading the card from the host (.item(), float(), "
            "bool(), a copy to the CPU): a metric that reads the host "
            "runs in mode='timed', called on the host at each "
            f"record") from e
    entry = _Entry(loop, graphs, cap)
    graph.store(key, entry, refs)
    return entry


def _capacity(opts: Options, run: _Run) -> int:
    """Room for the records of a captured solve, at least max_epoch + 1
    (and the resumed records), rounded up to a power of two from 16: a
    loop captured for one budget serves the solves of smaller ones (a
    chain's chunks, the stages of a continuation, a resume)."""
    need = opts.max_epoch + 1
    if run.resume is not None:
        need = max(need, int(_to_host(torch.as_tensor(
            run.resume.hist.n_rec))) + 1)
    return _room(need)


def _room(need: int) -> int:
    """At least ``need`` records, a power of two from 16."""
    return max(16, 1 << (need - 1).bit_length())


def _solve_captured(method, prob: Problem, reg_name: str, sm,
                    opts: Options, run: _Run, t0: float) -> Solution:
    def make(buffers, static, static_sm, cap):
        loop = _Fused(method, reg_name, static_sm, opts, run.metric_fns,
                      cap, buffers)
        loop.load(prob, sm, run)
        return loop, {"round": lambda: loop.round(static)}

    entry = _captured("fused", method, prob, reg_name, sm, opts, run, make,
                      _capacity(opts, run))
    loop = entry.loop
    _quiesce(prob)  # after the load's eager collectives
    _replays(loop.round_of(entry.graphs["round"].replay), loop.live,
             loop.max_rounds)
    _quiesce(prob)  # before the final record's
    return loop.finish(prob, t0, run)


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
    stats: torch.Tensor     # (fval, obj, rel, objrel, raw gap, fvaltest)
    check: torch.Tensor     # (pri_res, ‖x⁺ − x‖, ‖x‖)
    cg_total: torch.Tensor  # int64
    fcache: Optional[GLMCache] = None  # a row shard's epoch cache


class _Timed:
    """The timed loop's state between epochs in fixed tensors: the
    iterate and what the step carries (the JAX package's Python loop
    variables), the epoch index, and what one stats record
    (:meth:`stats`) and one step (:meth:`step`; under mini-batches
    :meth:`batch_step` and :meth:`rest_step`) leave for the host to
    read. On a CUDA problem each is a captured graph, except on a row
    shard, where they run uncaptured, and where the epoch cache acts the
    step is the cached one and each record reads the cache's all-reduced
    loss, as in fused mode."""

    def __init__(self, method, reg_name: str, sm, opts: Options,
                 buffers: Optional[_Buffers] = None):
        self.method, self.reg_name, self.sm, self.opts = (
            method, reg_name, sm, opts)
        self.buffers = buffers
        self.is_lbfgs = isinstance(method, ProxLQNSCORE)
        self.step_fn = make_step_fn(method)
        self.state = None
        self.cached = False
        self.batching = self.batches = None

    def load(self, prob: Problem, sm, run: _Run,
             max_epoch: Optional[int] = None) -> None:
        if self.buffers is not None:
            self.buffers.fill(prob, sm)
        dt, dev = prob.dtype, prob.device
        self.batching = _make_batches(prob, self.opts)
        lam, cw = _lam_scalar(prob.lam), _cw(prob, self.reg_name)
        # a row shard takes the cached step where the cache acts, so that
        # timed mode's epochs are the fused mode's there
        self.cached = prob.comm_mesh is not None and epoch_cache_enabled(
            self.method, prob, self.reg_name, self.batching is None)
        if self.cached:
            obj_star = (prime_glm_cache(self.method, prob, prob.x_star).loss
                        + prob.reg(self.reg_name, prob.x_star))
        else:
            obj_star = prob.obj(self.reg_name, prob.x_star)
        r = run.resume
        if r is None:
            x0 = prob.x0
            cache_grads = self.is_lbfgs and self.batching is None
            gq0 = (prob.grad_f(prob.A, prob.y, x0) + lam * self.sm.grad(x0, cw)
                   if cache_grads else torch.zeros_like(x0))
            mem = init_memory(x0.shape[-1],
                              self.method.m if self.is_lbfgs else 1, dt, dev)
            carried = (x0, x0, gq0, torch.zeros_like(x0),
                       torch.zeros_like(x0),
                       torch.tensor(float("nan"), dtype=dt, device=dev),
                       mem, torch.zeros((), dtype=torch.int64, device=dev))
            fc = (prime_glm_cache(self.method, prob, x0) if self.cached
                  else None)
        else:
            x = _on(r.x, prob.x0).to(dt)
            like = lambda t: _on(t, x).to(dt)
            carried = (x, like(r.x_prev), like(r.gq), like(r.gq_prev),
                       like(r.d_prev), like(r.bnorm_prev),
                       _resume_tree(r.mem, x),
                       _on(r.cg_total, x).to(torch.int64))
            fc = (_resumed_cache(self.method, prob, x, r.fcache)
                  if self.cached else None)
        x, x_prev, gq, gq_prev, d_prev, bn, mem, cgt = carried
        state = _TimedState(
            x=x, x_prev=x_prev, gq=gq, gq_prev=gq_prev, d_prev=d_prev,
            bnorm_prev=bn, mem=mem,
            it=torch.zeros((), dtype=torch.int32, device=dev),
            obj_star=obj_star, stats=torch.zeros(6, dtype=dt, device=dev),
            check=torch.zeros(3, dtype=dt, device=dev), cg_total=cgt,
            fcache=fc)
        if self.state is None:
            self.state = _clone_tree(state)
        else:
            _assign(self.state, state)
        if self.batching is not None and self.batches is None:
            self.batches = _Batches(prob, self.batching, 1)

    def stats(self, prob: Problem) -> None:
        """(fval, obj, rel, objrel, raw gap, fvaltest) at x, into
        ``stats``."""
        st = self.state
        st.stats.copy_(torch.stack(_stats(
            prob, self.reg_name, st.x, st.obj_star, self.opts.x_tol,
            self.opts.f_tol, st.fcache.loss if self.cached else None)))

    def _step_on(self, prob: Problem, As, ys, full: bool) -> None:
        """One step from x at epoch ``it`` on the rows (As, ys), as the
        JAX package's timed loop takes it (no epoch cache; on a row
        shard the cached step); (‖x⁺‖-test terms and the primal
        residual) into ``check``."""
        st, method = self.state, self.method
        if self.is_lbfgs:
            out = lbfgs_step(method, prob, self.reg_name, self.sm, As, ys,
                             st.x, st.x_prev, st.gq_prev, st.it, st.mem,
                             gq_cached=st.gq if full else None)
        else:
            out = self.step_fn(method, prob, self.reg_name, self.sm, As, ys,
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
            cg_total=st.cg_total + out.cg_iters,
            fcache=out.fcache if self.cached else None))

    def step(self, prob: Problem) -> None:
        self._step_on(prob, prob.A, prob.y, True)

    def batch_step(self, prob: Problem) -> None:
        """The step on full batch ``bi`` of the epoch's permutation."""
        b = self.batches
        self._step_on(*b.gather_full(prob, b.rows(0)), False)

    def rest_step(self, prob: Problem) -> None:
        """The step on the partial last batch."""
        b = self.batches
        self._step_on(*b.gather_rest(prob, b.rows(0)), False)

    def bodies(self, prob: Problem) -> dict:
        """{name: body} of what a solve of this loop runs."""
        out = {"stats": lambda: self.stats(prob)}
        if self.batching is None:
            out["step"] = lambda: self.step(prob)
        else:
            out["batch"] = lambda: self.batch_step(prob)
            if self.batching[2]:
                out["rest"] = lambda: self.rest_step(prob)
        return out


def _solve_timed(method, prob: Problem, reg_name: str, sm, opts: Options,
                 run: _Run, capture: bool, t0: float) -> Solution:
    """The JAX package's `_solve_python`: every epoch a stats record
    (one host read) with the metrics called on the host, its wall-clock
    time, the step (captured on the card off a row shard; under
    mini-batches a step and a stop test a batch, on the epoch's
    permutation drawn on the host) and the stop test on the host (one
    read a step)."""
    if capture:
        def make(buffers, static, static_sm, cap):
            loop = _Timed(method, reg_name, static_sm, opts, buffers)
            loop.load(prob, sm, run)
            return loop, loop.bodies(static)

        entry = _captured("timed", method, prob, reg_name, sm, opts, run,
                          make)
        loop = entry.loop
        runs = {name: g.replay for name, g in entry.graphs.items()}
    else:
        loop = _Timed(method, reg_name, sm, opts)
        loop.load(prob, sm, run)
        runs = loop.bodies(prob)
    st = loop.state
    on_card = prob.device.type == "cuda"
    has_test = prob.has_test

    def read(t):
        if on_card:
            graph.host_read()
        return t.tolist()

    _, label = method.display()
    r = run.resume
    cols = ("fval", "obj", "rel", "objrel", "prires", "fvaltest")
    recs = {name: [] for name in cols}
    mrecs = {name: [] for name in run.metric_names}
    if r is None:
        gen = np.random.default_rng(run.rng_seed)
        start_epoch, pri, conv, raw_frel = 1, float("nan"), False, math.inf
        prior = 0
    else:
        gen = _rng_unpack(torch.as_tensor(r.rng))
        hist = _resume_tree(r.hist, torch.zeros(()))
        prior = max(int(hist.n_rec) - 1, 0)  # its final record comes again
        for name, buf in zip(cols, hist[:6]):
            recs[name] = buf[:prior].tolist()
        for i, name in enumerate(run.metric_names):
            mrecs[name] = hist.metrics[i, :prior].tolist()
        start_epoch = int(_on(r.k, torch.zeros(()))) + 1
        pri = float(_on(r.pri_res, torch.zeros(())))
        conv = bool(_on(r.done, torch.zeros(())))
        raw_frel = float(_on(r.frel, torch.zeros(())))
    times = []
    t_loop = time.perf_counter()
    epochs = start_epoch - 1

    def record():
        runs["stats"]()
        fval, obj, rel, objrel, raw, ftst = read(st.stats)
        for name, v in zip(cols, (fval, obj, rel, objrel, pri, ftst)):
            recs[name].append(v)
        for name, fn in zip(run.metric_names, run.metric_fns):
            v = fn(prob, st.x)
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                graph.host_read()
            mrecs[name].append(float(v))
        times.append(time.perf_counter() - t_loop)
        if opts.verbose > 1:
            print("-" * 32)
            print(f"Optimizer = {label}")
            parts = [f"epoch = {epochs}", f"obj = {obj}", f"fval = {fval}",
                     f"pri_res_norm = {pri}"]
            if has_test:
                parts.append(f"fvaltest = {ftst}")
            parts += [f"rel_error = {rel}", f"\u0394time = {times[-1]:.3f}s"]
            print("\n".join(parts))
            for name in run.metric_names:
                print(f"{name} = {mrecs[name][-1]}")
        return raw

    b = loop.batches
    for epoch_t in range(start_epoch, opts.max_epoch + 1):
        if conv:
            break
        raw_frel = record()
        st.it.fill_(epoch_t)
        if loop.batching is None:
            steps = [runs["step"]]
        else:
            nb, bs, rem = loop.batching
            m = prob.m_total
            b.fill(0, (gen.permutation(m) if opts.shuffle_batch
                       else np.arange(m))[None])
            steps = [runs["batch"]] * nb + ([runs["rest"]] if rem else [])
        iend = len(steps)
        for i, run_step in enumerate(steps, start=1):
            if opts.verbose > 2:
                # a tick a batch, as the reference prints them
                if i in (1, iend) or i % 100 == 0:
                    print(f"\n[{i}/{iend}]", end="", flush=True)
                else:
                    print("#", end="", flush=True)
            if loop.batching is not None and i <= loop.batching[0]:
                b.bi.fill_(i - 1)
            run_step()
            pri, dxn, xn = read(st.check)
            conv = (dxn < opts.x_tol * max(xn, 1.0)
                    or raw_frel <= opts.f_tol or pri < opts.x_tol)
            if conv:
                break  # the per-batch stop test
        epochs += 1
        if opts.verbose > 2:
            print("\n" + "-" * 32, flush=True)
    raw_frel = record()
    if opts.verbose > 1:
        if conv:
            print("The algorithm terminated after a relative tolerance "
                  f"was reached at epoch {epochs}.")
        else:
            print("The algorithm reached its maximum number of epochs "
                  f"({opts.max_epoch}).")
    dt, dev = prob.dtype, prob.device
    hist_cols = torch.tensor([recs[name] for name in cols], dtype=dt)
    n_rec = hist_cols.shape[1]
    mets = torch.tensor([mrecs[name] for name in run.metric_names],
                        dtype=dt).reshape(len(run.metric_names), n_rec)
    x_out = st.x.clone()
    if prob.n_true is not None:
        x_out = x_out[..., : prob.n_true]  # drop feature padding
    on = lambda v, dtype=dt: torch.tensor(v, dtype=dtype, device=dev)
    state = Carry(
        x=st.x.clone(), x_prev=st.x_prev.clone(), gq=st.gq.clone(),
        gq_prev=st.gq_prev.clone(), d_prev=st.d_prev.clone(),
        cg_total=st.cg_total.clone(), bnorm_prev=st.bnorm_prev.clone(),
        frel=on(raw_frel), k=on(epochs, torch.int32), pri_res=on(pri),
        done=on(conv, torch.bool), mem=_clone_tree(st.mem),
        fcache=_clone_tree(st.fcache) if loop.cached else None,
        hist=History(*(c.to(dev) for c in hist_cols), metrics=mets.to(dev),
                     n_rec=on(n_rec, torch.int32)),
        rng=_rng_pack(gen))
    times = torch.cat([torch.zeros(n_rec - len(times), dtype=torch.float64),
                       torch.tensor(times, dtype=torch.float64)])
    return Solution(
        x=x_out, obj=hist_cols[1], fval=hist_cols[0],
        pri_res_norm=hist_cols[4], rel=hist_cols[2], objrel=hist_cols[3],
        times=times, epochs=epochs, model=prob, state=state,
        fvaltest=hist_cols[5] if has_test else torch.zeros((0,), dtype=dt),
        metricvals={name: mets[i] for i, name in
                    enumerate(run.metric_names)})


def iterate(method, model: Problem, reg_name: str, h_mu, *,
            metrics: Optional[dict] = None, alpha=None, batch_size=None,
            slice_samples=False, shuffle_batch=True, max_epoch=1000,
            comm_rounds=100, local_max_iter=None, x_tol=1e-10,
            f_tol=1e-10, verbose=1, mode="fused", rng_seed=0,
            stats_every=1, vmap_safe=False, resume_state=None,
            _capture=True) -> Solution:
    """Run a SCORE solve — the JAX package's ``iterate`` entry point, in
    ``mode`` 'fused' or 'timed'. ``metrics`` maps a name to
    ``fn(problem, x)``: in fused mode a torch function returning a 0-d
    tensor (recorded on the card inside the captured graph), in timed
    mode any host function (called at each record). ``batch_size``,
    ``slice_samples``, ``shuffle_batch`` and ``rng_seed`` select
    mini-batches; ``resume_state`` continues a previous
    ``Solution.state``. ``local_max_iter`` runs one epoch over that
    many mini-batches (``max_epoch`` becomes 1); ``vmap_safe`` is
    accepted for the reference's signature and changes nothing
    (`Options`).
    ``method=None`` runs ProxLQNSCORE(), the reference's intended
    default. ``_capture=False`` (private) runs a CUDA problem's graph
    bodies eagerly: the reference form of a captured solve, for checks
    on the card."""
    if method is None:
        method = ProxLQNSCORE()
    if local_max_iter is not None:
        max_epoch = 1
    opts = Options(max_epoch=max_epoch, x_tol=x_tol, f_tol=f_tol,
                   stats_every=stats_every, batch_size=batch_size,
                   slice_samples=slice_samples, shuffle_batch=shuffle_batch,
                   local_max_iter=local_max_iter, comm_rounds=comm_rounds,
                   verbose=verbose, mode=mode, vmap_safe=vmap_safe)
    names = tuple(sorted(metrics)) if metrics else ()
    fns = tuple(metrics[k] for k in names)
    if verbose > 0 and method.ss_type == 1 and model.L is None \
            and alpha is None:
        print("Neither L nor alpha is set for the problem... "
              "Now fixing alpha = 0.5...")
    return solve(method, model, reg_name, h_mu, opts, metric_fns=fns,
                 metric_names=names, alpha=alpha, rng_seed=rng_seed,
                 resume_state=resume_state, capture=_capture)
