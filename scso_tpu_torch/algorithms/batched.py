"""The batched solve: B instances of one configuration solved as one.

The port's counterpart of the JAX package's ``jax.vmap`` of its scalar
fused solve (`scso_tpu.parallel.sweep`: ``_sweep_fn``, ``_fleet_fn``).
No JAX file corresponds to this module: there vmap batches the whole
solve, `lax.while_loop`s included. Here:

  * Layout. Every instance's tensors lie on a leading axis B: the
    iterate and all the solve carries (:class:`State`), the histories
    (B, cap), and the problem's and the smoother's fields that the
    caller names in a :class:`BatchSpec` — a λ path batches λ, x0 and
    the smoother's μ; a fleet every tensor of both. The other fields are
    shared, and read once a product.
  * Per-instance work is the scalar solve's own code under
    ``torch.func.vmap``: the step and its stop test
    (`iterate._step_carry`), the stats record (`iterate._record`) and
    the gap between records (`iterate._gap`); only the writes into the
    batched state and histories are this module's. With a shared A, a
    product for all B instances is one matrix product, ``A @ V`` and
    ``Aᵀ @ (W ∘ Z)``, never B of them; with a stacked A (a fleet) one
    batched product (bmm).
  * Loops and conds. Every loop runs while ANY instance is live, and
    each instance's state is updated under its own mask,
    ``torch.where(live, new, old)``: CG and Armijo inside a step
    (`graph.device_loop` under vmap), and the epoch loop here (a round
    of ``stats_every`` epochs computes every epoch and keeps it where
    the instance was live: the JAX package's ``vmap_safe`` form). A
    cond whose test differs between instances computes both branches
    and selects (`graph.device_cond`). These are JAX's vmap semantics,
    and they make each instance give the result of its own scalar
    solve.
  * Kernels. The batched solve runs ``kernels='torch'``, as the JAX
    package's sweep forces 'xla' (`_xla_kernels`), for the JAX
    package's reason: with A shared, every matvec of every instance is
    one product ``A @ V``, A read once for the whole batch. The
    single-instance kernels (K1–K5) exist to avoid a second read of A
    within ONE instance; run per instance they would read A once an
    instance. On a CUDA problem everything runs on the card; TF32 stays
    off (PyTorch's default).
  * On the card the whole solve — a WHILE node on any(live) whose body
    is one round — is captured once into a CUDA graph per static
    configuration (cached as the scalar solve's captures are,
    `iterate._captured`) and replayed once a solve. λ, μ, x0, x* and the
    bounds (`iterate._Buffers`) and ``max_epoch`` are buffers of the
    graph, so the waves of a path, a polish from ``x0_grid`` and each
    round of a federated solve replay one capture. ``capture=False``
    runs the same bodies eagerly (`graph.eager`).

  * A row-sharded problem (rows on the mesh's data axis; the JAX
    package's ('batch', 'data') layout) runs the same code: its row sums
    (`Problem.row_sum`, K1s) reduce the whole (B, ...) batch in ONE
    collective over the data axis (`ops.collective.group_sum`'s vmap
    rule), so the captured graph holds one collective a sum whatever B
    is. Every instance's values are replicated over the data axis, so
    the ranks of a data group iterate in step.
  * Mini-batches (``batch_size``, ``slice_samples``): one seed for every
    instance (the JAX package's vmapped solve takes one ``rng_seed``), so
    every instance steps on the same rows and one gather of them serves
    the whole batch (`iterate._Batches`, and on a row shard its layout:
    a rank's rows of each batch, padded to min(bs, m_r)). Every epoch's
    permutation is drawn on the host before the solve. An epoch's
    batches run while any instance is live in it, each instance frozen
    from its own batch stop test on, as its scalar solve freezes.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import nullcontext
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.iterate import (
    History, Options, _NO_RUN, _Batches, _assign, _captured, _clone_tree,
    _gap, _leaves, _make_batches, _quiesce, _record, _rng_pack, _room,
    _step_carry, _stopped)
from scso_tpu_torch.algorithms.methods import (
    ProxGGNSCORE, ProxLQNSCORE, ProxNSCORE)
from scso_tpu_torch.algorithms.steps import (
    _cw, _lam_scalar, epoch_cache_enabled, make_step_fn, prime_glm_cache)
from scso_tpu_torch.ops.cuda import graph
from scso_tpu_torch.ops.cuda.graph import device_if, device_loop
from scso_tpu_torch.ops.lbfgs_core import LBFGSMemory, init_memory
from scso_tpu_torch.problems import Problem


@dataclasses.dataclass
class SweepResult:
    """Batched solve results, leading axis = instance; tensors on the
    problem's device."""

    x: Any             # (B, n) final iterates
    obj: Any           # (B,) final objective f + g
    fval: Any          # (B,) final data term f
    rel: Any           # (B,) final relative error vs x_star
    epochs: Any        # (B,) epochs taken
    pri_res_norm: Any  # (B,) final primal residual
    obj_hist: Any      # (B, cap) objective history (valid up to n_rec)
    n_rec: Any         # (B,) number of valid history records

    @property
    def batch_size(self) -> int:
        return self.x.shape[0]


class BatchSpec(NamedTuple):
    """The fields of the problem (``prob``) and of the smoother (``sm``)
    that carry the instance axis; a problem field holding a dataclass
    (the groups) carries it on each of its tensors."""

    prob: tuple
    sm: tuple


class State(NamedTuple):
    """One instance's state between epochs: `iterate.Carry` without the
    histories and the permutations' generator (the batched solve runs
    full batches). ``fcache`` is the epoch cache, or () off it."""

    x: torch.Tensor
    x_prev: torch.Tensor
    gq: torch.Tensor
    gq_prev: torch.Tensor
    d_prev: torch.Tensor
    cg_total: torch.Tensor
    bnorm_prev: torch.Tensor
    frel: torch.Tensor
    k: torch.Tensor
    pri_res: torch.Tensor
    done: torch.Tensor
    mem: LBFGSMemory
    fcache: Any


def leaves(obj, names) -> dict:
    """{name: tensor} of ``obj``'s fields ``names``; a dataclass field
    gives {name: {its tensor fields}}."""
    out = {}
    for name in names:
        v = getattr(obj, name)
        if dataclasses.is_dataclass(v):
            v = {f.name: getattr(v, f.name) for f in dataclasses.fields(v)
                 if isinstance(getattr(v, f.name), torch.Tensor)}
        out[name] = v
    return out


def tensor_fields(obj) -> tuple:
    """The names of ``obj``'s fields that hold a tensor, or a dataclass
    holding tensors (the groups): the fields a stacked problem or
    smoother carries the instance axis on."""
    def holds(v):
        if isinstance(v, torch.Tensor):
            return True
        return (dataclasses.is_dataclass(v) and not isinstance(v, type)
                and any(isinstance(getattr(v, f.name), torch.Tensor)
                        for f in dataclasses.fields(v)))

    return tuple(f.name for f in dataclasses.fields(obj)
                 if holds(getattr(obj, f.name)))


def rebuild(obj, fields: dict):
    """``obj`` with ``fields`` (as :func:`leaves` gives them) in place of
    its own."""
    ch = {name: (dc_replace(getattr(obj, name), **v) if isinstance(v, dict)
                 else v) for name, v in fields.items()}
    return dc_replace(obj, **ch)


def map_leaves(fields: dict, fn) -> dict:
    """``fn`` applied to each tensor of ``fields`` (as :func:`leaves`
    gives them)."""
    return {k: (map_leaves(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in fields.items()}


def instance(obj, names, i):
    """``obj`` with the fields ``names`` taken at instance ``i`` (the
    values of one instance: a template for static decisions)."""
    return rebuild(obj, map_leaves(leaves(obj, names), lambda t: t[i]))


def take(obj, names, lo: int, hi: int):
    """``obj`` with the fields ``names`` cut to the instances
    ``lo:hi``."""
    return rebuild(obj, map_leaves(leaves(obj, names), lambda t: t[lo:hi]))


def check(method, proto: Problem, opts: Options, spec: BatchSpec) -> None:
    """Refuse, before any work and alike on every rank, what the batched
    form cannot take. ``proto`` is one instance's problem."""
    if not isinstance(method, (ProxNSCORE, ProxGGNSCORE, ProxLQNSCORE)):
        raise TypeError(f"unknown method {method!r}")
    if proto.mesh is not None and proto.data_axis not in \
            proto.mesh.axis_names:
        raise ValueError(f"the problem's rows are on axis "
                         f"{proto.data_axis!r}, which is not in its mesh's "
                         f"{tuple(proto.mesh.axis_names)}")
    if (_make_batches(proto, opts) is not None and "A" in spec.prob
            and proto.mesh is not None):
        raise ValueError(
            "mini-batches in a fleet of row-sharded problems, each with its "
            "own A: every instance's batch would need rows of its own A on "
            "every rank; run the fleet on full batches, or row-shard one "
            "shared A and sweep it")


def _bcast(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The (B,) ``mask`` shaped to broadcast against ``t`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (t.ndim - 1))


class _Loop:
    """The batched solve's loop: its state and histories in fixed
    tensors, updated in place by :meth:`round` (all instances, each
    under its own mask) and run to the end by :meth:`solve` (one WHILE
    node on any(live) under capture). ``sm`` and the problem given to
    :meth:`solve` are a capture's static ones (buffers) or a solve's
    own."""

    def __init__(self, method, reg_name: str, opts: Options,
                 spec: BatchSpec, proto: Problem, cap: int,
                 buffers=None):
        self.method, self.reg_name, self.opts = method, reg_name, opts
        self.spec, self.cap, self.buffers = spec, cap, buffers
        self.K = max(opts.stats_every, 1)
        self.is_lbfgs = isinstance(method, ProxLQNSCORE)
        self.step_fn = make_step_fn(method)
        self.batching = _make_batches(proto, opts)
        self.use_fcache = epoch_cache_enabled(method, proto, reg_name,
                                              self.batching is None)
        self.stacked = "A" in spec.prob
        self.state = self.hist = self.obj_star = None
        self.max_epoch = self.going = None
        self.batches = self.ep = self.bact = None
        self.max_rounds = 0

    # -- per instance, under vmap ------------------------------------------

    def _vmap(self, fn, prob: Problem, sm, *args):
        """``fn(instance problem, instance smoother, *args)`` for every
        instance at once: ``torch.func.vmap`` over the spec's fields and
        over ``args`` (each batched on axis 0)."""
        pb, sb = leaves(prob, self.spec.prob), leaves(sm, self.spec.sm)

        def one(pb, sb, *a):
            return fn(rebuild(prob, pb), rebuild(sm, sb), *a)

        return torch.func.vmap(one)(pb, sb, *args)

    def _prepare(self, p: Problem, s):
        """(obj_star, ∇q at x0 (L-BFGS) or zeros, the epoch cache at x0
        or ()) of one instance."""
        method, reg_name = self.method, self.reg_name
        if self.use_fcache:
            obj_star = (prime_glm_cache(method, p, p.x_star).loss
                        + p.reg(reg_name, p.x_star))
        else:
            obj_star = p.obj(reg_name, p.x_star)
        x0 = p.x0
        if self.is_lbfgs and self.batching is None:
            gq0 = (p.grad_f(p.A, p.y, x0)
                   + _lam_scalar(p.lam) * s.grad(x0, _cw(p, reg_name)))
        else:
            gq0 = torch.zeros_like(x0)
        fc = prime_glm_cache(method, p, x0) if self.use_fcache else ()
        return obj_star, gq0, fc

    def _record_cached(self, p: Problem, s, x, loss, obj_star, pri_res):
        return _record(p, self.reg_name, self.opts, x, obj_star, loss,
                       pri_res)

    def _record_plain(self, p: Problem, s, x, obj_star, pri_res):
        return _record(p, self.reg_name, self.opts, x, obj_star, None,
                       pri_res)

    def _gap(self, p: Problem, s, x, loss, obj_star):
        return _gap(p, self.reg_name, x, loss, obj_star)

    def _step(self, p: Problem, s, c: State, raw_frel) -> State:
        """One epoch of one instance: the step, the stop test, k + 1
        (`iterate._Fused.step_epoch` on full batches)."""
        new, conv = _step_carry(
            self.method, self.step_fn, p, self.reg_name, s, self.opts, p.A,
            p.y, c, c.k + 1, raw_frel, self.use_fcache,
            gq_cached=c.gq if self.is_lbfgs else None)
        if not self.use_fcache:
            new["fcache"] = ()
        return State(**new, frel=raw_frel, k=c.k + 1, done=conv)

    def _batch_step(self, p: Problem, s, c: State, raw_frel, As, ys):
        """One mini-batch step of one instance on the rows (As, ys): the
        carry's new fields and the batch's stop test as ``done``
        (`iterate._Fused._step_batches`)."""
        new, conv = _step_carry(
            self.method, self.step_fn, p, self.reg_name, s, self.opts, As,
            ys, c, c.k + 1, raw_frel, False)
        new["fcache"] = ()
        return State(**new, frel=c.frel, k=c.k, done=conv)

    def _epoch_test(self, p: Problem, s, x, x_prev, raw_frel, pri_res):
        return _stopped(x, x_prev, raw_frel, pri_res, self.opts)

    # -- the loop, batched ---------------------------------------------------

    def load(self, prob: Problem, sm, run=None,
             max_epoch: Optional[int] = None, rng_seed: int = 0) -> None:
        """Start a solve of the batched ``prob`` with smoother ``sm``,
        eagerly: the buffers filled, each instance's epoch cache primed
        at its x0 and its ``obj_star``, the state and histories reset,
        and with mini-batches every epoch's permutation drawn from
        ``rng_seed``."""
        if self.buffers is not None:
            self.buffers.fill(prob, sm)
        max_epoch = self.opts.max_epoch if max_epoch is None else max_epoch
        obj_star, gq0, fc = self._vmap(self._prepare, prob, sm)
        x0 = prob.x0
        B, n = x0.shape
        dt, dev = x0.dtype, x0.device
        full = lambda v, dtype=dt: torch.full((B,), v, dtype=dtype,
                                              device=dev)
        mem = init_memory(n, self.method.m if self.is_lbfgs else 1, dt, dev)
        state = State(
            x=x0, x_prev=x0, gq=gq0, gq_prev=torch.zeros_like(x0),
            d_prev=torch.zeros_like(x0), cg_total=full(0, torch.int64),
            bnorm_prev=full(float("nan")), frel=full(float("inf")),
            k=full(0, torch.int32), pri_res=full(float("nan")),
            done=full(False, torch.bool),
            mem=LBFGSMemory(*(t.expand((B,) + t.shape) for t in mem)),
            fcache=fc)
        zeros = lambda: torch.zeros((B, self.cap), dtype=dt, device=dev)
        hist = History(
            fval=zeros(), obj=zeros(), rel=zeros(), objrel=zeros(),
            prires=torch.full((B, self.cap), float("nan"), dtype=dt,
                              device=dev),
            fvaltest=zeros(),
            metrics=torch.zeros((B, 0, self.cap), dtype=dt, device=dev),
            n_rec=full(0, torch.int32))
        if self.state is None:
            self.state, self.hist = _clone_tree(state), _clone_tree(hist)
            self.obj_star = obj_star.clone()
            self.max_epoch = torch.zeros((), dtype=torch.int32, device=dev)
            self.going = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            _assign(self.state, state)
            _assign(self.hist, hist)
            self.obj_star.copy_(obj_star)
        self.max_epoch.fill_(max_epoch)
        self.going.copy_(self.live().any())
        self.max_rounds = math.ceil(max_epoch / self.K) + 1
        if self.batching is not None:
            self._load_batches(prob, rng_seed)

    def _load_batches(self, prob: Problem, rng_seed: int) -> None:
        """The permutations of every epoch the loop can take, drawn on
        the host from ``rng_seed`` (each epoch the next draw, as in the
        scalar solve) and copied to the card before the solve."""
        dev = prob.device
        slots = self.cap - 1
        if self.batches is None:
            make = _StackedBatches if self.stacked else _Batches
            self.batches = make(prob, self.batching, slots)
            self.ep = torch.zeros((), dtype=torch.int64, device=dev)
            self.bact = torch.zeros((prob.x0.shape[0],), dtype=torch.bool,
                                    device=dev)
        b = self.batches
        b.start(_rng_pack(np.random.default_rng(rng_seed)), 0,
                self.opts.shuffle_batch)
        b.draw(slots)
        self.ep.zero_()

    def live(self) -> torch.Tensor:
        st = self.state
        return ~st.done & (st.k < self.max_epoch)

    def record(self, prob: Problem, sm, live: torch.Tensor) -> torch.Tensor:
        """One stats record of every instance at its iterate, written at
        its n_rec where ``live``; returns the raw relative gaps."""
        st, h = self.state, self.hist
        if self.use_fcache:
            vals, raw = self._vmap(self._record_cached, prob, sm, st.x,
                                   st.fcache.loss, self.obj_star, st.pri_res)
        else:
            vals, raw = self._vmap(self._record_plain, prob, sm, st.x,
                                   self.obj_star, st.pri_res)
        at = h.n_rec.long().unsqueeze(1)
        for buf, v in zip(h[:6], vals):
            cur = buf.gather(1, at).squeeze(1)
            buf.scatter_(1, at, torch.where(live, v.to(buf.dtype),
                                            cur).unsqueeze(1))
        h.n_rec.add_(live.to(torch.int32))
        return raw

    def _keep(self, new: State, where: torch.Tensor) -> None:
        """The state's tensors set to ``new``'s where ``where``: every
        value before the first copy, since vmap may hand back a buffer
        itself (x_prev is the old x)."""
        olds = _leaves(self.state)
        vals = [torch.where(_bcast(where, t), v, t)
                for t, v in zip(olds, _leaves(new))]
        for t, v in zip(olds, vals):
            t.copy_(v)

    def _batch(self, view: Problem, As, ys, sm, raw) -> None:
        """One mini-batch step of every instance still active in its
        epoch (``bact``), which it leaves where its stop test fires."""
        if self.stacked:
            new = self._vmap(self._batch_step, view, sm, self.state, raw,
                             As, ys)
        else:
            new = self._vmap(lambda p, s, c, r: self._batch_step(
                p, s, c, r, As, ys), view, sm, self.state, raw)
        act = self.bact.clone()
        self._keep(new, act)
        self.bact.copy_(act & ~new.done)

    def epoch_batches(self, prob: Problem, sm, live: torch.Tensor,
                      raw) -> None:
        """One epoch of mini-batches of every instance live in it: the
        full batches as one loop on the device while any instance is
        active, then the partial last batch, then each instance's stop
        test on its last step (`iterate._Fused._step_batches`)."""
        b, st = self.batches, self.state
        nb, _, rem = self.batching
        perm = b.rows(torch.clamp_max(self.ep, b.slots - 1))

        def batch():
            self._batch(*b.gather_full(prob, perm), sm=sm, raw=raw)
            b.bi.add_(1)
            b.blive.copy_((b.bi < nb) & self.bact.any())

        self.bact.copy_(live)
        b.bi.zero_()
        b.blive.copy_(self.bact.any())
        device_loop(b.blive, nb, batch)
        if rem:
            device_if(self.bact.any(), lambda: self._batch(
                *b.gather_rest(prob, perm), sm=sm, raw=raw))
        conv = self._vmap(self._epoch_test, prob, sm, st.x, st.x_prev, raw,
                          st.pri_res)
        st.frel.copy_(torch.where(live, raw, st.frel))
        st.k.copy_(torch.where(live, st.k + 1, st.k))
        st.done.copy_(torch.where(live, conv, st.done))
        self.ep.add_(1)

    def epoch(self, prob: Problem, sm, live: torch.Tensor, raw) -> None:
        """One epoch of every instance, kept where ``live``."""
        if self.batching is not None:
            self.epoch_batches(prob, sm, live, raw)
            return
        self._keep(self._vmap(self._step, prob, sm, self.state, raw), live)

    def gap(self, prob: Problem, sm) -> torch.Tensor:
        """The gap of each instance between stats records: exact from
        the cached loss, else the round's (`iterate._Fused.gap_now`)."""
        st = self.state
        if not self.use_fcache:
            return st.frel.clone()
        return self._vmap(self._gap, prob, sm, st.x, st.fcache.loss,
                          self.obj_star)

    def round(self, prob: Problem, sm) -> None:
        """One round for all instances: a stats record and an epoch, or
        with ``stats_every = K > 1`` a record and K epochs, each kept
        where its instance was live (the JAX package's vmap_safe round);
        then whether any instance is still live."""
        st = self.state
        live = self.live()
        raw = self.record(prob, sm, live)
        if self.K <= 1:
            self.epoch(prob, sm, live, raw)
        else:
            st.frel.copy_(torch.where(live, raw, st.frel))
            for _ in range(self.K):
                self.epoch(prob, sm, self.live(), self.gap(prob, sm))
        self.going.copy_(self.live().any())

    def solve(self, prob: Problem, sm) -> None:
        """The rounds until no instance is live: one WHILE node under
        capture."""
        device_loop(self.going, self.max_rounds,
                    lambda: self.round(prob, sm))

    def finish(self, prob: Problem, sm, width: int) -> SweepResult:
        """The final record of every instance at its terminating
        iterate, and the results (copies: the buffers serve the next
        solve)."""
        st, h = self.state, self.hist
        self.record(prob, sm, torch.ones_like(st.done))
        idx = (h.n_rec.long() - 1).clamp_min(0).unsqueeze(1)
        at = lambda buf: buf.gather(1, idx).squeeze(1)
        return SweepResult(
            x=st.x.clone(), obj=at(h.obj), fval=at(h.fval), rel=at(h.rel),
            epochs=st.k.clone(), pri_res_norm=st.pri_res.clone(),
            obj_hist=h.obj[:, :width].clone(), n_rec=h.n_rec.clone())


def solve(method, prob: Problem, reg_name: str, sm, opts: Options,
          spec: BatchSpec, *, width: Optional[int] = None,
          room: Optional[int] = None, capture: bool = True,
          rng_seed: int = 0) -> SweepResult:
    """Solve the B instances of ``prob`` and ``sm`` (their fields in
    ``spec`` batched on axis 0, ``prob.x0`` (B, n)) with ``opts``.

    ``width`` is the histories' width in the result (default
    ``opts.max_epoch + 1``) and ``room`` the records a capture makes
    room for (default ``width``): the waves of a path pass the largest
    budget of the path, so that every wave replays one capture.
    ``capture=False`` runs the bodies eagerly on the card. ``rng_seed``
    seeds the mini-batches' permutations."""
    method = dc_replace(method, kernels="torch")
    proto = instance(prob, spec.prob, 0)
    check(method, proto, opts, spec)
    if opts.local_max_iter is not None:
        opts = dataclasses.replace(opts, max_epoch=1)
    width = opts.max_epoch + 1 if width is None else width
    # a power of two: one capture serves the waves of smaller budgets
    cap = _room(max(width if room is None else room, opts.max_epoch + 1))
    on_card = prob.device.type == "cuda"
    if on_card and capture:
        def make(buffers, static, static_sm, cap_):
            loop = _Loop(method, reg_name, opts, spec, proto, cap_, buffers)
            loop.load(prob, sm, rng_seed=rng_seed)
            return loop, {"solve": lambda: loop.solve(static, static_sm)}

        entry = _captured(("batched", spec), method, prob, reg_name, sm,
                          opts, _NO_RUN, make, cap)
        if entry.loop.batching is not None:
            entry.loop._load_batches(prob, rng_seed)
        # a row shard's collectives: the load's eager ones end before the
        # graph's start, and the graph's before the final record's
        _quiesce(prob)
        entry.graphs["solve"].replay()
        _quiesce(prob)
        return entry.loop.finish(prob, sm, width)
    with graph.eager() if on_card else nullcontext():
        loop = _Loop(method, reg_name, opts, spec, proto, cap)
        loop.load(prob, sm, rng_seed=rng_seed)
        loop.solve(prob, sm)
        return loop.finish(prob, sm, width)


class _StackedBatches(_Batches):
    """`iterate._Batches` for a fleet whose instances stack their own A
    and y (B, m, ...): the same permutations, each batch's rows gathered
    from every instance's A at once (along axis 1)."""

    def __init__(self, prob: Problem, batching, slots: int):
        nb, bs, rem = batching
        A, y = prob.A, prob.y
        B, m = A.shape[0], A.shape[1]
        self.batching, self.m, self.mesh = batching, m, None
        dev = prob.device
        self.bi = torch.zeros((), dtype=torch.int64, device=dev)
        self.blive = torch.zeros((), dtype=torch.bool, device=dev)
        self.perm = torch.empty((slots, m), dtype=torch.int64, device=dev)
        self.Ab = A.new_empty((B, bs) + tuple(A.shape[2:]))
        self.yb = y.new_empty((B, bs) + tuple(y.shape[2:]))
        self.Ar = A.new_empty((B, rem) + tuple(A.shape[2:]))
        self.yr = y.new_empty((B, rem) + tuple(y.shape[2:]))
        self.gen, self.snaps, self.k_host = None, {}, 0

    def gather_full(self, prob: Problem, epoch):
        nb, bs, _ = self.batching
        rows = epoch[:nb * bs].view(nb, bs).index_select(
            0, self.bi.reshape(1)).reshape(-1)
        torch.index_select(prob.A, 1, rows, out=self.Ab)
        torch.index_select(prob.y, 1, rows, out=self.yb)
        return prob, self.Ab, self.yb

    def gather_rest(self, prob: Problem, epoch):
        nb, bs, _ = self.batching
        rows = epoch[nb * bs:]
        torch.index_select(prob.A, 1, rows, out=self.Ar)
        torch.index_select(prob.y, 1, rows, out=self.yr)
        return prob, self.Ar, self.yr
