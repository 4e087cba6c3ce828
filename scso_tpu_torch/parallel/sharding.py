"""Meshes of ranks, row sharding and feature sharding over
``torch.distributed``.

Port of `scso_tpu.parallel.sharding`. In the JAX package GSPMD places a
`psum` after every contraction over a sharded axis of A. Here the solver
runs rank-locally, SPMD, one process per rank:
  * `make_mesh` lays the ranks out on any number of named axes,
    rank-major as `jax.sharding.Mesh`, with one process group an axis
    line (`Mesh.axis_group`): the JAX package's ('data',), ('batch',
    'data'), ('model',) and ('data', 'model') layouts;
  * a row shard (`shard_problem`, or `dataio.load_problem_rows_sharded`
    straight from disk) keeps each rank's rows of A and y over the
    mesh's data axis; every n-vector (x, the CG vectors, the cache's RHS
    and diagonal) is replicated, and each rank computes it bit for bit
    alike; every contraction over rows ends in an explicit
    ``all_reduce`` over the data axis's group: the CG matvec (K1s,
    `ops.cuda.matvec.normal_matvec_sharded`) and the epoch prep's packed
    sums (`steps.prime_glm_cache`);
  * a column shard (`shard_problem_features`) keeps each rank's columns
    of A as an `ops.dense.ColShard`, whose products sum A·v and gather
    Aᵀu over the model axis; x stays replicated;
  * the batched solves (`sweep`) split their instances over a batch
    axis, and run the row sums of every instance in one collective
    (`ops.collective`);
  * `replicate` gives every rank the first rank's tensors.
So every decision (the CG residual test, the greedy accept, the
stopping test, on the card or on the host) reads replicated values, and
the ranks stay in step. On the card the backend is NCCL, whose
collectives a captured solve records into its CUDA graph (so the
process's groups are torn down with `distributed_shutdown`, which drops
those graphs first: ROADMAP C15); gloo only
when the caller names it (the CPU, or several ranks on one card, which
NCCL refuses), and then a solve on the card cannot be captured (gloo
reduces CUDA tensors through the host).

Only ``all_reduce`` and ``broadcast`` are used inside a solve: the two
collectives gloo also runs on CUDA tensors (a gather, where a dense dual
system needs every rank's rows or a column shard every rank's columns,
is an ``all_reduce`` of a zero buffer holding each rank's block). Every
single-instance method runs on a row shard, a column shard and both;
`Problem` gives the contracts f and its hooks must meet on each.

A captured (``mode='fused'``) solve over more than one NCCL rank puts
the collectives inside the CUDA graph's conditional nodes, which NCCL
allows only with ``NCCL_GRAPH_MIXING_SUPPORT=0`` in the environment
when the communicator is made: `distributed_init` (and `make_mesh`, for
the axis groups it makes) records whether it was (``Mesh.captures``),
and the solve reads that record, not the environment, which no longer
acts once the communicator exists. Over gloo a fused solve on the card
runs the same program uncaptured (`iterate._uncaptured`).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.ops.collective import group_gather, group_sum_many
from scso_tpu_torch.ops.cuda import graph
from scso_tpu_torch.ops.dense import ColShard
from scso_tpu_torch.problems import Problem


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: the process group of the whole mesh, its size
    and this process's rank in it, and for each axis (``axis_names``,
    ``sizes``) this rank's coordinate (``coords``) and the group of the
    ranks that differ from it only along that axis (``groups``: one
    process group an axis line). Ranks are laid out rank-major, as
    ``np.arange(size).reshape(sizes)`` lays out a `jax.sharding.Mesh`.
    ``shape`` maps each axis name to its size, as
    `jax.sharding.Mesh.shape` does. A one-axis mesh may be built from
    ``group``, ``axis_names``, ``size`` and ``rank`` alone."""

    group: Any
    axis_names: tuple
    size: int
    rank: int
    #: NCCL_GRAPH_MIXING_SUPPORT=0 was set when the NCCL communicator of
    #: the mesh's group and of every axis group was made: their
    #: collectives may sit inside a captured graph's conditional nodes
    #: (a fused solve over several NCCL ranks)
    captures: bool = False
    sizes: tuple = None
    coords: tuple = None
    groups: tuple = None

    def __post_init__(self):
        if self.sizes is None:
            if len(self.axis_names) != 1:
                raise ValueError("a mesh of several axes needs its sizes, "
                                 "coordinates and groups (make_mesh)")
            object.__setattr__(self, "sizes", (self.size,))
            object.__setattr__(self, "coords", (self.rank,))
            object.__setattr__(self, "groups", (self.group,))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} is not in the mesh's "
                             f"{self.axis_names}")
        return self.axis_names.index(name)

    def axis_group(self, name: str):
        """The group of this rank's line along axis ``name``."""
        return self.groups[self._axis(name)]

    def axis_size(self, name: str) -> int:
        return self.sizes[self._axis(name)]

    def axis_rank(self, name: str) -> int:
        """This rank's coordinate along axis ``name`` (its rank in
        :meth:`axis_group`)."""
        return self.coords[self._axis(name)]


#: whether each group made by `distributed_init` was made under
#: NCCL_GRAPH_MIXING_SUPPORT=0 (the WORLD group under the key None)
_MIXING_OFF: dict = {}


def _mixing_off() -> bool:
    return os.environ.get("NCCL_GRAPH_MIXING_SUPPORT") == "0"


def distributed_init(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device_id=None) -> int:
    """Join the process group; returns its size.

    ``backend=None`` is NCCL on the card ``device_id`` (default
    ``LOCAL_RANK``, else the rank modulo the cards of the host), which
    also becomes the current CUDA device; gloo only when named. With no
    ``init_method`` the rendezvous reads ``torchrun``'s environment
    (``env://``). Nothing tells a program of a cluster, so without
    torchrun pass ``init_method='tcp://host:port'``, ``world_size`` and
    ``rank``. A no-op when the group already exists. Tear the group
    down with `distributed_shutdown`, not ``dist.destroy_process_group``
    alone: over NCCL ranks that one waits for ever while a captured solve
    is cached (ROADMAP C15).

    A failed init does not raise: it warns and returns 1, and the
    process goes on without a group — but never silently: a multi-rank
    launch that fell back to one process would solve on 1/N of the
    rows (`make_mesh` then raises)."""
    if dist.is_initialized():
        return dist.get_world_size()
    kw = {} if init_method is None else {"init_method": init_method}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    try:
        if backend is None:
            if not torch.cuda.is_available():
                raise RuntimeError("NCCL needs a CUDA device "
                                   "(backend='gloo' runs on the CPU)")
            if device_id is None:
                r = int(os.environ.get("RANK", rank or 0))
                device_id = int(os.environ.get(
                    "LOCAL_RANK", r % torch.cuda.device_count()))
            dev = (torch.device("cuda", device_id)
                   if isinstance(device_id, int) else torch.device(device_id))
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
            # NCCL reads the variable as it makes the communicator (made
            # eagerly here, with device_id): record it now
            _MIXING_OFF[None] = _mixing_off()
            dist.init_process_group("nccl", device_id=dev, **kw)
        else:
            _MIXING_OFF.pop(None, None)
            dist.init_process_group(backend, **kw)
    except (RuntimeError, ValueError) as e:
        warnings.warn(
            f"torch.distributed.init_process_group did not complete ({e}); "
            "continuing in one process without a group. If this is a "
            "multi-rank launch, fix the backend/init_method/world_size/"
            "rank arguments: make_mesh needs the group.", stacklevel=2)
        return 1
    return dist.get_world_size()


def make_mesh(shape=None, axis_names: Sequence[str] = ("data",),
              group=None) -> Mesh:
    """The mesh of shape ``shape`` over the ranks of ``group`` (default:
    the whole world), one name an axis.

    ``shape`` defaults to ``(size,)``; its product must equal the
    group's size: a rank outside the mesh would miss its collectives.
    The ranks are laid out rank-major (``np.arange(size).reshape(shape)``
    of the group's ranks, as `jax.sharding.Mesh` and
    `torch.distributed.device_mesh.init_device_mesh` lay them out), and
    each axis line becomes a process group: every rank makes every line's
    group, in the same order (axis by axis, lines in rank-major order),
    including the groups it is not in, as ``new_group`` requires. A
    one-axis mesh is the group itself. ``captures`` records whether
    every NCCL communicator of the mesh was made under
    NCCL_GRAPH_MIXING_SUPPORT=0: for the group `distributed_init` made,
    as it saw the environment then; for the axis groups made here, as
    the environment is now (each is made, and its NCCL communicator
    initialized by one collective, before this returns)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call distributed_init() "
            "first (or torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    shape = (size,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes; "
                         f"{len(axis_names)} names given: {axis_names}")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis names {axis_names} repeat")
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"ranks; the group has {size}")
    made_here = group is dist.group.WORLD and None in _MIXING_OFF
    captures = _MIXING_OFF[None] if made_here else _mixing_off()
    rank = dist.get_rank(group)
    if len(shape) == 1:
        return Mesh(group=group, axis_names=axis_names, size=size,
                    rank=rank, captures=captures)
    members = np.asarray(dist.get_process_group_ranks(group))
    grid = members.reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    nccl = dist.get_backend(group) == "nccl"
    groups = []
    for a in range(len(shape)):
        # the lines along axis a: every other axis fixed, rank-major
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        mine = None
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line])
            if dist.get_rank() in line:
                mine = g
        groups.append(mine)
    captures = captures and _mixing_off()
    if nccl:
        # make each axis communicator now, where NCCL reads the setting
        # that ``captures`` recorded
        probe = torch.zeros((1,), device=torch.device(
            "cuda", torch.cuda.current_device()))
        for g in groups:
            dist.all_reduce(probe, group=g)
        torch.cuda.synchronize()
    return Mesh(group=group, axis_names=axis_names, size=size, rank=rank,
                captures=captures, sizes=shape, coords=coords,
                groups=tuple(groups))


def distributed_shutdown() -> None:
    """Tear down every process group of this process (the counterpart of
    `distributed_init`), after dropping every cached captured solve
    (`ops.cuda.graph.clear`) and waiting for the card.

    NCCL's teardown of a communicator waits until every CUDA graph that
    holds one of its collectives is destroyed, and the port keeps a
    captured solve's graph, cached, as long as its problem lives: a
    ``dist.destroy_process_group()`` while a captured solve of a row
    shard over NCCL ranks was still cached waited for ever (ROADMAP C15).
    Graphs held elsewhere (`graph.last_graphs`) must be dropped too. A
    no-op without a group."""
    if not dist.is_initialized():
        return
    graph.clear()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()
    _MIXING_OFF.clear()


def all_reduce_sum(mesh: Mesh, *tensors, axis: Optional[str] = None):
    """Sum each tensor over the mesh (over its axis ``axis`` when given)
    with ONE collective: the tensors (one dtype and device) are packed
    into a flat buffer, reduced, and returned as views of it, in their
    shapes. Under ``torch.func.vmap`` (the batched solve) every
    instance's tensors are reduced in the same one collective
    (`ops.collective.group_sum_many`), each result in its tensor's
    layout."""
    group = mesh.group if axis is None else mesh.axis_group(axis)
    return group_sum_many(group, *tensors)


def gather_rows(mesh: Mesh, t: torch.Tensor,
                axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), stacked in rank
    order along the first axis, on every rank (over the mesh's axis
    ``axis`` when given): ONE ``all_reduce`` of a zero buffer that holds
    this rank's block at its offset (exact: the other blocks add
    zeros)."""
    if axis is None:
        return group_gather(t, mesh.group, mesh.rank, mesh.size)
    return group_gather(t, mesh.axis_group(axis), mesh.axis_rank(axis),
                        mesh.axis_size(axis))


def _tree_map(fn, tree):
    """``fn`` applied to each tensor of ``tree`` (tensors, tuples, named
    tuples, lists, dicts and dataclasses, nested); other leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        ch = {f.name: _tree_map(fn, getattr(tree, f.name))
              for f in dataclasses.fields(tree)}
        ch = {k: v for k, v in ch.items() if v is not getattr(tree, k)}
        return dc_replace(tree, **ch) if ch else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on
    every rank: the port keeps per-rank tensors, so "replicated" means
    each rank holds the same values. Each tensor leaf is broadcast from
    the mesh's first rank over the whole mesh, onto this rank's device
    (under NCCL the current card; under gloo the leaf's own device).
    Leaves that are not tensors stay as they are. The tensors' shapes
    and dtypes are compared over the ranks first (one object gather):
    if they differ, every rank raises the same ValueError before any
    broadcast."""
    sig = []
    _tree_map(lambda t: sig.append((tuple(t.shape), str(t.dtype))) or t,
              tree)
    sigs = [None] * mesh.size
    dist.all_gather_object(sigs, sig, group=mesh.group)
    if any(s != sigs[0] for s in sigs):
        bad = next(r for r, s in enumerate(sigs) if s != sigs[0])
        raise ValueError(
            f"replicate: rank {bad} of the mesh holds tensors of other "
            f"shapes or dtypes than its first rank ({sigs[bad]} against "
            f"{sigs[0]})")
    src = dist.get_global_rank(mesh.group, 0) if (
        mesh.group is not dist.group.WORLD) else 0
    nccl = dist.get_backend(mesh.group) == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
           else None)

    def bcast(t):
        out = t.detach().to(dev if dev is not None else t.device,
                            copy=True).contiguous()
        dist.broadcast(out, src=src, group=mesh.group)
        return out

    return _tree_map(bcast, tree)


def shard_problem(prob: Problem, mesh: Mesh,
                  data_axis: str = "data") -> Problem:
    """Keep this rank's rows ``[r·m/S, (r+1)·m/S)`` of A and y, of the
    low-precision copy ``A_lp`` when the problem has one, and of the
    test set ``Atest``/``ytest``.

    Everything else (x0, λ, bounds, x*, ``col_sumsq``) stays as it is,
    replicated. The problem records ``mesh``, ``data_axis``, ``m_total
    = m`` and ``mtest_total``, the normalization counts of its 1/m
    losses; each function of the rows is then this rank's share, summed
    over the ranks, under the contract that f and its hooks are MEANS
    over the rows they are handed (`Problem`). m (and the test set's
    row count) must divide the axis size: zero-row padding would
    silently change 1/m-normalized losses, so it raises rather than
    guess — pad explicitly with :func:`pad_rows`. One rank keeps A
    itself (no copy); more ranks copy their rows, so the caller's full
    A can be freed."""
    if prob.A is None or prob.y is None:
        raise ValueError("shard_problem requires a data problem (A, y)")
    if prob.mesh is not None:
        raise ValueError("the problem is already sharded")
    if data_axis not in mesh.axis_names:
        raise ValueError(f"axis {data_axis!r} is not in the mesh's "
                         f"{mesh.axis_names}")
    size = mesh.axis_size(data_axis)
    m = prob.A.shape[0]
    mt = prob.Atest.shape[0] if prob.has_test else 0
    for what, rows in (("m", m), ("the test set's m", mt)):
        if rows % size != 0:
            raise ValueError(
                f"{what}={rows} not divisible by {data_axis!r}={size}: "
                "zero-row padding changes 1/m-normalized losses; pad the "
                "data (and its normalization) explicitly with "
                "scso_tpu_torch.parallel.pad_rows")

    rank = mesh.axis_rank(data_axis)

    def rows(a):
        if a is None or size == 1:
            return a
        if isinstance(a, ColShard):
            raise ValueError("shard the rows first, then the features "
                             "(shard_problem_features)")
        lo, hi = rank * a.shape[0] // size, (rank + 1) * a.shape[0] // size
        return a[lo:hi].clone()

    # precision-adaptive CG composes with row sharding: each rank's CG
    # matvecs read its rows of the copy (K1s with A in bfloat16)
    return dc_replace(prob, A=rows(prob.A), y=rows(prob.y),
                      A_lp=rows(prob.A_lp), Atest=rows(prob.Atest),
                      ytest=rows(prob.ytest), mesh=mesh,
                      data_axis=data_axis, m_total=m,
                      mtest_total=mt if prob.has_test else None)


def shard_problem_features(prob: Problem, mesh: Mesh,
                           model_axis: str = "model") -> Problem:
    """Column (feature) sharding, the huge-n layout: keep this rank's
    columns ``[r·p/M, (r+1)·p/M)`` of A and of the test set ``Atest``
    (p = n, or for a multi-output problem A's p columns of x viewed as
    (p, k)), as an `ops.dense.ColShard` whose products sum or gather over
    the mesh's axis ``model_axis``. Composes with a row shard on a 2-D
    ('data', 'model') mesh: pass a problem already row-sharded on the
    same mesh (its block of A is then its rows of its columns).

    x and every n-vector (x0, x*, the bounds, ``col_sumsq``) stay
    replicated, as on a row shard, so every decision (the CG residual
    test, the greedy accept, the stopping test) reads replicated values
    and K3 and K4 run as they do unsharded; A, which dominates the
    memory, is split. A·v is the local product summed over
    ``model_axis`` (m_r values), Aᵀu the local product gathered over it
    (n values; summed over the rows' axis by the solve, as on a row
    shard). The kernels that fuse a row's dot with its scatter (K1,
    K1s, K2, K2s, K5) cannot take a partial dot: a column shard takes
    their products route (`algorithms.steps`), as the JAX package's
    does; K3 and K4 still launch. The low-precision copy is dropped
    (``A_lp=None``; AUTO attaches none), as in the JAX package. f and
    its hooks must reach A only through `ops.dense` (the contract of
    `Problem`). A p that does not divide the axis size raises, as in the
    JAX package."""
    if not prob.has_data or prob.A.ndim != 2:
        raise ValueError("shard_problem_features requires a data problem "
                         "(A, y)")
    if isinstance(prob.A, ColShard):
        raise ValueError("the problem's features are already sharded")
    if prob.mesh is not None and prob.mesh is not mesh:
        raise ValueError("a row-sharded problem's features shard over the "
                         "same mesh (a 2-D ('data', 'model') mesh)")
    if prob.rows is not None:
        raise ValueError("shard the whole problem, not a mini-batch")
    M = mesh.axis_size(model_axis)
    p = prob.A.shape[1]
    if p % M != 0:
        raise ValueError(f"n={p} not divisible by {model_axis!r}={M}")
    group, rank = mesh.axis_group(model_axis), mesh.axis_rank(model_axis)
    cols = lambda a: None if a is None else ColShard(
        a, mesh, model_axis, group, rank, M)
    return dc_replace(prob, A=cols(prob.A), Atest=cols(prob.Atest),
                      A_lp=None)


def pad_rows(A, y, multiple: int):
    """Zero-pad (A, y) so the row count divides ``multiple``: tensors in
    PyTorch, anything else in numpy. Returns (A_pad, y_pad, m_orig).
    Remember: losses normalized by the row count must keep dividing by
    m_orig, not the padded m."""
    m = A.shape[0]
    pad = (-m) % multiple
    if pad == 0:
        return A, y, m
    if isinstance(A, torch.Tensor):
        zeros = lambda a: a.new_zeros((pad,) + tuple(a.shape[1:]))
        return torch.cat([A, zeros(A)]), torch.cat([y, zeros(y)]), m
    A, y = np.asarray(A), np.asarray(y)
    zeros = lambda a: np.zeros((pad,) + a.shape[1:], a.dtype)
    return (np.concatenate([A, zeros(A)]), np.concatenate([y, zeros(y)]),
            m)
