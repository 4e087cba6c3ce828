"""Row sharding over ``torch.distributed``.

Port of `scso_tpu.parallel.sharding` for the row-sharded data problem.
In the JAX package GSPMD places a `psum` after every contraction over
the rows of a sharded A. Here the solver runs rank-locally, SPMD, one
process per rank:
  * each rank holds its row shard of A and y (`shard_problem`, or
    `dataio.load_problem_rows_sharded` straight from disk);
  * every n-vector (x, the CG vectors, the cache's RHS and diagonal) is
    replicated, and each rank computes it bit for bit alike;
  * every contraction over rows ends in an explicit ``all_reduce``: the
    CG matvec (K1s, `ops.cuda.matvec.normal_matvec_sharded`) and the
    epoch prep's packed sums (`steps.prime_glm_cache`).
So every decision (the CG residual test, the greedy accept, the
stopping test, on the card or on the host) reads replicated values, and
the ranks stay in step. On the card the backend is NCCL, whose
collectives a captured solve records into its CUDA graph; gloo only
when the caller names it (the CPU, or several ranks on one card, which
NCCL refuses), and then a solve on the card cannot be captured (gloo
reduces CUDA tensors through the host).

Only ``all_reduce`` and ``broadcast`` are used: the two collectives gloo
also runs on CUDA tensors. The cached GGN-CG path is ported; feature
sharding, `replicate`, and everything else off that path raise
``NotImplementedError`` naming ROADMAP A11.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.problems import Problem


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of ranks: the process group, its axis name, its
    size and this process's rank in it. ``shape`` maps the axis name to
    the size, as `jax.sharding.Mesh.shape` does."""

    group: Any
    axis_names: tuple
    size: int
    rank: int

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


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
    ``rank``. A no-op when the group already exists.

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
            dist.init_process_group("nccl", device_id=dev, **kw)
        else:
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
    """The one-axis mesh over ``group`` (default: the whole world).

    ``shape`` defaults to ``(size,)`` and must equal it: a rank outside
    the mesh would miss its collectives. Meshes of more than one axis
    (the JAX package's ('batch', 'data') fleets) are not ported (ROADMAP
    A11)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call distributed_init() "
            "first (or torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    shape = (size,) if shape is None else tuple(shape)
    if len(shape) != 1 or len(tuple(axis_names)) != 1:
        raise NotImplementedError(
            f"mesh shape {shape} over axes {tuple(axis_names)}: only "
            "one-axis row meshes are ported (ROADMAP A11)")
    if shape[0] != size:
        raise ValueError(f"mesh shape {shape} needs {shape[0]} ranks; the "
                         f"group has {size}")
    return Mesh(group=group, axis_names=tuple(axis_names), size=size,
                rank=dist.get_rank(group))


def all_reduce_sum(mesh: Mesh, *tensors):
    """Sum each tensor over the mesh with ONE collective: the tensors
    (one dtype and device) are packed into a flat buffer, reduced, and
    returned as views of it, in their shapes."""
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, group=mesh.group)
    out, lo = [], 0
    for t in tensors:
        out.append(buf[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    return out


def replicate(tree, mesh: Mesh):
    """Not needed by the port: every rank builds its replicated state
    (x0, λ, bounds, x*) from the same numpy arrays."""
    raise NotImplementedError(
        "replicate is not ported: every rank builds its replicated "
        "tensors itself (ROADMAP A11)")


def shard_problem(prob: Problem, mesh: Mesh,
                  data_axis: str = "data") -> Problem:
    """Keep this rank's rows ``[r·m/S, (r+1)·m/S)`` of A and y, and of
    the low-precision copy ``A_lp`` when the problem has one.

    Everything else (x0, λ, bounds, x*) stays as it is, replicated. The
    problem records ``mesh``, ``data_axis`` and ``m_total = m``, the
    normalization count of its 1/m losses. m must divide the axis size:
    zero-row padding would silently change 1/m-normalized losses, so it
    raises rather than guess — pad explicitly with :func:`pad_rows`.
    One rank keeps A itself (no copy); more ranks copy their rows, so
    the caller's full A can be freed."""
    if prob.A is None or prob.y is None:
        raise ValueError("shard_problem requires a data problem (A, y)")
    if prob.mesh is not None:
        raise ValueError("the problem is already sharded")
    if data_axis not in mesh.axis_names:
        raise ValueError(f"axis {data_axis!r} is not in the mesh's "
                         f"{mesh.axis_names}")
    size = mesh.shape[data_axis]
    m = prob.A.shape[0]
    if m % size != 0:
        raise ValueError(
            f"m={m} not divisible by {data_axis!r}={size}: zero-row "
            "padding changes 1/m-normalized losses; pad the data (and its "
            "normalization) explicitly with scso_tpu_torch.parallel.pad_rows")
    lo, hi = mesh.rank * m // size, (mesh.rank + 1) * m // size
    rows = (lambda a: a) if size == 1 else (lambda a: a[lo:hi].clone())
    # precision-adaptive CG composes with row sharding: each rank's CG
    # matvecs read its rows of the copy (K1s with A in bfloat16)
    A_lp = None if prob.A_lp is None else rows(prob.A_lp)
    return dc_replace(prob, A=rows(prob.A), y=rows(prob.y), A_lp=A_lp,
                      mesh=mesh, data_axis=data_axis, m_total=m)


def shard_problem_features(prob: Problem, mesh: Mesh,
                           model_axis: str = "model") -> Problem:
    """Column sharding (the huge-n layout) is not ported."""
    raise NotImplementedError(
        "shard_problem_features (feature sharding) is not ported yet "
        "(ROADMAP A11)")


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
