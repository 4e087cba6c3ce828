"""Sums over a process group that compose with ``torch.func``.

A rank-local SPMD solve sums partial results over the ranks of a mesh
axis with ``all_reduce``. An in-place collective has no batching rule,
so under ``torch.func.vmap`` (the batched solve, `algorithms.batched`)
it cannot run on a batched tensor, and under ``torch.func.grad`` /
``jvp`` it is invisible to the derivative. :func:`group_sum` is the sum
as a ``torch.autograd.Function`` with its three rules:

  * vmap: the whole batched tensor (B, ...) is reduced in ONE
    collective, whatever B is;
  * backward: the identity. Every rank evaluates the same replicated
    value from the sum, so the derivative of that value with respect to
    this rank's partial is the derivative with respect to the sum;
  * jvp: the sum of the tangents.

:func:`group_gather` places this rank's block at its offset of a zero
buffer and sums that buffer over the group: every rank's block, in rank
order, on every rank (exact: the other blocks add zeros). It uses only
``all_reduce``, which gloo also runs on CUDA tensors. Its backward takes
this rank's block of the gradient (the adjoint of the gather under the
same replicated-value rule), its jvp gathers the tangents.
:func:`group_slice`, this rank's block of a replicated vector, is its
adjoint: its backward gathers every rank's block of the gradient.

On a tensor that no ``torch.func`` transform wraps, both run the
collective in place on a fresh buffer, as the solve did before: the
same bits. Under a transform, a sum keeps the layout of each tensor it
is given (a packed sum copies its results back into clones of them), so
that a batched solve of a row shard of one rank computes the bits of
the unsharded batched solve.

Every sum of a solve goes through :func:`sum_in_place`. While a solve is
traced by ``torch.export`` (`ops.cuda.graph.exporting`,
`utils.deploy.export_solver`) it is the functional collective
(``torch.distributed._functional_collectives.all_reduce``: the ops
``_c10d_functional.all_reduce`` and ``wait_tensor``, which name the
group by its ``group_name``) copied into the tensor: the program then
holds the sums, and loads on every rank of a group of the same name. A
gather or a slice over more than one rank is refused there: it would
bake the exporting rank's offset into the program.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._C import _functorch

from scso_tpu_torch.ops.cuda.graph import exporting


def _wrapped(t: torch.Tensor) -> bool:
    return _functorch.is_functorch_wrapped_tensor(t)


def sum_in_place(t: torch.Tensor, group) -> None:
    """``t`` summed over ``group``, in place: ``dist.all_reduce``, or the
    functional collective while a solve is exported (see the module)."""
    if exporting():
        from torch.distributed import _functional_collectives as funcol

        t.copy_(funcol.all_reduce(t, "sum", group))
        return
    dist.all_reduce(t, group=group)


def _per_rank(what: str, size: int) -> None:
    if exporting() and size > 1:
        raise NotImplementedError(
            f"exporting a solve that takes a {what} over {size} ranks is not "
            "ported (ROADMAP A12): the program would hold the exporting "
            "rank's block; export a row shard, or serve this problem")


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A contiguous 1-D view of the dense tensor ``t``, whatever the
    order of its strides (a clone that kept a transposed layout)."""
    order = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    return t.permute(order).reshape(-1) if t.ndim else t.reshape(-1)


def _sum_into(group, ts):
    """Clones of ``ts`` that keep their layouts, summed over ``group``
    in ONE collective (one tensor: in place; more: packed)."""
    outs = [t.clone() for t in ts]
    flats = [_flat(o) for o in outs]
    if len(flats) == 1:
        sum_in_place(flats[0], group)
        return outs
    buf = torch.cat(flats)
    sum_in_place(buf, group)
    lo = 0
    for f in flats:
        f.copy_(buf[lo:lo + f.numel()])
        lo += f.numel()
    return outs


class _GroupSum(torch.autograd.Function):
    """Each tensor of ``ts`` (one dtype and device) summed over
    ``group``, in one collective. The results keep the layouts of the
    tensors given, so that what follows them computes the same bits as
    on the tensors themselves (a reduction's order follows the
    layout)."""

    @staticmethod
    def forward(group, *ts):
        return tuple(_sum_into(group, ts))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[0]

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs

    @staticmethod
    def jvp(ctx, _, *t_dots):
        return _GroupSum.apply(ctx.group, *t_dots)

    @staticmethod
    def vmap(info, in_dims, group, *ts):
        return _GroupSum.apply(group, *ts), tuple(in_dims[1:])


class _GroupGather(torch.autograd.Function):
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in group-rank order: the sum of zero buffers that each hold
    their rank's block."""

    @staticmethod
    def forward(t, group, rank, size, dim):
        w = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = w * size
        buf = t.new_zeros(shape)
        buf.narrow(dim, rank * w, w).copy_(t)
        sum_in_place(buf, group)
        return buf

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.rank, ctx.size, ctx.dim = inputs
        ctx.width = inputs[0].shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, t_dot, *_):
        return _GroupGather.apply(t_dot, ctx.group, ctx.rank, ctx.size,
                                  ctx.dim)

    @staticmethod
    def vmap(info, in_dims, t, group, rank, size, dim):
        bd = in_dims[0]
        if bd is None:
            return _GroupGather.apply(t, group, rank, size, dim), None
        # the logical dim of the physical tensor, batch dim moved first
        t = t.movedim(bd, 0)
        return _GroupGather.apply(t, group, rank, size, dim + 1), 0


class _GroupSlice(torch.autograd.Function):
    """This rank's block of a replicated ``v`` along ``dim``: its
    ``size``-th part at ``rank``. Each rank reads another block of the
    same value, so the derivative of the replicated result with respect
    to ``v`` sums every rank's block back in place: the backward is the
    gather (`_GroupGather`), the adjoint of this slice."""

    @staticmethod
    def forward(v, group, rank, size, dim):
        w = v.shape[dim] // size
        return v.narrow(dim, rank * w, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.rank, ctx.size, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        return (_GroupGather.apply(g, ctx.group, ctx.rank, ctx.size,
                                   ctx.dim), None, None, None, None)

    @staticmethod
    def jvp(ctx, v_dot, *_):
        w = v_dot.shape[ctx.dim] // ctx.size
        return v_dot.narrow(ctx.dim, ctx.rank * w, w)

    @staticmethod
    def vmap(info, in_dims, v, group, rank, size, dim):
        bd = in_dims[0]
        if bd is None:
            return _GroupSlice.apply(v, group, rank, size, dim), None
        v = v.movedim(bd, 0)
        return _GroupSlice.apply(v, group, rank, size, dim + 1), 0


def group_slice(v: torch.Tensor, group, rank: int, size: int,
                dim: int = 0) -> torch.Tensor:
    """This rank's block of the replicated ``v`` along ``dim`` (see
    `_GroupSlice`): a view where no transform differentiates it."""
    _per_rank("slice", size)
    if _wrapped(v) or v.requires_grad:
        return _GroupSlice.apply(v, group, rank, size, dim)
    return _GroupSlice.forward(v, group, rank, size, dim)


def group_sum(t: torch.Tensor, group, inplace: bool = False) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (see the module).
    ``inplace``: a ``t`` that no transform wraps is reduced in place (a
    buffer of the caller's own) and returned."""
    if _wrapped(t):
        return _GroupSum.apply(group, t)[0]
    if inplace:
        sum_in_place(t, group)
        return t
    return _sum_into(group, (t,))[0]


def group_sum_many(group, *ts):
    """Each of ``ts`` (one dtype and device) summed over ``group`` in ONE
    collective: packed into a flat buffer, reduced in place and returned
    as views of it, in their shapes; under a ``torch.func`` transform
    each in its tensor's layout (see the module)."""
    if any(_wrapped(t) for t in ts):
        return list(_GroupSum.apply(group, *ts))
    buf = torch.cat([t.reshape(-1) for t in ts])
    sum_in_place(buf, group)
    out, lo = [], 0
    for t in ts:
        out.append(buf[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    return out


def group_gather(t: torch.Tensor, group, rank: int, size: int,
                 dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``dim``, in rank order, on every rank
    (see the module); ``rank`` and ``size`` are this rank's and the
    group's."""
    _per_rank("gather", size)
    if _wrapped(t):
        return _GroupGather.apply(t, group, rank, size, dim)
    return _GroupGather.forward(t, group, rank, size, dim)
