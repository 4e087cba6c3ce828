"""Products of the data matrix that run outside the kernels.

The gradient, the closed-form f and Hessian, the greedy trial's
predictor, the multi-output prep and the unfused GGN prep multiply A by
a vector or a matrix with `torch.matmul`, as the JAX package leaves them
to XLA. A may be stored in bfloat16 (the coarse phase of
`algorithms.mixed.iterate_mixed`, where A itself is cast), with the
other operand in float32 or float64. JAX promotes such a product to the
wider type; PyTorch refuses it. These functions take A in the other
operand's dtype, where they are the plain products, or in bfloat16,
where A's values are upcast exactly first:
  * on the CPU, the whole of A at once (an A-sized temporary);
  * on the card, row blocks of at most :data:`BLOCK_BYTES` of the
    upcast A, each multiplied by `torch.matmul` as it is made, the
    blocks' sums added in row order: no A-sized temporary (7.95 GB at
    196608×10112 float32). Each such call counts once in
    `counters.bf16_products()`.

On a column shard (`parallel.shard_problem_features`) A is a
:class:`ColShard`: this rank's block of A's columns (and, on a 2-D mesh,
of its rows). There each product is the block's product plus a
collective over the mesh's model axis (`ops.collective`, which
``torch.func`` differentiates and batches): A·v sums the block's partial
products (m_r values), Aᵀu gathers every rank's columns (n values),
Σᵢ wᵢAᵢⱼ² likewise, and the Gram matrix Aᵀdiag(w)A (:func:`gram`) and
:func:`widen` gather A's other columns first. Those two exist for the
dense n×n solves (the Newton Hessian, the GGN Jacobian), which only run
where n is small, so holding all n columns of this rank's rows there is
acceptable. Any other use of a ColShard — ``A @ x``, ``A.T``, a torch
function — raises the same ValueError on every rank, at the same point:
f and its hooks must reach A only through these functions.
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.collective import (
    group_gather, group_slice, group_sum)
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.graph import is_batched

#: bytes of the upcast A a row block of a product on the card may hold
BLOCK_BYTES = 256 * 1024 * 1024

_CONTRACT = (
    "A is column-sharded (shard_problem_features): f and its hooks may "
    "reach A only through scso_tpu_torch.ops.dense (amul, atmul, "
    "sq_atmul, gram, widen) and A.shape; {what} is not one of them")


class ColShard:
    """This rank's block of a column-sharded A: ``block`` holds the
    columns ``[lo, hi)`` (and on a 2-D mesh this rank's rows) of A;
    ``group``, ``rank`` and ``size`` are the mesh's model axis.
    ``shape`` is (rows held, all columns), as f and its hooks see A.
    Row selections (``A[rows]``) stay column shards; every other use
    raises (see the module)."""

    def __init__(self, block: torch.Tensor, mesh, axis: str, group,
                 rank: int, size: int, cols: bool = True):
        p = block.shape[1]
        if cols:
            lo, hi = rank * p // size, (rank + 1) * p // size
            block = block[:, lo:hi].contiguous()
        self.block, self.mesh, self.axis = block, mesh, axis
        self.group, self.rank, self.size = group, rank, size
        self.width = block.shape[1]
        self.lo = rank * self.width
        self.shape = torch.Size((block.shape[0], self.width * size))

    def with_block(self, block) -> "ColShard":
        """A column shard of the same columns with ``block`` as its
        rows."""
        return ColShard(block, self.mesh, self.axis, self.group, self.rank,
                        self.size, cols=False)

    ndim = 2
    dtype = property(lambda self: self.block.dtype)
    device = property(lambda self: self.block.device)

    def element_size(self) -> int:
        return self.block.element_size()

    def __getitem__(self, rows):
        if isinstance(rows, tuple):
            raise ValueError(_CONTRACT.format(what="a column index"))
        return self.with_block(self.block[rows])

    def contiguous(self):
        return self.with_block(self.block.contiguous())

    def to(self, dtype):
        return self.with_block(self.block.to(dtype))

    def cols(self, v):
        """This rank's columns' share of the operand ``v`` ((p,) or
        (p, k)): its rows [lo, hi) (under ``torch.func`` a slice whose
        derivative gathers every rank's block, `ops.collective`)."""
        return group_slice(v, self.group, self.rank, self.size)

    def gather(self, part):
        """Every rank's (width, ...) ``part`` stacked into (p, ...)."""
        return group_gather(part, self.group, self.rank, self.size)

    def sum(self, part):
        """Every rank's (fresh) partial product ``part`` summed."""
        return group_sum(part, self.group, inplace=True)

    def __repr__(self):
        return (f"ColShard(shape={tuple(self.shape)}, columns "
                f"[{self.lo}, {self.lo + self.width}), axis={self.axis!r})")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise ValueError(_CONTRACT.format(what=f"A.{name}"))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise ValueError(_CONTRACT.format(
            what=getattr(func, "__name__", str(func))))

    def _refuse(self, *_):
        raise ValueError(_CONTRACT.format(what="an operator on A"))

    __matmul__ = __rmatmul__ = __mul__ = __rmul__ = __add__ = __radd__ = \
        __sub__ = __rsub__ = __truediv__ = __neg__ = __pow__ = __array__ = \
        __iter__ = __len__ = _refuse


def is_colshard(A) -> bool:
    return isinstance(A, ColShard)


def widen(A, dtype):
    """A in ``dtype``: itself unless it is stored in bfloat16, else its
    exact upcast (an A-sized temporary). On a column shard, this rank's
    rows with every rank's columns (one gather; see the module)."""
    if isinstance(A, ColShard):
        return A.gather(widen(A.block, dtype).T.contiguous()).T
    return A.to(dtype) if A.dtype == torch.bfloat16 else A


def _blocked(A) -> bool:
    """True for a bfloat16 A on the card: multiply it by row blocks."""
    if A.dtype != torch.bfloat16 or A.device.type == "cpu":
        return False
    counters.bump_product()
    return True


def _row_blocks(A, dtype):
    """(rows, the block upcast to ``dtype``) over A in row order, one
    block alive at a time."""
    m, n = A.shape
    step = max(1, BLOCK_BYTES // max(1, n * dtype.itemsize))
    for r in range(0, m, step):
        yield slice(r, min(m, r + step)), A[r:r + step].to(dtype)


def amul(A, v):
    """A·v for v of shape (n,) or (n, k), in v's dtype."""
    if isinstance(A, ColShard):
        return A.sum(amul(A.block, A.cols(v)))
    if not _blocked(A):
        return widen(A, v.dtype) @ v
    return torch.cat([Ab @ v for _, Ab in _row_blocks(A, v.dtype)])


def atmul(A, r):
    """Aᵀ·r for r of shape (m,) or (m, k), in r's dtype."""
    if isinstance(A, ColShard):
        return A.gather(atmul(A.block, r))
    if not _blocked(A):
        return widen(A, r.dtype).T @ r
    out = None
    for rows, Ab in _row_blocks(A, r.dtype):
        part = Ab.T @ r[rows]
        out = part if out is None else out + part
    return out


def sq_atmul(A, w):
    """Σᵢ wᵢ·Aᵢⱼ², squared after the upcast: for w of shape (m,) the
    Jacobi diagonal (n,) of a GLM, for w of shape (m, k) the (n, k) one
    of a multi-output GLM (the JAX package's einsums "i,ij,ij->j" and
    "ic,ij,ij->jc", which promote A before they square it). Under vmap
    (the batched solve) a GLM's diagonal is the product (A∘A)ᵀ·w, one
    matrix product for all instances: the einsum would form w∘A∘A for
    each instance."""
    if isinstance(A, ColShard):
        return A.gather(sq_atmul(A.block, w))
    if not _blocked(A):
        A = widen(A, w.dtype)
        if w.ndim == 1 and not is_batched(w):
            return torch.einsum("i,ij,ij->j", w, A, A)
        return torch.square(A).T @ w
    out = None
    for rows, Ab in _row_blocks(A, w.dtype):
        if w.ndim == 1:
            part = torch.einsum("i,ij,ij->j", w[rows], Ab, Ab)
        else:
            part = torch.square(Ab).T @ w[rows]
        out = part if out is None else out + part
    return out


def gram(A, w=None):
    """Aᵀ·diag(w)·A (AᵀA for ``w`` None), in A's compute dtype (w's, or
    float for a bfloat16 A without w): the dense Hessian of a GLM, made
    as the JAX package's losses make it. On a column shard this rank's
    rows with every column (:func:`widen` gathers them)."""
    dtype = w.dtype if w is not None else (
        torch.float32 if A.dtype == torch.bfloat16 else A.dtype)
    A = widen(A, dtype)
    return A.T @ A if w is None else (A.T * w) @ A
