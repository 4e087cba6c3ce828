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
"""

from __future__ import annotations

import torch

from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.graph import is_batched

#: bytes of the upcast A a row block of a product on the card may hold
BLOCK_BYTES = 256 * 1024 * 1024


def widen(A, dtype):
    """A in ``dtype``: itself unless it is stored in bfloat16, else its
    exact upcast (an A-sized temporary)."""
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
    if not _blocked(A):
        return widen(A, v.dtype) @ v
    return torch.cat([Ab @ v for _, Ab in _row_blocks(A, v.dtype)])


def atmul(A, r):
    """Aᵀ·r for r of shape (m,) or (m, k), in r's dtype."""
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
