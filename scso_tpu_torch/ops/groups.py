"""Group structure for the (sparse-)group-lasso regularizer.

Port of `scso_tpu.ops.groups`. Groups are a dense integer
``segment_ids`` vector with per-group weights; the reference's ``Cmat``
(for the contiguous, non-overlapping groups it supports) is
``diag(element_weights)``, applied as an elementwise multiply.

The JAX package reduces over groups with `jax.ops.segment_sum`. Here
every group reduction is deterministic on the card, because the greedy
accept test reacts to the last ulp of the regularizer and
`index_add_` adds CUDA floats with atomics: the elements are put in
group order once, when the groups are built (``order``, None when the
ids are already sorted, as for contiguous groups and the pad group),
and `torch.segment_reduce` sums each group's run in a fixed order. It
takes the runs' ``offsets``: given lengths instead, it checks them by
reading the card from the host, which a CUDA graph's capture refuses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import frozen_dataclass
from scso_tpu_torch.ops.cuda.graph import is_batched


@frozen_dataclass
class Groups:
    """Static group structure over an ``n``-vector (the reference's
    `get_P` struct: group count, sizes and weights).

    Attributes:
      segment_ids: int64[n] — group index of each element (0-based).
      weights: float[n_groups] — per-group weight.
      element_weights: float[n] — ``weights[segment_ids]`` (the diagonal
        of the reference's ``Cmat``).
      n_groups: number of groups.
      n: number of elements.
      sizes: int64[n_groups] — elements per group.
      order: int64[n] permutation putting the elements in group order,
        or None when ``segment_ids`` is already sorted.
      offsets: int64[n_groups + 1] — where each group's run starts in
        group order, then n.
    """

    segment_ids: torch.Tensor
    weights: torch.Tensor
    element_weights: torch.Tensor
    n_groups: int
    n: int
    sizes: torch.Tensor
    order: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None

    def to(self, device=None, dtype=None) -> "Groups":
        """The same groups with the index tensors on ``device`` and the
        weights in ``dtype`` there (None keeps either)."""
        idx = lambda t: None if t is None else t.to(device=device)
        wts = lambda t: t.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self, segment_ids=idx(self.segment_ids),
            weights=wts(self.weights),
            element_weights=wts(self.element_weights),
            sizes=idx(self.sizes), order=idx(self.order),
            offsets=idx(self.offsets))


def make_groups(segment_ids, weights=None, *, n_groups=None, dtype=None,
                device="cpu") -> Groups:
    """Build a :class:`Groups` from a segment-id vector.

    Args:
      segment_ids: int[n] group index per element (0-based).
      weights: optional float[n_groups] group weights; default all ones.
      n_groups: number of groups; inferred from segment_ids if None.
      dtype: weight dtype; defaults to the weights' own floating dtype,
        else torch's default float type.
      device: where the tensors live (the CPU unless given: `make_problem`
        moves a problem's groups to its device and dtype).
    """
    seg = np.asarray(segment_ids, dtype=np.int64)
    if n_groups is None:
        n_groups = int(seg.max()) + 1 if seg.size else 0
    if dtype is None:
        if weights is not None and np.asarray(weights).dtype.kind == "f":
            dtype = torch.from_numpy(np.zeros((), np.asarray(
                weights).dtype)).dtype
        else:
            dtype = torch.get_default_dtype()
    w = (torch.ones((n_groups,), dtype=dtype) if weights is None
         else torch.as_tensor(np.asarray(weights)).to(dtype))
    sizes = np.bincount(seg, minlength=n_groups)[:n_groups]
    order = None
    if seg.size and np.any(np.diff(seg) < 0):
        order = torch.from_numpy(np.argsort(seg, kind="stable"))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    seg_t = torch.from_numpy(seg)
    return Groups(segment_ids=seg_t, weights=w, element_weights=w[seg_t],
                  n_groups=int(n_groups), n=int(seg.shape[0]),
                  sizes=torch.from_numpy(sizes.astype(np.int64)),
                  order=order, offsets=torch.from_numpy(offsets)).to(
                      device=device)


def make_groups_from_ind(n: int, ind, *, dtype=None,
                         device="cpu") -> Groups:
    """Groups from the reference's 3×G ``ind`` matrix: rows (group
    start, group end, group weight) with 1-based inclusive indices, the
    layout `get_P(n, G, ind)` consumes. Groups must be contiguous,
    non-overlapping and cover 1..n. The weights are in ``dtype``, else
    float64."""
    ind = np.asarray(ind)
    if ind.shape[0] != 3:
        raise ValueError(
            "ind must be a 3 x n_groups matrix (start, end, weight)")
    starts = ind[0].astype(np.int64) - 1
    ends = ind[1].astype(np.int64)
    weights = ind[2].astype(np.float64)
    segment_ids = np.zeros((n,), dtype=np.int64)
    for g, (s, e) in enumerate(zip(starts, ends)):
        segment_ids[s:e] = g
    return make_groups(segment_ids, weights, n_groups=ind.shape[1],
                       dtype=dtype, device=device)


def make_contiguous_groups(n: int, group_size: int, weights=None, dtype=None,
                           device="cpu") -> Groups:
    """Equal-size contiguous groups covering 0..n-1 (the last may be
    shorter)."""
    return make_groups(np.arange(n) // group_size, weights, dtype=dtype,
                       device=device)


# ---------------------------------------------------------------------------
# Segment reductions (the reference's Pmat/Cmat sparse matvecs)
# ---------------------------------------------------------------------------


def segment_sum(groups: Groups, v: torch.Tensor) -> torch.Tensor:
    """float[n_groups] — the sum of v within each group, each group's
    elements added in a fixed order (deterministic on the card, and
    without a host read there). Under vmap (a batched solve), where
    `segment_reduce` has no batching rule and would run once an
    instance, the sums are one product with the groups' 0/1 membership
    matrix (n × n_groups)."""
    if is_batched(v) or is_batched(groups.segment_ids):
        ids = torch.arange(groups.n_groups, device=v.device)
        member = (groups.segment_ids[:, None] == ids[None, :]).to(v.dtype)
        return v @ member
    if groups.order is not None:
        v = v[groups.order]
    return torch.segment_reduce(v, "sum", offsets=groups.offsets)


def group_sumsq(groups: Groups, z: torch.Tensor) -> torch.Tensor:
    """float[n_groups] — sum of squares of z within each group."""
    return segment_sum(groups, z * z)


def group_norms(groups: Groups, z: torch.Tensor) -> torch.Tensor:
    """float[n_groups] — two-norm of z within each group."""
    return torch.sqrt(group_sumsq(groups, z))


def lasso_fz(groups: Groups, z: torch.Tensor) -> torch.Tensor:
    """Weighted sum of group norms: Σ_g w_g · ‖z_g‖₂ (the group-lasso
    value of the reference's `get_reg(..., "gl")`)."""
    return torch.sum(groups.weights * group_norms(groups, z))


def spread(groups: Groups, per_group: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-group vector back to per-element (gather)."""
    return per_group[groups.segment_ids]


def prox_l2_scaled(groups: Groups, x, lam, h):
    """Scaled group soft-scaling prox: x_k · max(1 − λ·w_g / (h_k·‖x_g‖),
    0) (the reference's `ProxL2`; ``h`` is the elementwise metric)."""
    nrm = spread(groups, group_norms(groups, x))
    beta = lam * groups.element_weights
    denom = h * nrm
    pos = denom > 0
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    scale = torch.where(pos, 1.0 - beta / safe, torch.zeros_like(denom))
    return x * torch.clamp_min(scale, 0.0)


def proj_l2_scaled(groups: Groups, x, lam, h):
    """Scaled groupwise projection: x_k · min(λ·w_g / (h_k·‖(x/h)_g‖), 1)
    (the reference's `ProjL2`)."""
    nrm = spread(groups, group_norms(groups, x / h))
    beta = lam * groups.element_weights
    denom = h * nrm
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    scale = torch.where(denom > 0, beta / safe,
                        torch.full_like(denom, float("inf")))
    return x * torch.clamp_max(scale, 1.0)
