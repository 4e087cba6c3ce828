"""Metrics and data helpers (port of `scso_tpu.utils.metrics`).

The solver batches on the device itself (`iterate`'s ``batch_size``);
these helpers are the reference's, for users who iterate on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def mean_square_error(y, yhat):
    """mean((y − ŷ)²)."""
    y, yhat = torch.as_tensor(y), torch.as_tensor(yhat)
    return torch.mean((y - yhat) ** 2)


def slice_data(A, y, i):
    """The i-th one-sample slice (A[i:i+1], y[i:i+1])."""
    return A[i:i + 1], y[i:i + 1]


def batch_iter(A, y, batch_size: int, *, shuffle: bool = True, seed: int = 0):
    """Host-side mini-batches (A_batch, y_batch) of ``batch_size`` rows,
    in a permutation from ``np.random.default_rng(seed)`` when
    ``shuffle``; the last ragged batch is dropped."""
    m = A.shape[0]
    idx = np.arange(m)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for b in range(m // batch_size):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        if isinstance(A, torch.Tensor):
            sel = torch.from_numpy(sel).to(A.device)
        yield A[sel], y[sel]
