"""Synthetic problem generators (numpy only).

Copies of `scso_tpu.models.synthetic.make_sparse_logreg_data` and
`make_multinomial_data` that do not import the JAX package: the same
seed gives bit-identical arrays. The native (OpenMP) generator and the
group-lasso generator are not ported yet (ROADMAP A12, A8).
"""

from __future__ import annotations

import numpy as np


def make_sparse_logreg_data(m: int, n: int, density: float = 0.01,
                            n_active: int = None, seed: int = 1234,
                            dtype=np.float32, label01: bool = False):
    """Random sparse-design logistic regression data.

    A ~ sprandn(m, n, density) densified, labels from a Bernoulli at a
    ground-truth x (zeros unless ``n_active``). ``label01=True`` gives
    0/1 labels (the coding the GGN pieces are derived for), else ±1.

    Returns (A, y, x0, x_true) as numpy arrays of ``dtype``.
    """
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), dtype=dtype)
    nnz = max(1, int(density * m * n))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    A[rows, cols] = rng.standard_normal(nnz).astype(dtype)
    x_true = np.zeros((n,), dtype=dtype)
    if n_active:
        idx = rng.choice(n, size=n_active, replace=False)
        x_true[idx] = rng.standard_normal(n_active).astype(dtype)
    p = 1.0 / (1.0 + np.exp(-(A @ x_true)))
    lo = 0.0 if label01 else -1.0
    y = np.where(rng.random(m) < p, 1.0, lo).astype(dtype)
    x0 = rng.standard_normal(n).astype(dtype)
    return A, y, x0, x_true


def make_multinomial_data(m: int, p: int, k: int, seed: int = 1234,
                          dtype=np.float32, scale: float = 1.0):
    """Dense-design softmax regression data; labels by the Gumbel-max
    trick (an exact sample from softmax(A·W_true)).

    Returns (A, Y_onehot, x0, x_true) with x_true = vec(W_true) — shapes
    (m, p), (m, k), (p·k,), (p·k,).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, p)).astype(dtype)
    W = (scale * rng.standard_normal((p, k))).astype(dtype)
    labels = np.argmax(A @ W + rng.gumbel(size=(m, k)), axis=-1)
    Y = np.eye(k, dtype=dtype)[labels]
    x0 = (0.01 * rng.standard_normal(p * k)).astype(dtype)
    return A, Y, x0, W.reshape(-1).astype(dtype)
