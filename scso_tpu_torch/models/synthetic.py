"""Synthetic problem generators.

Copies of `scso_tpu.models.synthetic.make_sparse_logreg_data`,
`make_group_lasso_problem`, `make_sparse_poisson_data`,
`make_multinomial_data` and `make_box_qp` that do not import the JAX
package: the same numpy calls in the same order, so the same seed gives
bit-identical arrays. ``make_sparse_logreg_data(backend='native')`` runs
the port's copy of the JAX package's OpenMP generator
(`scso_tpu_torch._native`): the same C++ and seed, the same stream.
"""

from __future__ import annotations

import numpy as np

from scso_tpu_torch.ops.groups import make_contiguous_groups


def make_sparse_logreg_data(m: int, n: int, density: float = 0.01,
                            n_active: int = None, seed: int = 1234,
                            dtype=np.float32, label01: bool = False,
                            backend: str = "numpy"):
    """Random sparse-design logistic regression data.

    A ~ sprandn(m, n, density) densified, labels from a Bernoulli at a
    ground-truth x (zeros unless ``n_active``). ``label01=True`` gives
    0/1 labels (the coding the GGN pieces are derived for), else ±1.

    ``backend='native'`` runs the OpenMP C++ generator
    (`scso_tpu_torch._native`, built on first use): another stream than
    numpy's (about density·n entries a row, Irwin–Hall normals), the
    JAX package's native stream for the same seed; for large data, not
    for oracle tests. Without a toolchain it falls back to numpy.

    Returns (A, y, x0, x_true) as numpy arrays of ``dtype``.
    """
    if backend == "native":
        from scso_tpu_torch import _native

        out = _native.sparse_logreg(m, n, density, n_active or 0, seed,
                                    label01)
        if out is not None:
            return tuple(a if a.dtype == dtype else a.astype(dtype)
                         for a in out)
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


def make_group_lasso_problem(m: int, n: int, grpsize: int,
                             p_active: float = 0.1, noise_std: float = 0.1,
                             seed: int = 1234, group_weights: float = 1.0,
                             corr: float = 0.0, dtype=np.float32):
    """Grouped sparse regression data: contiguous equal-size groups, a
    fraction ``p_active`` of them carrying signal, optional AR(1)-style
    feature correlation ``corr``, Gaussian observation noise.

    A is drawn as ``standard_normal((m, n))`` in float64 and then cast,
    as in the JAX package: at 262144×4000 that is an 8.4 GB host
    temporary, kept so that the data stay the same.

    Returns (A, y, x_true, x0, groups); groups are on the CPU, with
    weights in ``dtype``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(dtype)
    if corr > 0:
        for j in range(1, n):
            A[:, j] = corr * A[:, j - 1] + np.sqrt(1 - corr**2) * A[:, j]
    n_groups = (n + grpsize - 1) // grpsize
    active = rng.random(n_groups) < p_active
    if not active.any():
        active[rng.integers(0, n_groups)] = True
    x_true = np.zeros((n,), dtype=dtype)
    for g in range(n_groups):
        if active[g]:
            s, e = g * grpsize, min((g + 1) * grpsize, n)
            x_true[s:e] = rng.standard_normal(e - s).astype(dtype)
    y = (A @ x_true + noise_std * rng.standard_normal(m)).astype(dtype)
    x0 = rng.standard_normal(n).astype(dtype)
    weights = np.full((n_groups,), group_weights, dtype=dtype)
    groups = make_contiguous_groups(n, grpsize, weights=weights)
    return A, y, x_true, x0, groups


def make_sparse_poisson_data(m: int, n: int, density: float = 0.05,
                             n_active: int = None, seed: int = 1234,
                             dtype=np.float32, scale: float = 0.5):
    """Random sparse-design Poisson regression data (counts, log link):
    the sprandn design of :func:`make_sparse_logreg_data`, active
    coefficients ``scale``·N(0, 1), z = A·x_true clipped to [−8, 8],
    counts y ~ Poisson(exp(z)).

    Returns (A, y, x0, x_true)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), dtype=dtype)
    nnz = max(1, int(density * m * n))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    A[rows, cols] = rng.standard_normal(nnz).astype(dtype)
    x_true = np.zeros((n,), dtype=dtype)
    if n_active:
        idx = rng.choice(n, size=n_active, replace=False)
        x_true[idx] = (scale * rng.standard_normal(n_active)).astype(dtype)
    z = np.clip(A @ x_true, -8.0, 8.0).astype(np.float64)
    y = rng.poisson(np.exp(z)).astype(dtype)
    x0 = (0.01 * rng.standard_normal(n)).astype(dtype)
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


def make_box_qp(n: int, seed: int = 1234, dtype=np.float32):
    """Random strongly convex box QP: Q = sym(randn) + n·I.

    Returns (Q, c, x0) as numpy arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n)).astype(dtype)
    Q = np.tril(Q)
    Q = Q + Q.T - np.diag(np.diag(Q))
    Q = Q + n * np.eye(n, dtype=dtype)
    c = np.ones((n,), dtype=dtype)
    x0 = rng.standard_normal(n).astype(dtype)
    return Q.astype(dtype), c, x0
