"""The dense solve the port's dense Newton and GGN steps take
(`ops.linalg.dense_solve`): on the card LU factors and two triangular
solves (`_lu_triangular`, ROADMAP C14) in place of ``solve_ex``. Its
form is checked here on the CPU in float64 against ``torch.linalg.solve``
(relative 1e-12), for a vector and a matrix right-hand side, under
``torch.func.vmap`` (the batched solve), and with a singular matrix
(NaN and inf where ``solve_ex`` has them, no error)."""

import numpy as np
import pytest
import torch

from scso_tpu_torch.ops import linalg

RTOL = 1e-12


@pytest.mark.parametrize("n,k", [(1, 0), (2, 0), (10, 0), (50, 0), (10, 3),
                                 (64, 5)])
def test_lu_triangular_is_the_lu_solve(n, k):
    rng = np.random.default_rng(n + k)
    M = torch.tensor(rng.standard_normal((n, n)) + n * np.eye(n))
    b = torch.tensor(rng.standard_normal((n, k) if k else (n,)))
    want = torch.linalg.solve(M, b)
    got = linalg._lu_triangular(M, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    # unpivoted order would differ: a matrix that needs row swaps
    P = torch.tensor(rng.permutation(np.eye(n)))
    torch.testing.assert_close(linalg._lu_triangular(P @ M, P @ b), want,
                               rtol=RTOL, atol=0)
    assert torch.equal(linalg.dense_solve(M, b),
                       torch.linalg.solve_ex(M, b)[0])  # the CPU form


def test_lu_triangular_under_vmap_and_singular():
    rng = np.random.default_rng(7)
    M = torch.tensor(rng.standard_normal((4, 6, 6)) + 6 * np.eye(6))
    b = torch.tensor(rng.standard_normal((4, 6)))
    got = torch.func.vmap(linalg._lu_triangular)(M, b)
    torch.testing.assert_close(got, torch.linalg.solve(M, b), rtol=RTOL,
                               atol=0)
    S, ones = torch.zeros((3, 3), dtype=torch.float64), torch.ones(3)
    got = linalg._lu_triangular(S, ones.double())
    want = torch.linalg.solve_ex(S, ones.double())[0]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
