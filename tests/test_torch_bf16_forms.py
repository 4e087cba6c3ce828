"""The redesigned kernels with A in bfloat16, on the CPU: where the
wrappers pick them and the geometry they launch, from the shapes alone.

  * K2's and K2s's cluster form (csrc/glm_cluster.cuh,
    `glm_prep.cluster_grid`): picked exactly for A in bfloat16, float32
    candidates and a covered spec from n = 1025 up to `cluster_max_n`;
    float64, A in float32, n up to 1024 (and K2s past the cluster
    form's limit) and the split form keep their forms. Its shared memory fits a block at
    every shape it takes, its clusters cover every row once and its
    column slices every column once, 16-byte aligned.
  * K5's tensor-core form with A in bfloat16 (csrc/mglm_matvec.cu,
    namespace tcb): its ring and V's pieces fit at every p and k it
    takes, as many blocks an SM as its registers and shared memory hold,
    every row in exactly one block; the float32 geometry is unchanged.
  * The three-piece bfloat16 split of a float32 operand (K5's `split3`)
    is exact, so K5 keeps float32 accuracy.

The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scso_tpu_torch.ops.cuda import glm_prep as k2
from scso_tpu_torch.ops.cuda import mglm_matvec as k5

BF16 = torch.bfloat16
F32 = torch.float32
SMEM_BLOCK = 232448   # the shared memory a block may take on the H100
SMEM_SM = 228 * 1024  # the shared memory of an SM

# the shapes of the paths (main, secondary) and the form's limits
SHAPES = [(196608, 10112), (196608, 10000), (1, 1032), (5, 1025),
          (17, 2047), (3000, 2320), (3000, 2328), (3000, 3584), (3000, 3592),
          (3000, 4560), (3000, 4568), (3000, 7168), (3000, 7176),
          (1031, 10752), (1031, 10760), (1031, 14336), (262144, 4096),
          (999, 1031)]


def _slices(n, g):
    """(first chunk, chunks) of each block of a cluster-form grid."""
    nc = -(-n // 8)
    cb = k2._slice_chunks(n, g.cluster)
    return [(r * cb, max(0, min(cb, nc - r * cb))) for r in range(g.cluster)]


@pytest.mark.parametrize("candidates", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("a_dtype", [None, BF16])
def test_prep_grid_takes_the_cluster_form_exactly_for_k2_bf16_f32(
        candidates, dtype, a_dtype):
    top = k2.cluster_max_n()
    k2_bf16 = (dtype, a_dtype) == (F32, BF16)
    for n in (7, 8, 1024, 1025, 1032, 10112, top - 1, top):
        want = k2_bf16 and n > k2.CLUSTER_MIN_N
        g = k2.prep_grid(3001, n, dtype, candidates, 132, True, a_dtype)
        assert (g.form == "cluster") == want, (n, g)
        assert k2.takes_cluster(n, dtype, candidates, True, a_dtype) == want
        if k2_bf16 and not want:
            assert g.form == "one_pass"
        # a spec the kernels do not compute keeps the split form
        assert k2.prep_grid(3001, n, dtype, candidates, 132, False,
                            a_dtype).form == "split"
    # past it, the form A in dtype would take (K2s: one-pass to 28672)
    g = k2.prep_grid(3001, top + 8, dtype, candidates, 132, True, a_dtype)
    assert g.form == ("wide" if top + 8 > k2.max_n(dtype, candidates,
                                                   a_dtype) else "one_pass")
    if dtype == F32:
        assert g.form == ("one_pass" if candidates == 1 else "wide")


def test_cluster_form_ends_where_the_one_pass_form_did():
    # the one-pass form's K2 limit with A in bfloat16 and float32; the
    # one-pass form keeps n up to 1024 (the secondary shape's width)
    assert k2.cluster_max_n() == k2.max_n(F32, 2, BF16) == 14336
    assert k2.CLUSTER_MIN_N == 1024
    assert k2.CLUSTER_CANDIDATES == (1, 2)
    for c in (1, 2):
        g = k2.prep_grid(524288, 1024, F32, c, 132, True, BF16)
        assert (g.form, g.chunks_per_thread, g.threads) == ("one_pass", 1,
                                                            128)
        assert g == k2.one_pass_grid(524288, 1024, F32, c, 132, BF16)


def test_other_grids_are_unchanged_by_the_cluster_form():
    # the one-pass grid of K2 in float32 at the main shape, as before
    g = k2.prep_grid(196608, 10112, F32, 2, 132)
    assert g == ("one_pass", 132, 1490, 161792, 512, 5, 132, 0, 0, 0)
    for m, n in SHAPES:
        for dtype in (F32, torch.float64):
            for c in (1, 2):
                g = k2.prep_grid(m, n, dtype, c, 132, True, None)
                assert g.form != "cluster" and g[7:] == (0, 0, 0)


@pytest.mark.parametrize("candidates", [1, 2])
@pytest.mark.parametrize("m,n", SHAPES)
def test_cluster_grid_fits_and_covers_rows_and_columns_once(m, n,
                                                             candidates):
    g = k2.prep_grid(m, n, F32, candidates, 132, True, BF16)
    assert g.form == "cluster"
    c, r = g.cluster, g.group_rows
    assert g.chunks_per_thread == 1 and c in k2.CLUSTER_SIZES
    assert r in k2.CLUSTER_GROUP_ROWS
    assert k2.CLUSTER_STAGES[0] <= g.stages <= k2.CLUSTER_STAGES[1]
    # rows: contiguous ranges of whole groups, every row once
    assert g.rows_per_block % r == 0
    assert g.blocks * g.rows_per_block >= m
    assert (g.blocks - 1) * g.rows_per_block < m
    assert g.row_blocks == g.blocks
    # columns: a 16-byte chunk of 8 values a compute thread (the grid's
    # threads less the producer and spec warps), every column once
    sl = _slices(n, g)
    assert sum(p for _, p in sl) * 8 >= n > (sum(p for _, p in sl) - 1) * 8
    assert all(p > 0 for _, p in sl)
    assert max(p for _, p in sl) <= g.threads - 64
    assert g.threads - 64 < max(p for _, p in sl) + 32
    assert g.threads <= 512
    # shared memory of one block, and as many blocks an SM as the grid
    # assumes (one wave of clusters)
    assert g.smem_bytes == k2.cluster_smem_bytes(n, c, g.threads, r,
                                                 g.stages, candidates)
    assert g.smem_bytes <= 224 * 1024 <= SMEM_BLOCK
    per_sm = -(-g.blocks * c // 132)
    assert per_sm * (g.smem_bytes + 2048) <= SMEM_SM
    assert per_sm * g.threads * 128 <= 65536


def test_cluster_grid_at_the_main_shape():
    # 196608×10112: clusters of 3 blocks of 422 chunks of 8 values, 8-row
    # groups, 4 stages of 54 KB
    g = k2.prep_grid(196608, 10112, F32, 2, 132, True, BF16)
    assert (g.cluster, g.chunks_per_thread, g.threads, g.group_rows,
            g.stages, g.smem_bytes) == (3, 1, 512, 8, 4, 227520)
    # 524288×2048: one block a cluster and an SM, three stages of 16 rows
    g = k2.prep_grid(524288, 2048, F32, 2, 132, True, BF16)
    assert (g.cluster, g.threads, g.group_rows, g.stages) == (1, 320, 16, 3)
    assert g.blocks == 132


def test_cluster_grid_takes_what_the_card_holds():
    seen = []

    def fit(cluster, threads, smem, group_rows):
        seen.append((cluster, threads, smem, group_rows))
        return 13

    g = k2.prep_grid(196608, 10112, F32, 2, 132, True, BF16, fit)
    assert seen == [(3, 512, 227520, 8)]
    assert g.blocks == 13 and g.blocks * g.rows_per_block >= 196608
    # never more clusters than groups of rows
    g = k2.prep_grid(20, 10112, F32, 2, 132, True, BF16, fit)
    assert g.blocks == 3 and g.rows_per_block == 8


@pytest.mark.parametrize("n", list(range(1032, 14337, 488)) + [1025, 14329,
                                                               14336])
def test_every_n_of_the_cluster_form_fits_a_block(n):
    for m in (1, 999, 196608):
        g = k2.prep_grid(m, n, F32, 2, 132, True, BF16)
        assert g.form == "cluster" and g.smem_bytes <= 224 * 1024
        assert g.threads <= 512


@pytest.mark.parametrize("c,r,s", [(3, 8, None), (3, 8, 3), (4, 8, None),
                                   (4, 8, 4), (1, 16, 3), (1, 16, 4),
                                   (1, 8, None), (2, 16, 3)])
def test_cluster_grid_sweep_points(c, r, s):
    # the design points chip_ab.py sweeps at the main and narrow shapes
    for m, n in ((196608, 10112), (524288, 1024)):
        if -(-n // (8 * c)) > 448:
            continue
        g = k2.cluster_grid(m, n, 2, 132, cluster=c, group_rows=r, stages=s)
        assert (g.cluster, g.group_rows) == (c, r)
        assert s is None or g.stages == s
        sl = _slices(n, g)
        assert sum(p for _, p in sl) * 8 >= n
        assert g.blocks * g.rows_per_block >= m


# ---------------------------------------------------------------------------
# K5 with A in bfloat16
# ---------------------------------------------------------------------------

PS = [1, 100, 128, 129, 256, 512, 1000, 1024]
KS = [1, 3, 8, 16]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("k", KS)
def test_mglm_bf16_form_fits_at_every_p_and_k(p, k):
    w, pp, nt = k5.tc_geometry(p, k)
    s = k5.tc_stages(p, k, BF16)
    assert 3 <= s <= k5.TC_BF16_STAGES
    smem = k5.tc_smem_bytes(p, k, BF16)
    # the ring of s stages of 16 rows of pp + 8 values, V's and QU's
    # three pieces, the partial U, s mbarriers
    assert smem == (s * 16 * (pp + 8) * 2 + 3 * pp * nt * 16
                    + 4 * w * 16 * 8 * nt + 3 * nt * 32 * 8 + 8 * s)
    assert smem <= SMEM_BLOCK
    # one more stage would not fit, unless the stages are at their most
    if s < k5.TC_BF16_STAGES:
        assert smem + 16 * (pp + 8) * 2 + 8 > SMEM_BLOCK
    g = k5.mglm_grid(196608, p, k, F32, 132, a_dtype=BF16)
    per_sm = k5.tc_blocks_per_sm(p, k)
    assert g.form == "tensor" and g.smem_bytes == smem
    assert g.blocks <= per_sm * 132
    assert -(-g.blocks // 132) * (smem + 2048) <= SMEM_SM


@pytest.mark.parametrize("m", [1, 15, 16, 17, 3001, 196608, 524288])
@pytest.mark.parametrize("p", [77, 128, 256, 512, 1024])
def test_mglm_bf16_rows_once_in_whole_tiles(m, p):
    g = k5.mglm_grid(m, p, 16, F32, 132, a_dtype=BF16)
    assert g.rows_per_block % 16 == 0
    assert g.blocks * g.rows_per_block >= m
    assert (g.blocks - 1) * g.rows_per_block < m


def test_mglm_blocks_an_sm_by_padded_p():
    assert [k5.tc_blocks_per_sm(p, 16) for p in PS] == [3, 3, 3, 2, 2, 1, 1,
                                                        1]


@pytest.mark.parametrize("p,k", [(128, 8), (256, 16), (1024, 16), (77, 3)])
def test_mglm_float32_grid_is_unchanged(p, k):
    # A in float32: one block an SM, two 16-row stages, as before
    g = k5.mglm_grid(196608, p, k, F32, 132)
    rows = -(-196608 // 132)
    assert g == ("tensor", -(-196608 // rows), rows,
                 k5.tc_smem_bytes(p, k), 32 * k5.tc_geometry(p, k)[0])
    assert k5.tc_stages(p, k) == 2
    assert k5.mglm_grid(196608, 1024, 16, F32, 132).smem_bytes == 214016


def _split3(x):
    """K5's split3 on the CPU: three bfloat16 pieces, each the rounding
    of what the earlier ones leave."""
    h = x.to(BF16)
    r1 = x - h.float()
    md = r1.to(BF16)
    lo = (r1 - md.float()).to(BF16)
    return h, md, lo


def test_three_bf16_pieces_hold_a_float32_exactly():
    rng = np.random.default_rng(0)
    x = torch.tensor(np.concatenate([
        rng.standard_normal(20000), rng.standard_normal(2000) * 1e-20,
        rng.standard_normal(2000) * 1e20, [0.0, 1.0, -1.0, 3.0e-8]]),
        dtype=F32)
    h, md, lo = _split3(x)
    back = h.double() + md.double() + lo.double()
    assert torch.equal(back, x.double())
    # each product with a bfloat16 value is exact in float32
    a = torch.tensor(rng.standard_normal(24004), dtype=F32).to(BF16)
    for piece in (h, md, lo):
        prod = a.float() * piece.float()
        assert torch.equal(prod.double(), a.double() * piece.double())


def test_two_pieces_would_not_hold_float32():
    # the third piece is needed: hi + mid alone loses bits of most values
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(4096), dtype=F32)
    h, md, _ = _split3(x)
    assert not torch.equal(h.double() + md.double(), x.double())
