"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that plain version against the TPU kernel run in Pallas
interpret mode (as tests/test_pallas.py runs it), in float64 on the same
numpy inputs, at small block-boundary shapes with ragged m (so the
padded-label and masked-loss rules of the TPU kernel are exercised).
Tolerances: 1e-10 relative / 1e-12 absolute for the data kernels (sums
in another order), 1e-13 absolute for the elementwise update. The CUDA
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scso_tpu.algorithms.steps import _glm_kernel_fns
from scso_tpu.models import losses as jlosses
from scso_tpu.ops.pallas.glm_prep import _fused_glm_prep_pair
from scso_tpu.ops.pallas.matvec import _fused_normal_matvec
from scso_tpu.ops.pallas.score_update import _fused_update
from scso_tpu.ops.smoothers import phuber_grad, phuber_hess
from scso_tpu_torch.models.losses import LOGISTIC01_GLM
from scso_tpu_torch.ops.cuda import counters
from scso_tpu_torch.ops.cuda.glm_prep import (
    PairPrep, glm_prep_pair, glm_prep_pair_torch, max_n, prep_grid)
from scso_tpu_torch.ops.cuda.matvec import (
    normal_matvec, normal_matvec_torch, row_groups)
from scso_tpu_torch.ops.cuda.mglm_matvec import (
    TC_MAX_K, TC_MAX_P, mglm_grid, tc_geometry, tc_smem_bytes)
from scso_tpu_torch.ops.cuda.score_update import (
    CLUSTER_N, GRID_N, UpdateForm, cluster_slice, score_update,
    score_update_torch, update_blocks, update_form)
from scso_tpu_torch.ops.cuda.two_loop import (
    RESIDENT_BYTES, SMEM_BYTES, cluster_blocks, two_loop_plan)

torch.set_num_threads(1)

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _data(m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.1
    y = (rng.random(m) > 0.5).astype(np.float64)
    return rng, A, y


class TestNormalMatvec:
    @pytest.mark.parametrize("m,n", [(37, 128), (660, 256), (947, 384)])
    def test_plain_matches_pallas(self, m, n):
        rng, A, _ = _data(m, n, m)
        w, v = rng.random(m), rng.standard_normal(n)
        want = _fused_normal_matvec(jnp.asarray(A), jnp.asarray(w),
                                    jnp.asarray(v), interpret=True)
        _close(normal_matvec_torch(_t(A), _t(w), _t(v)), want)

    def test_wrapper_runs_plain_on_cpu_without_counting(self):
        rng, A, _ = _data(50, 30, 0)
        w, v = _t(rng.random(50)), _t(rng.standard_normal(30))
        counters.reset()
        got = normal_matvec(_t(A), w, v)
        assert torch.equal(got, normal_matvec_torch(_t(A), w, v))
        assert counters.snapshot()["normal_matvec"] == 0


class TestRowGroups:
    """K1's row groups, from the width alone (no card): the most groups
    of the 512 threads (a power of two, at most 16) that each hold a
    thread for every 16-byte chunk of a row, with v and every group's
    accumulator in 224 KB of shared memory."""

    # (n, v's itemsize, A in bfloat16, groups): the bench's narrow n in
    # float32 and bf16, its wide n (one group), and the edges
    CASES = [(1024, 4, False, 2), (1024, 4, True, 4), (1024, 8, False, 1),
             (10112, 4, False, 1), (10112, 4, True, 1), (128, 4, False, 16),
             (128, 4, True, 16), (2048, 4, False, 1), (2040, 4, True, 2),
             (4096, 4, True, 1), (1001, 4, True, 1), (130, 8, True, 2),
             (512, 8, False, 2)]

    @pytest.mark.parametrize("n,itemsize,narrow,groups", CASES)
    def test_groups(self, n, itemsize, narrow, groups):
        assert row_groups(n, itemsize, narrow) == groups

    @pytest.mark.parametrize("itemsize,narrow", [(4, False), (8, False),
                                                 (4, True), (8, True)])
    def test_every_group_has_a_thread_a_chunk_and_fits(self, itemsize,
                                                       narrow):
        chunk = 8 if narrow else 16 // itemsize
        for n in (1, 7, 8, 64, 100, 256, 777, 1024, 3000, 8192, 14336):
            g = row_groups(n, itemsize, narrow)
            assert g in (1, 2, 4, 8, 16)
            nc = n // chunk if n % chunk == 0 else n
            assert g == 1 or 512 // g >= nc
            assert (1 + g) * n * itemsize <= 224 * 1024


class TestGLMPrepPair:
    @pytest.mark.parametrize("m,n", [(37, 128), (500, 256), (1100, 384)])
    def test_plain_matches_pallas(self, m, n):
        rng, A, y = _data(m, n, m + 1)
        xt, xd = rng.standard_normal(n) * 0.3, rng.standard_normal(n) * 0.3
        rw_fn, w_fn, loss_fn = _glm_kernel_fns(jlosses.LOGISTIC01_GLM, m)
        want = _fused_glm_prep_pair(
            jnp.asarray(A), jnp.asarray(y), jnp.asarray(xt), jnp.asarray(xd),
            rw_fn, w_fn, loss_fn, interpret=True)
        got = glm_prep_pair_torch(_t(A), _t(y), _t(xt), _t(xd),
                                  LOGISTIC01_GLM)
        assert got._fields == PairPrep._fields
        for f, g, w_ in zip(got._fields, got, want):
            assert tuple(g.shape) == tuple(w_.shape), f
            _close(g, w_)

    def test_saturated_predictor_stays_finite(self):
        # |z| ≫ 20: the softplus identity shortcut of torch.nn.functional
        # would differ from jax.nn.softplus here; logaddexp does not
        rng, A, y = _data(64, 128, 9)
        x = np.full(128, 40.0) * np.sign(rng.standard_normal(128))
        rw_fn, w_fn, loss_fn = _glm_kernel_fns(jlosses.LOGISTIC01_GLM, 64)
        want = _fused_glm_prep_pair(
            jnp.asarray(A), jnp.asarray(y), jnp.asarray(x), jnp.asarray(-x),
            rw_fn, w_fn, loss_fn, interpret=True)
        got = glm_prep_pair_torch(_t(A), _t(y), _t(x), _t(-x),
                                  LOGISTIC01_GLM)
        for g, w_ in zip(got, want):
            assert bool(torch.isfinite(g).all())
            _close(g, w_)

    def test_wrapper_runs_plain_on_cpu(self):
        rng, A, y = _data(40, 20, 2)
        x = _t(rng.standard_normal(20))
        got = glm_prep_pair(_t(A), _t(y), x, x, LOGISTIC01_GLM)
        want = glm_prep_pair_torch(_t(A), _t(y), x, x, LOGISTIC01_GLM)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


class TestPrepGrid:
    """K2/K2s's form and launch geometry, from the shapes alone (no
    card): csrc/glm_prep.cuh's one-pass form holds 2·candidates (n,)
    accumulators in 224 KB of shared memory."""

    SMEM = 224 * 1024
    # (candidates, dtype, the last n of the one-pass form)
    LIMITS = [(2, torch.float32, 14336), (2, torch.float64, 7168),
              (1, torch.float32, 28672), (1, torch.float64, 14336)]
    BUCKETS = {2: range(1, 8), 1: (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14)}

    @pytest.mark.parametrize("candidates,dtype,limit", LIMITS)
    def test_wide_form_starts_just_past_the_limit(self, candidates, dtype,
                                                  limit):
        assert max_n(dtype, candidates) == limit
        e = 16 // dtype.itemsize
        for n in (limit - e, limit - 1, limit):
            assert prep_grid(1031, n, dtype, candidates, 132).form == \
                "one_pass"
        for n in (limit + 1, limit + e, 2 * limit):
            assert prep_grid(1031, n, dtype, candidates, 132).form == "wide"

    @pytest.mark.parametrize("candidates,dtype,limit", LIMITS)
    def test_uncovered_specs_take_the_split_form(self, candidates, dtype,
                                                 limit):
        # at any n, with the wide form's geometry (the same two passes)
        for n in (1, 1001, limit, limit + 1, 2 * limit):
            g = prep_grid(1031, n, dtype, candidates, 132, covered=False)
            assert g.form == "split"
            assert g.smem_bytes == g.chunks_per_thread == 0
            if n > limit:
                assert g == prep_grid(1031, n, dtype, candidates,
                                      132)._replace(form="split")

    @pytest.mark.parametrize("candidates", [1, 2])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("m,n,sms", [
        (1, 256, 132), (5, 1001, 132), (7, 128, 132), (1000, 10112, 132),
        (196608, 10112, 132), (524288, 1024, 132), (999, 1001, 114),
        (3, 64, 1), (65536, 7170, 132), (4099, 28676, 132)])
    def test_rows_and_columns_covered_once(self, candidates, dtype, m, n,
                                           sms):
        g = prep_grid(m, n, dtype, candidates, sms)
        # every row in exactly one block (or, wide, one row chunk), none
        # empty
        assert g.blocks * g.rows_per_block >= m
        assert (g.blocks - 1) * g.rows_per_block < m
        assert 0 <= g.smem_bytes <= self.SMEM
        if g.form == "wide":
            assert n > max_n(dtype, candidates)
            assert g.smem_bytes == 0 and g.chunks_per_thread == 0
            assert 1 <= g.row_blocks <= 8 * sms
            return
        e = 16 // dtype.itemsize
        nc = -(-n // e)
        assert g.row_blocks == g.blocks
        assert g.smem_bytes == 2 * candidates * nc * 16
        # one wave: every block resident at once, at the 128 registers a
        # thread the kernel may use, 2048 threads and 228 KB an SM
        per_sm = -(-g.blocks // sms)
        assert per_sm * g.threads * 128 <= 65536
        assert per_sm * g.threads <= 2048
        assert per_sm * (g.smem_bytes + 2048) <= 228 * 1024
        assert g.chunks_per_thread in self.BUCKETS[candidates]
        assert g.threads % 32 == 0 and 32 <= g.threads <= 512
        # every 16-byte column chunk owned by one thread
        assert g.threads * g.chunks_per_thread >= nc
        assert (g.threads - 32) * g.chunks_per_thread < nc

    def test_one_row_is_one_block(self):
        for candidates in (1, 2):
            g = prep_grid(1, 10112, torch.float32, candidates, 132)
            assert (g.form, g.blocks, g.rows_per_block) == ("one_pass", 1, 1)

    def test_main_shape_runs_the_one_pass_form(self):
        # 196608×10112 float32 on a 132-SM H100: one 512-thread block an
        # SM, 5 chunks a thread, K2's accumulators 161,792 B
        g = prep_grid(196608, 10112, torch.float32, 2, 132)
        assert g == ("one_pass", 132, 1490, 161792, 512, 5, 132, 0, 0, 0)
        assert prep_grid(196608, 10112, torch.float32, 1, 132).smem_bytes \
            == 80896


class TestMglmGrid:
    """K5's form and launch geometry, from the shapes alone (no card):
    csrc/mglm_matvec.cu's tensor-core form takes float32 up to k = 16
    and p = 1024, at any row alignment, and the two-pass form every
    other shape and float64; a spec whose curvature the kernel does not
    compute takes the split form."""

    SMEM = 227 * 1024

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_forms_switch_exactly_at_the_limits(self, dtype):
        one_read = "tensor" if dtype == torch.float32 else "two_pass"
        assert (TC_MAX_K, TC_MAX_P) == (16, 1024)
        for k in (1, 8, 9, 15, 16):
            for p in (1, 4, 77, 128, 132, 1020, 1022, 1024):
                assert mglm_grid(3001, p, k, dtype, 132).form == one_read
        for k, p in ((17, 1024), (16, 1025), (129, 77), (200, 8),
                     (1, 1028), (17, 4)):
            assert mglm_grid(3001, p, k, dtype, 132).form == "two_pass"

    def test_float64_never_takes_the_tensor_cores(self):
        for p, k in ((4, 1), (128, 8), (1024, 16), (1025, 16), (77, 200)):
            assert mglm_grid(999, p, k, torch.float64, 132).form != "tensor"

    def test_unaligned_float32_rows_take_the_tensor_cores(self):
        # rows that are not 16-byte aligned (p % 4 != 0, or an offset
        # view of A): the kernel copies them one float at a time
        for p in (1, 77, 1022, 1023):
            g = mglm_grid(999, p, 9, torch.float32, 132)
            assert g.form == "tensor" and g.smem_bytes == tc_smem_bytes(p, 9)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("m,p,k,sms", [
        (1, 4, 1, 132), (5, 8, 3, 132), (16, 1, 2, 132), (130, 128, 3, 132),
        (3001, 1024, 16, 132), (196608, 1024, 16, 132), (999, 252, 16, 114),
        (1031, 77, 200, 132), (300, 1025, 9, 132), (7, 512, 5, 1),
        (65536, 1024, 17, 132)])
    def test_rows_covered_once_within_the_budget(self, dtype, m, p, k, sms):
        for covered in (True, False):
            g = mglm_grid(m, p, k, dtype, sms, covered)
            # every row in exactly one block (or row chunk), none empty
            assert g.blocks * g.rows_per_block >= m
            assert (g.blocks - 1) * g.rows_per_block < m
            assert 0 <= g.smem_bytes <= self.SMEM
            assert g.threads % 32 == 0 and g.threads <= 1024
            if g.form == "tensor":
                assert g.blocks <= sms  # one block an SM, one wave
                w, pp, nt = tc_geometry(p, k)
                assert g.threads == 32 * w and pp >= p and 8 * nt >= k
                assert pp % (16 * w) == 0  # whole m16 tiles a warp
                assert g.smem_bytes == tc_smem_bytes(p, k)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_uncovered_specs_take_the_split_form(self, dtype):
        # at any shape, with the two-pass form's geometry
        for m, p, k in ((3001, 1024, 16), (999, 77, 9), (1031, 77, 200),
                        (300, 1025, 2), (1, 1, 1)):
            g = mglm_grid(m, p, k, dtype, 132, covered=False)
            assert g == mglm_grid(m, p, k, torch.float64, 132)._replace(
                form="split")

    def test_bench_shape_runs_the_tensor_cores(self):
        # 196608×1024×16 float32 on a 132-SM H100: 16 warps, 1,490 rows
        # a block, two 64 KB stages + 64 KB of V + the U partials
        g = mglm_grid(196608, 1024, 16, torch.float32, 132)
        assert g == ("tensor", 132, 1490, 214016, 512)


class TestScoreUpdate:
    @pytest.mark.parametrize("n", [1000, 8320])
    @pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
    def test_plain_matches_pallas(self, reg, n):
        rng = np.random.default_rng(n)
        x, d = rng.standard_normal(n), rng.standard_normal(n)
        mu, lam, ss, Mg = 0.8, 0.05, 0.5, 3.0
        lgr = lam * np.asarray(phuber_grad(jnp.asarray(x), mu))
        lgr[rng.random(n) < 0.1] = 0.0   # the lgr = 0 guard
        hr = np.asarray(phuber_hess(jnp.asarray(x), mu))
        lb, ub = np.full(n, -0.4), np.full(n, 0.4)
        xj, pri_j, eta_j, safe_j = _fused_update(
            *(jnp.asarray(a) for a in (x, d, lgr, hr, lb, ub)),
            lam, ss, Mg, reg, True)
        got = score_update_torch(
            _t(x), _t(d), _t(lgr), _t(hr), _t(lam), _t(ss), Mg,
            "l1" if reg == "none" else reg, use_prox=reg != "none",
            lb=_t(lb), ub=_t(ub))
        _close(got.x_new, xj, rtol=0, atol=1e-13)
        for g, w_ in ((got.pri, pri_j), (got.safe, safe_j),
                      (got.eta, eta_j)):
            assert float(g) == pytest.approx(float(w_), rel=1e-12)

    @pytest.mark.parametrize("what", ["runaway step", "nan eta"])
    @pytest.mark.parametrize("reg", ["l1", "l2", "indbox", "none"])
    def test_plain_keeps_non_finite_values_as_pallas(self, reg, what):
        # a diverging Newton step: NaN and ±inf in d, or a NaN η; the
        # prox must carry them into x⁺ (and pri, safe) as the kernel does,
        # never turn them into finite values
        n = 1000
        rng = np.random.default_rng(3)
        x, d = rng.standard_normal(n), rng.standard_normal(n)
        d[::7], d[1::11], d[2::13] = np.nan, np.inf, -np.inf
        lgr = 0.05 * rng.standard_normal(n)
        if what == "nan eta":
            lgr[n // 2] = np.nan
        hr = rng.random(n) + 1e-3
        lb, ub = np.full(n, -0.4), np.full(n, 0.4)
        xj, pri_j, eta_j, safe_j = _fused_update(
            *(jnp.asarray(a) for a in (x, d, lgr, hr, lb, ub)),
            0.05, 0.5, 3.0, reg, True)
        got = score_update_torch(
            _t(x), _t(d), _t(lgr), _t(hr), _t(0.05), _t(0.5), 3.0,
            "l1" if reg == "none" else reg, use_prox=reg != "none",
            lb=_t(lb), ub=_t(ub))
        assert not np.isfinite(np.asarray(xj)).all()
        # assert_allclose holds NaN to NaN and ±inf to the same ±inf
        _close(got.x_new, xj, rtol=0, atol=1e-13)
        for g, w_ in ((got.pri, pri_j), (got.safe, safe_j),
                      (got.eta, eta_j)):
            _close(g, w_, rtol=1e-12, atol=0)

    def test_zero_gradient_at_zero_curvature_is_not_nan(self):
        n = 16
        lgr = torch.zeros(n, dtype=torch.float64)
        lgr[:8] = 0.1
        hr = torch.ones(n, dtype=torch.float64)
        hr[8:] = 0.0     # 0/0 in the unguarded branch
        out = score_update(torch.ones(n, dtype=torch.float64),
                           torch.ones(n, dtype=torch.float64), lgr, hr,
                           0.1, 1.0, 2.0, "none", use_prox=False)
        assert bool(torch.isfinite(out.eta))
        assert float(out.eta) == pytest.approx((8 * 0.01) ** 0.5, rel=1e-14)

    def test_multi_block_form_only_past_the_one_block_limit(self):
        # the grid form (three launches) from GRID_N on, the cluster's
        # limit (swept on the H100: PERF.md §6)
        assert GRID_N == 1 << 20
        assert update_blocks(10112) == update_blocks(GRID_N - 1) == 0
        nb = update_blocks(GRID_N + 1)
        assert nb == 17  # slices of 65536, the last one value
        for n in (GRID_N, GRID_N + 1, 3 * GRID_N, 1 << 24, 1 << 40):
            nb = update_blocks(n)
            chunk = -(-n // nb)
            assert 1 <= nb <= 1024 and (nb - 1) * chunk < n <= nb * chunk
            assert update_form(n) == UpdateForm(nb, chunk, True)

    @pytest.mark.parametrize("max_cluster", [16, 8])
    def test_update_form_gates(self, max_cluster):
        # one block below CLUSTER_N, one cluster of the card's largest
        # size below GRID_N, the grid form from it on (swept on the H100)
        assert CLUSTER_N == 4096
        for n in (1, 7, 1024, CLUSTER_N - 1):
            assert update_form(n, max_cluster) == UpdateForm(
                1, cluster_slice(n, 1), False)
        for n in (CLUSTER_N, 10112, 1 << 16, GRID_N - 1):
            assert update_form(n, max_cluster) == UpdateForm(
                max_cluster, cluster_slice(n, max_cluster), False)
        assert update_form(GRID_N, max_cluster).grid
        # the main path's n: slices of 640 on 16 blocks, the last 512
        assert update_form(10112, 16) == UpdateForm(16, 640, False)

    @pytest.mark.parametrize("n", [1, 31, 32, 33, 513, 4097, 10112, 10240,
                                   10241, 1 << 24])
    @pytest.mark.parametrize("blocks", [1, 8, 16])
    def test_cluster_slices_cover_n(self, n, blocks):
        chunk = cluster_slice(n, blocks)
        assert chunk % 32 == 0 and chunk >= 32
        assert blocks * chunk >= n            # every value has a block
        assert chunk - 32 < -(-n // blocks)   # the even share, rounded up

    def test_rejects_unknown_reg_and_device(self):
        x = torch.ones(4, dtype=torch.float64)
        with pytest.raises(ValueError):
            score_update(x, x, x, x, 0.1, 1.0, 1.0, "gl")
        meta = torch.empty(4, device="meta")
        with pytest.raises(ValueError, match="meta"):
            score_update(meta, meta, meta, meta, 0.1, 1.0, 1.0, "l1")


class TestTwoLoopPlan:
    @pytest.mark.parametrize("n, max_cluster, want", [
        (1, 16, 1), (64, 16, 1), (512, 16, 1), (513, 16, 2), (2000, 16, 4),
        (4097, 16, 16), (10112, 16, 16), (10112, 8, 8), (1 << 30, 16, 16)])
    def test_cluster_blocks(self, n, max_cluster, want):
        # at least 512 values a block, a power of two, at most the card's
        assert cluster_blocks(n, max_cluster) == want

    def test_lbfgs_shape_is_resident(self):
        # m = 10, n = 10112, float32: 16 slices of 640; α/ρ, q and the
        # 10 S and Y slots of the slice in 53,840 bytes of shared memory
        assert two_loop_plan(10112, 10, 4) == (
            16, 640, True, True, True, 80 + 640 * 4 + 2 * 10 * 640 * 4)

    @pytest.mark.parametrize("itemsize, max_cluster, last", [
        (4, 16, 38912), (8, 16, 19456), (4, 8, 19456), (8, 8, 9728)])
    def test_residency_limit(self, itemsize, max_cluster, last):
        # m = 10: the largest n whose slices sit in shared memory
        inside = two_loop_plan(last, 10, itemsize, max_cluster)
        past = two_loop_plan(last + 1, 10, itemsize, max_cluster)
        assert inside.resident and inside.smem <= RESIDENT_BYTES
        assert not past.resident and past.q_smem
        assert past.smem == 2 * 10 * itemsize + past.chunk * itemsize

    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_alpha_rho_past_smem_bytes(self, itemsize):
        m = SMEM_BYTES // (2 * itemsize)   # 4096 float32, 2048 float64
        assert two_loop_plan(64, m, itemsize).alpha_smem
        past = two_loop_plan(64, m + 1, itemsize)
        assert not past.alpha_smem and not past.resident
        assert past.smem == 64 * itemsize   # q alone

    @pytest.mark.parametrize("n, m", [(1, 1), (777, 9), (100000, 10),
                                      (10112, 100), (64, 4100),
                                      (1 << 26, 10)])
    @pytest.mark.parametrize("itemsize", [4, 8])
    def test_plans_cover_n_within_shared_memory(self, n, m, itemsize):
        p = two_loop_plan(n, m, itemsize)
        assert p.blocks * p.chunk >= n and p.chunk % 32 == 0
        assert (p.blocks - 1) * p.chunk < n or p.blocks == 1
        assert p.smem <= RESIDENT_BYTES
        assert p.smem == (2 * m * itemsize * p.alpha_smem
                          + p.chunk * itemsize * p.q_smem
                          + 2 * m * p.chunk * itemsize * p.resident)
        if n == 1 << 26:   # q and r too large: the output's slice holds them
            assert not p.q_smem and not p.resident


def test_counters_reset_and_snapshot():
    counters.bump("score_update")
    assert counters.snapshot()["score_update"] >= 1
    counters.reset()
    assert set(counters.snapshot().values()) == {0}
