"""Mini-batch solves of the port against scso_tpu (float64, CPU).

``batch_size`` / ``slice_samples`` / ``shuffle_batch`` / ``rng_seed``:
⌊m/bs⌋ full batches of each epoch's permutation of the rows and a
partial last batch of the remaining rows, each an uncached step, with
the reference's per-batch stop test.
  * fused mode unshuffled and timed mode shuffled (both packages draw
    the timed permutations with ``np.random.default_rng(rng_seed)``; the
    JAX package's fused mode draws with jax.random, which the port does
    not reproduce) against the JAX package's histories to 1e-10, for the
    Newton-CG, GGN-CG and L-BFGS steps, on a 400×16 problem in batches
    of 96 (four full batches and one of 16 rows);
  * the port's fused mode against its timed mode, shuffled: bit for bit
    (the same host-drawn permutations);
  * test_algs.py's partial batch, m = 100 in batches of 32 (32, 32, 32,
    4): L-BFGS to 1e-10; Newton-CG (its case there) to 1e-7 and near the
    full-batch solve — a 4-row batch of 20 features is rank deficient,
    and CG turns the packages' last-ulp differences in it into 1e-9-size
    ones within a few epochs;
  * ``slice_samples`` (one row a batch; ``batch_size`` first), the
    ``verbose > 2`` batch ticks of timed mode as the JAX package prints
    them, AUTO's bfloat16 copy refused under batching, and a rank's
    padded rows of each batch on a row shard.
"""

import re

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.algorithms.iterate import Options as JOptions
from scso_tpu.algorithms.iterate import _auto_lp as j_auto_lp
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import iterate as titerate
from scso_tpu_torch.models import losses

torch.set_num_threads(1)

METHODS = {
    "newton": lambda p, **k: p.ProxNSCORE(solver="cg", **k),
    "ggn": lambda p, **k: p.ProxGGNSCORE(solver="cg", **k),
    "lbfgs": lambda p, **k: p.ProxLQNSCORE(**k),
}
# no alpha: the damped half steps (ss_type 1 without L) and BB for
# L-BFGS; full steps on mini-batches run away on these problems
KW = dict(max_epoch=6, x_tol=1e-12, f_tol=1e-12, verbose=0, rng_seed=3)


def _problems(m=400, n=16, density=0.3, lam=0.05, dtype=np.float64):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=density, n_active=5, seed=5, dtype=dtype,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=dtype)
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.from_numpy(
                        np.zeros(1, dtype)).dtype, device="cpu")
    return pj, pt


def _both(name, pj, pt, **kw):
    kw = dict(KW, **kw)
    sj = scso.iterate(METHODS[name](scso, kernels="xla"), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **kw)
    s = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **kw)
    return sj, s


def _same(s, sj, tol=1e-10):
    assert s.epochs == sj.epochs and len(s.obj) == len(sj.obj)
    assert bool(torch.isfinite(s.obj).all() and torch.isfinite(s.x).all())
    assert float(s.obj[-1]) < float(s.obj[0])
    for f in ("obj", "fval", "rel", "objrel"):
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   np.asarray(getattr(sj, f)), rtol=tol)
    pri = np.asarray(sj.pri_res_norm)[1:]
    np.testing.assert_allclose(s.pri_res_norm[1:].numpy(), pri, rtol=tol,
                               atol=tol * np.abs(pri).max())
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("stats_every", [1, 3])
@pytest.mark.parametrize("name", list(METHODS))
def test_fused_unshuffled_matches(name, stats_every):
    sj, s = _both(name, *_problems(), batch_size=96, shuffle_batch=False,
                  stats_every=stats_every)
    _same(s, sj)


@pytest.mark.parametrize("name", list(METHODS))
def test_timed_shuffled_matches(name):
    sj, s = _both(name, *_problems(), batch_size=96, mode="timed")
    _same(s, sj)
    assert len(s.times) == len(s.obj)


@pytest.mark.parametrize("stats_every", [1, 3])
@pytest.mark.parametrize("name", list(METHODS))
def test_fused_is_timed_bitwise(name, stats_every):
    """The port's two modes draw the same permutations from the host's
    generator: the same steps, bit for bit, and the same generator
    state at the end."""
    _, pt = _problems()
    kw = dict(KW, batch_size=96, stats_every=stats_every)
    run = lambda mode: st.iterate(METHODS[name](st), pt, "l1",
                                  st.PHuberSmootherL1L2(1.0), mode=mode,
                                  **kw)
    f, t = run("fused"), run("timed")
    assert f.epochs == t.epochs == KW["max_epoch"]
    assert torch.equal(f.x, t.x)
    if stats_every == 1:
        assert torch.equal(f.obj, t.obj)
    assert torch.equal(f.state.rng, t.state.rng)
    # the generator advanced by one permutation an epoch
    gen = np.random.default_rng(KW["rng_seed"])
    for _ in range(f.epochs):
        gen.permutation(400)
    assert torch.equal(f.state.rng, titerate._rng_pack(gen))


@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_partial_last_batch_m100_bs32(mode):
    """tests/test_algs.py's m = 100, batch_size = 32 (32, 32, 32, 4)."""
    pj, pt = _problems(100, 20, lam=0.05)
    shuffle = mode == "timed"
    sj, s = _both("lbfgs", pj, pt, batch_size=32, shuffle_batch=shuffle,
                  mode=mode, alpha=1.0)
    _same(s, sj)
    assert titerate._make_batches(pt, titerate.Options(batch_size=32)) == \
        (3, 32, 4)
    sj, s = _both("newton", pj, pt, batch_size=32, shuffle_batch=shuffle,
                  mode=mode)
    assert s.epochs == sj.epochs
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj), rtol=1e-7)
    # test_algs.py's band: mini-batch steps have an SGD-like noise floor
    full = st.iterate(st.ProxNSCORE(solver="cg"), pt, "l1",
                      st.PHuberSmootherL1L2(1.0), max_epoch=200, verbose=0)
    mb = st.iterate(st.ProxNSCORE(solver="cg"), pt, "l1",
                    st.PHuberSmootherL1L2(1.0), batch_size=32,
                    max_epoch=400, verbose=0, rng_seed=3, mode=mode)
    assert bool(torch.isfinite(mb.x).all())
    assert abs(float(mb.obj[-1]) - float(full.obj[-1])) <= \
        5e-2 * abs(float(full.obj[-1]))


@pytest.mark.parametrize("name", ["newton"])
def test_slice_samples(name):
    """One row a batch (m batches an epoch): fused unshuffled and timed
    shuffled against the JAX package; ``batch_size`` takes priority.
    Newton only: one-row GGN and L-BFGS steps on this problem diverge
    within two epochs in both packages, which then part at 1e-5."""
    pj, pt = _problems(40, 8, density=0.5)
    for mode, shuffle in (("fused", False), ("timed", True)):
        sj, s = _both(name, pj, pt, slice_samples=True, max_epoch=2,
                      shuffle_batch=shuffle, mode=mode)
        _same(s, sj)
    opts = titerate.Options(slice_samples=True)
    assert titerate._make_batches(pt, opts) == (40, 1, 0)
    assert titerate._make_batches(
        pt, titerate.Options(slice_samples=True, batch_size=16)) == \
        (2, 16, 8)
    a = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **dict(KW, batch_size=16, slice_samples=True))
    b = st.iterate(METHODS[name](st), pt, "l1", st.PHuberSmootherL1L2(1.0),
                   **dict(KW, batch_size=16))
    assert torch.equal(a.x, b.x)


def _ticks(text):
    """The batch ticks of a verbose > 2 run: every line that is not a
    stats line (``name = value``)."""
    return [line for line in text.splitlines()
            if " = " not in line and not line.startswith("Optimizer")]


def test_verbose_batch_ticks(capsys):
    """verbose=3 in timed mode prints the reference's ticks, as the JAX
    package does: [1/iend], '#' a batch, [i/iend] every 100th and the
    last, and a rule after each epoch."""
    pj, pt = _problems(250, 8, density=0.5)
    kw = dict(KW, slice_samples=True, max_epoch=2, verbose=3, mode="timed")
    scso.iterate(scso.ProxLQNSCORE(kernels="xla"), pj, "l1",
                 scso.PHuberSmootherL1L2(1.0), **kw)
    want = _ticks(capsys.readouterr().out)
    st.iterate(st.ProxLQNSCORE(), pt, "l1", st.PHuberSmootherL1L2(1.0),
               **kw)
    got = _ticks(capsys.readouterr().out)
    assert got == want
    text = "\n".join(got)
    assert "[1/250]" in text and "[100/250]" in text and "[250/250]" in text
    assert len(re.findall("#", text)) >= 250 - 4


def test_auto_lp_refused_under_batches():
    """AUTO's bfloat16 copy is a full-batch copy: no copy under
    batching, as in the JAX package (``auto_lp=True`` skips only the
    size gates)."""
    pj, pt = _problems(64, 16, dtype=np.float32)
    method = st.ProxGGNSCORE(solver="cg", auto_lp=True)
    for opts in (titerate.Options(batch_size=16),
                 titerate.Options(slice_samples=True)):
        m, p = titerate._auto_lp(method, pt, "l1", opts)
        assert p.A_lp is None and m.cg_lp_tol == 0.0
        jm, jp = j_auto_lp(scso.ProxGGNSCORE(solver="cg", auto_lp=True), pj,
                           JOptions(batch_size=opts.batch_size,
                                    slice_samples=opts.slice_samples))
        assert jp.A_lp is None
    _, p = titerate._auto_lp(method, pt, "l1", titerate.Options())
    assert p.A_lp is not None


def test_batches_on_a_row_shard_raise():
    """Mini-batches on a row shard run now: the check passes on a
    one-axis row mesh (their parity on 2 and 4 ranks:
    tests/test_torch_sharded_methods.py), and each rank's rows of a
    batch, padded, are gathered in the permutation's order."""
    from scso_tpu_torch.parallel.sharding import Mesh

    _, pt = _problems(64, 16)
    mesh = Mesh(group=object(), axis_names=("data",), size=4, rank=1)
    titerate._check_sharded(st.ProxGGNSCORE(solver="cg"),
                            replace(pt, mesh=mesh), "l1",
                            titerate.Options(batch_size=16))
    rows = slice(16, 32)  # rank 1 of 4
    sp = replace(pt, A=pt.A[rows], y=pt.y[rows], mesh=mesh, m_total=64)
    b = titerate._Batches(sp, (4, 16, 0), 1)
    perm = np.random.default_rng(0).permutation(64)
    b.fill(0, perm[None])
    epoch = b.rows(0)
    for i in range(4):
        b.bi.fill_(i)
        view, Ab, yb = b.gather_full(sp, epoch)
        own = [r for r in perm[16 * i:16 * (i + 1)] if 16 <= r < 32]
        assert view.rows.total == 16 and int(view.rows.pad) == 16 - len(own)
        assert torch.equal(Ab[:len(own)], pt.A[own])
        assert torch.equal(Ab[len(own):], torch.zeros_like(Ab[len(own):]))
        assert torch.equal(view.rows.mask,
                           (torch.arange(16) < len(own)).double())
