"""GLM and MOGLM specs of any kind in the port's kernels, against scso_tpu.

The JAX package traces any spec's callables into its kernels. K2/K2s
(the GLM preps) compute the logistic01, least-squares and Poisson GLMs
and K5 (the mglm matvec) the multinomial MOGLM inside the kernel, and
every other spec through their
split form: the kernel's two passes over A, the spec's own forms in
PyTorch between them. The form is a pure function of the shapes and
the spec (`glm_prep.prep_grid`, `mglm_matvec.mglm_grid`, from
`covers`), tested here for every kind, dtype and width; the forms
themselves run on the card (tests/test_torch_cuda.py). The plain
versions, and the split form, build the GGN forms from dlink, res and
qdiag where a spec has no ggn_rw/ggn_w (`glm_prep.ggn_weights`), so
such a spec takes the cached path as in the JAX package:
  * a spec without ggn_rw/ggn_w, greedy off, against
    `scso.iterate(kernels='xla')` with the same spec: the same epochs
    and CG iterations, histories to 1e-10 relative, both on the cached
    path;
  * the GGN forms of such a spec, normalized by the rows or by another
    count as on one rank of a row shard, against the JAX package's
    `_glm_kernel_fns` forms, 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.algorithms import steps as jsteps
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.algorithms import steps
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda import counters, glm_prep, mglm_matvec
from scso_tpu_torch.ops.cuda.glm_prep import (
    _weights, ggn_weights, glm_prep_torch, max_n, prep_grid)
from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_grid

torch.set_num_threads(1)

KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=40, verbose=0, stats_every=4,
          alpha=1.0)
_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))

# (name, op, spec, computed inside the kernel)
SPECS = [
    ("logistic01", "glm_prep", losses.LOGISTIC01_GLM, True),
    ("glm_kind_none", "glm_prep", replace(losses.LOGISTIC01_GLM, kind=None),
     False),
    ("glm_poisson", "glm_prep", losses.POISSON_GLM, True),
    ("glm_lsq", "glm_prep", losses.LSQ_GLM, True),
    ("glm_unknown_kind", "glm_prep",
     replace(losses.LOGISTIC01_GLM, kind="probit"), False),
    ("glm_unnormalized", "glm_prep",
     replace(losses.LOGISTIC01_GLM, sample_normalized=False), False),
    ("multinomial", "mglm_matvec", losses.multinom_mglm(4), True),
    ("moglm_kind_none", "mglm_matvec",
     replace(losses.multinom_mglm(4), kind=None), False),
    ("moglm_unnormalized", "mglm_matvec",
     replace(losses.multinom_mglm(4), sample_normalized=False), False),
]
# (m, n) of A for the GLM preps, (m, p, k) for K5: inside and past the
# one-read forms' limits
WIDTHS = {"glm_prep": {"narrow": (3001, 1024), "wide": (3001, 40000)},
          "mglm_matvec": {"narrow": (3001, 1024, 16),
                          "wide": (3001, 1025, 17)}}


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,op,spec,covered", SPECS,
                         ids=[s[0] for s in SPECS])
def test_spec_picks_the_kernel_form(name, op, spec, covered, dtype, width):
    shape = WIDTHS[op][width]
    if op == "glm_prep":
        assert glm_prep.covers(spec) == covered
        m, n = shape
        for c in (1, 2):
            g = prep_grid(m, n, dtype, c, 132, glm_prep.covers(spec))
            if not covered:
                # the split form: the wide geometry, A read twice
                assert g.form == "split"
                assert g.smem_bytes == g.chunks_per_thread == 0
                assert (g.blocks - 1) * g.rows_per_block < m
                assert g.blocks * g.rows_per_block >= m
            elif n <= max_n(dtype, c):
                assert g.form == "one_pass"
            else:
                assert g.form == "wide"
    else:
        assert mglm_matvec.covers(spec) == covered
        g = mglm_grid(*shape, dtype, 132, mglm_matvec.covers(spec))
        two_pass = mglm_grid(*shape, torch.float64, 132)
        assert two_pass.form == "two_pass"
        if not covered:
            # the split form: the two-pass geometry
            assert g == two_pass._replace(form="split")
        elif dtype == torch.float32 and width == "narrow":
            assert g.form == "tensor"
        else:
            assert g == two_pass


NO_FORMS = replace(losses.LOGISTIC01_GLM, ggn_rw=None, ggn_w=None)
J_NO_FORMS = jlosses.LOGISTIC01_GLM._replace(ggn_rw=None, ggn_w=None)


@pytest.mark.parametrize("m_norm", [None, 4 * 301 + 3])
def test_ggn_forms_without_the_stable_fields_match(m_norm):
    rng = np.random.default_rng(5)
    m, n = 301, 64
    A = rng.standard_normal((m, n)) * 0.3
    y = (rng.random(m) < 0.5).astype(np.float64)
    x = rng.standard_normal(n)
    z = A @ x
    rw_fn, w_fn, loss_fn = jsteps._glm_kernel_fns(J_NO_FORMS, m_norm or m)
    # the split form's forms, normalized by m_norm
    rw, w = _weights(NO_FORMS, _t(y), _t(z), m_norm)
    np.testing.assert_allclose(rw.numpy(), np.asarray(
        rw_fn(jnp.asarray(y), jnp.asarray(z))), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(w.numpy(), np.asarray(
        w_fn(jnp.asarray(y), jnp.asarray(z))), rtol=1e-12, atol=1e-15)
    if m_norm:
        return
    assert all(torch.equal(a, b) for a, b in zip(
        (rw, w), ggn_weights(NO_FORMS, _t(y), _t(z))))
    # the plain prep takes those forms, and equals the stable ones
    got = glm_prep_torch(_t(A), _t(y), _t(x), NO_FORMS)
    want = glm_prep_torch(_t(A), _t(y), _t(x), losses.LOGISTIC01_GLM)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-10,
                                   atol=1e-14)


def _problems(m, n, pad, seed=7):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.05, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01, glm=J_NO_FORMS,
                      dtype=np.float64, pad_features=pad)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01, glm=NO_FORMS,
                    dtype=torch.float64, pad_features=pad, device="cpu")
    return pj, pt


@pytest.mark.parametrize("m,n,pad", [(512, 256, False), (384, 200, True)])
def test_spec_without_ggn_forms_takes_the_cached_path(m, n, pad):
    pj, pt = _problems(m, n, pad)
    mj = scso.ProxGGNSCORE(solver="cg", kernels="xla", greedy_alpha=False)
    mt = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    assert jsteps.epoch_cache_enabled(mj, pj, "l1", True)
    assert steps.epoch_cache_enabled(mt, pt, "l1", True)
    sj = scso.iterate(mj, pj, "l1", scso.PHuberSmootherL1L2(1.0), **KW)
    counters.reset()
    s = st.iterate(mt, pt, "l1", st.PHuberSmootherL1L2(1.0), **KW)
    assert set(counters.snapshot().values()) == {0}  # CPU: plain versions
    assert s.state.fcache is not None  # the cached path ran
    assert s.epochs == sj.epochs
    assert s.cg_info == sj.cg_info
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x), atol=1e-9)


def test_kind_none_solves_like_the_logistic01_spec_on_the_cpu():
    # kind only selects the kernels' form: on the plain path a spec
    # without it gives the logistic01 spec's solve bit for bit
    _, pt = _problems(256, 128, False)
    runs = [st.iterate(st.ProxGGNSCORE(solver="cg", kernels=k),
                       replace(pt, glm=g), "l1",
                       st.PHuberSmootherL1L2(1.0), **KW)
            for k, g in (("auto", replace(losses.LOGISTIC01_GLM, kind=None)),
                         ("torch", losses.LOGISTIC01_GLM))]
    assert runs[0].epochs == runs[1].epochs
    assert torch.equal(runs[0].obj, runs[1].obj)
