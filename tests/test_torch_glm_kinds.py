"""The least-squares and Poisson GLMs of the port, against scso_tpu.

Same numpy inputs, float64 (and A in bfloat16 with the same bits in both
packages), through each JAX function and its port:
  * the LSQ and Poisson losses, gradients, Hessians, the dense GGN hooks
    and every field of `LSQ_GLM` and `POISSON_GLM`, rtol 1e-12;
  * the plain K2 (`glm_prep_pair_torch`, ggn and newton flavours) and K2s
    (`glm_prep_torch`) on both specs against the Pallas kernels
    `_fused_glm_prep_pair`/`_fused_glm_prep` in interpret mode with
    `steps._glm_kernel_fns(spec, m, flavour)`, at tests/test_pallas.py's
    block-boundary shapes, with A in float64 and in bfloat16, rtol 1e-12
    and atol 1e-12·max(1, max|ref|);
  * the kernel form both kinds get: `covers` is true for them (sample-
    normalized), so `prep_grid` picks the one-pass or the wide form and
    never the split one, with A in the compute type or in bfloat16.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scso_tpu.algorithms import steps as jsteps
from scso_tpu.models import losses as jlosses
from scso_tpu.ops.pallas.glm_prep import (
    _fused_glm_prep, _fused_glm_prep_pair)
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses
from scso_tpu_torch.ops.cuda import glm_prep
from scso_tpu_torch.ops.cuda.glm_prep import (
    glm_prep_pair_torch, glm_prep_torch, max_n, prep_grid)

torch.set_num_threads(1)

RTOL = 1e-12
# tests/test_pallas.py's block-boundary shapes
SHAPES = [(37, 128), (131, 128), (660, 256), (947, 384)]
KINDS = {"lsq": (losses.LSQ_GLM, jlosses.LSQ_GLM),
         "poisson": (losses.POISSON_GLM, jlosses.POISSON_GLM)}

_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=RTOL, atol=1e-12):
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=atol * max(1.0, top))


def _data(kind, m, n, seed):
    """A (m, n), y of the family (counts for Poisson), two candidates with
    a moderate linear predictor."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.3
    if kind == "poisson":
        y = rng.poisson(1.5, m).astype(np.float64)
    else:
        y = rng.standard_normal(m)
    xt = rng.standard_normal(n) * 0.3 / np.sqrt(n)
    xd = rng.standard_normal(n) * 0.3 / np.sqrt(n)
    return A, y, xt, xd


def _a(A, a_dtype):
    """A in both packages: float64, or bfloat16 with the same bits."""
    if a_dtype == "f64":
        return jnp.asarray(A), _t(A)
    Aj = jnp.asarray(A, jnp.float32).astype(jnp.bfloat16)
    return Aj, torch.tensor(np.asarray(Aj, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the losses and their hooks
# ---------------------------------------------------------------------------

FNS = {"lsq": ("lsq_f", "lsq_grad", "lsq_hess", "lsq_hvp_w", "lsq_ggn_w"),
       "poisson": ("poisson_f", "poisson_grad", "poisson_hess",
                   "poisson_hvp_w", "poisson_ggn_w")}
YHAT_FNS = {"lsq": ("lsq_ggn_residual", "lsq_ggn_qdiag", "linear_jac"),
            "poisson": ("poisson_ggn_residual", "poisson_ggn_qdiag",
                        "exp_jac")}
OUT = {"lsq": ("linear_out", "lsq_loss"), "poisson": ("exp_out",
                                                     "poisson_loss")}


@pytest.mark.parametrize("kind", ["lsq", "poisson"])
def test_losses_and_hooks_match(kind):
    A, y, x, _ = _data(kind, 90, 24, 1)
    args_t, args_j = (_t(A), _t(y), _t(x)), tuple(map(jnp.asarray,
                                                       (A, y, x)))
    for name in FNS[kind]:
        _close(getattr(losses, name)(*args_t),
               getattr(jlosses, name)(*args_j))
    out, loss = OUT[kind]
    yhat = getattr(losses, out)(_t(A), _t(x))
    yhat_j = getattr(jlosses, out)(jnp.asarray(A), jnp.asarray(x))
    _close(yhat, yhat_j)
    _close(getattr(losses, loss)(_t(y), yhat),
           getattr(jlosses, loss)(jnp.asarray(y), yhat_j))
    for name in YHAT_FNS[kind]:
        extra = ((_t(x),), (jnp.asarray(x),)) if "jac" in name else ((), ())
        _close(getattr(losses, name)(_t(A), _t(y), yhat, *extra[0]),
               getattr(jlosses, name)(jnp.asarray(A), jnp.asarray(y),
                                      yhat_j, *extra[1]))


@pytest.mark.parametrize("kind", ["lsq", "poisson"])
def test_spec_fields_match(kind):
    spec, jspec = KINDS[kind]
    assert spec.kind == kind and spec.sample_normalized
    A, y, x, _ = _data(kind, 70, 16, 2)
    z, yt = A @ x, y
    zt, zj, ytt, yj = _t(z), jnp.asarray(z), _t(yt), jnp.asarray(yt)
    _close(spec.link(zt), jspec.link(zj))
    _close(spec.dlink(zt), jspec.dlink(zj))
    yhat, yhat_j = spec.link(zt), jspec.link(zj)
    for f in ("res", "qdiag"):
        _close(getattr(spec, f)(ytt, yhat), getattr(jspec, f)(yj, yhat_j))
    for f in ("hvp_w", "gres", "ggn_rw", "ggn_w", "loss_z", "loss_sample"):
        _close(getattr(spec, f)(ytt, zt), getattr(jspec, f)(yj, zj))


# ---------------------------------------------------------------------------
# the plain K2 and K2s against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_dtype", ["f64", "bf16"])
@pytest.mark.parametrize("flavour", ["ggn", "newton"])
@pytest.mark.parametrize("kind", ["lsq", "poisson"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_pair_prep_matches_pallas(m, n, kind, flavour, a_dtype):
    spec, jspec = KINDS[kind]
    A, y, xt, xd = _data(kind, m, n, m + n)
    Aj, At = _a(A, a_dtype)
    rw_fn, w_fn, loss_fn = jsteps._glm_kernel_fns(jspec, m, flavour)
    want = _fused_glm_prep_pair(Aj, jnp.asarray(y), jnp.asarray(xt),
                                jnp.asarray(xd), rw_fn, w_fn, loss_fn,
                                interpret=True)
    got = glm_prep_pair_torch(At, _t(y), _t(xt), _t(xd), spec,
                              flavour=flavour)
    for f, g, w_ in zip(got._fields, got, want):
        assert g.dtype == torch.float64, f
        assert tuple(g.shape) == tuple(w_.shape), f
        _close(g, w_)


@pytest.mark.parametrize("a_dtype", ["f64", "bf16"])
@pytest.mark.parametrize("kind", ["lsq", "poisson"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_single_prep_matches_pallas(m, n, kind, a_dtype):
    spec, jspec = KINDS[kind]
    A, y, x, _ = _data(kind, m, n, 3 * m + n)
    Aj, At = _a(A, a_dtype)
    rw_fn, w_fn, _ = jsteps._glm_kernel_fns(jspec, m)
    want = _fused_glm_prep(Aj, jnp.asarray(y), jnp.asarray(x), rw_fn, w_fn,
                           interpret=True)
    got = glm_prep_torch(At, _t(y), _t(x), spec)[:3]
    for g, w_ in zip(got, want):
        _close(g, np.asarray(w_).reshape(g.shape))


# ---------------------------------------------------------------------------
# the kernel form of both kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["lsq", "poisson"])
def test_both_kinds_run_inside_the_kernel(kind, dtype, a_dtype):
    spec = KINDS[kind][0]
    assert glm_prep.covers(spec)
    assert not glm_prep.covers(replace(spec, sample_normalized=False))
    assert not glm_prep.covers(replace(spec, kind="probit"))
    for c in (1, 2):
        limit = max_n(dtype, c, a_dtype)
        # K2 and K2s with A in bfloat16 and float32 run the cluster form
        # from n = 1025 to 14336 (K2s past it one-pass, to its limit)
        bf = (dtype, a_dtype) == (torch.float32, torch.bfloat16)
        main = ("cluster" if bf else "one_pass" if c == 1 or
                limit >= 10112 else "wide")
        for (m, n), form in (((1, 256), "one_pass"),
                             ((3001, limit),
                              "cluster" if bf and c == 2 else "one_pass"),
                             ((3001, limit + 8), "wide"),
                             ((196608, 10112), main)):
            g = prep_grid(m, n, dtype, c, 132, glm_prep.covers(spec),
                          a_dtype)
            assert g.form == form, (m, n, c)


def test_the_split_form_still_serves_other_kinds():
    for spec in (replace(losses.LSQ_GLM, kind=None),
                 replace(losses.POISSON_GLM, kind="least_squares")):
        assert not glm_prep.covers(spec)
        assert prep_grid(3001, 1024, torch.float32, 2, 132,
                         glm_prep.covers(spec)).form == "split"
    # the kernels' codes follow KERNEL_KINDS; the split form sends -1
    assert glm_prep.KERNEL_KINDS == ("logistic01", "lsq", "poisson")
    assert [glm_prep._kind_code(s) for s in (
        losses.LOGISTIC01_GLM, losses.LSQ_GLM, losses.POISSON_GLM,
        replace(losses.LSQ_GLM, kind=None))] == [0, 1, 2, -1]
