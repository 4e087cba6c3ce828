"""`scso_tpu_torch.iterate_continuation` against scso_tpu's, float64.

The counterparts of tests/test_continuation.py's cases, each run through
both packages on the same numpy problem: the port's homotopy must land
where the JAX package's does (x to 1e-10, the same stages and epochs)
and keep that file's own checks (the direct solve's fixed point to
1e-8, the histories end to end without boundary duplicates, the gap
stop in an early stage, the schedule's validation, the group-lasso
two-λ schedule and its hazard). On the CPU a solve captures no graph, so
the stages' ``captures`` are 0 here; chip_smoke.py phase 19 holds one
capture for the non-final stages on the card.
"""

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu._src.struct import replace as jreplace
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses

torch.set_num_threads(1)

HOOKS = ("out_fn", "grad_fy", "hess_fy_diag", "loss_fn", "hvp_w", "ggn_w")
NAMES = dict(out_fn="sigmoid_out", grad_fy="logistic_ggn_residual",
             hess_fy_diag="logistic_ggn_qdiag", loss_fn="logistic_loss_01",
             hvp_w="logistic01_hvp_w", ggn_w="logistic_ggn_w")
METHOD = dict(solver="cg", cg_tol=1e-10, cg_maxiter=100)
KW = dict(x_tol=1e-12, f_tol=0.0, max_epoch=150, verbose=0, alpha=1.0)


def _logreg(m=256, n=64, lam=0.05, seed=5):
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.3, n_active=8, seed=seed, dtype=np.float64,
        label01=True)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64,
                      **{k: getattr(jlosses, v) for k, v in NAMES.items()})
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    device="cpu",
                    **{k: getattr(losses, v) for k, v in NAMES.items()})
    return pj, pt


def _both(pj, pt, reg="l1", sm=None, **kw):
    """The homotopy through both packages, with the l1 smoother of μ = 1
    unless ``sm`` = (JAX smoother, port smoother)."""
    jsm, tsm = sm or (scso.PHuberSmootherL1L2(1.0),
                      st.PHuberSmootherL1L2(1.0))
    kw = dict(KW, **kw)
    cj = scso.iterate_continuation(scso.ProxGGNSCORE(kernels="xla", **METHOD),
                                   pj, reg, jsm, **kw)
    ct = st.iterate_continuation(st.ProxGGNSCORE(**METHOD), pt, reg, tsm,
                                 **kw)
    assert ct.epochs == cj.epochs
    assert [s["epochs"] for s in ct.cg_info["stages"]] == \
        [s["epochs"] for s in cj.cg_info["stages"]]
    np.testing.assert_allclose(ct.x.numpy(), np.asarray(cj.x), atol=1e-10)
    assert len(ct.obj) == len(cj.obj)
    return cj, ct


def _direct(pt, reg="l1", sm=None, **kw):
    return st.iterate(st.ProxGGNSCORE(**METHOD), pt, reg,
                      sm or st.PHuberSmootherL1L2(1.0), **dict(KW, **kw))


class TestMuContinuation:
    def test_same_fixed_point_as_direct(self):
        pj, pt = _logreg()
        _, cont = _both(pj, pt, mu_schedule=[100.0, 10.0, 1.0],
                        stage_epochs=5)
        np.testing.assert_allclose(cont.x.numpy(), _direct(pt).x.numpy(),
                                   atol=1e-8)
        stages = cont.cg_info["stages"]
        assert [s["mu"] for s in stages] == [100.0, 10.0, 1.0]
        assert all(s["epochs"] <= 5 for s in stages[:-1])
        assert cont.epochs == sum(s["epochs"] for s in stages)
        assert all(s["captures"] == 0 for s in stages)  # the CPU

    def test_histories_concatenated(self):
        pj, pt = _logreg()
        cj, cont = _both(pj, pt, mu_schedule=[10.0, 1.0], stage_epochs=4)
        assert cont.obj.shape[0] == cont.epochs + 1
        assert float(cont.obj[-1]) <= float(cont.obj[0])
        for f in ("obj", "fval", "rel", "objrel"):
            np.testing.assert_allclose(getattr(cont, f).numpy(),
                                       np.asarray(getattr(cj, f)),
                                       rtol=1e-10)

    def test_gap_stop_in_early_stage(self):
        pj, pt = _logreg()
        s = _direct(pt)
        pt_t = replace(pt, x_star=s.x)
        pj_t = jreplace(pj, x_star=np.asarray(s.x.numpy()))
        kw = dict(mu_schedule=[1.0, 0.5, 0.25], stage_epochs=100,
                  f_tol=1e-6)
        cj, cont = _both(pj_t, pt_t, **kw)
        assert len(cont.cg_info["stages"]) == len(cj.cg_info["stages"]) < 3
        assert float(cont.objrel.min()) <= 1e-6 * 1.01

    def test_schedule_validation(self):
        _, pt = _logreg(m=64, n=16)
        sm = st.PHuberSmootherL1L2(1.0)
        with pytest.raises(ValueError, match="same length"):
            st.iterate_continuation(st.ProxGGNSCORE(**METHOD), pt, "l1", sm,
                                    mu_schedule=[10.0, 1.0],
                                    lam_schedule=[0.1], **KW)
        with pytest.raises(ValueError, match="empty"):
            st.iterate_continuation(st.ProxGGNSCORE(**METHOD), pt, "l1", sm,
                                    mu_schedule=[], **KW)


class TestLamContinuation:
    def test_lambda_homotopy_matches_direct(self):
        pj, pt = _logreg(lam=0.02)
        _, cont = _both(pj, pt, lam_schedule=[0.5, 0.1, 0.02],
                        stage_epochs=5)
        np.testing.assert_allclose(cont.x.numpy(), _direct(pt).x.numpy(),
                                   atol=1e-8)
        assert [s["lam"] for s in cont.cg_info["stages"]] == [0.5, 0.1,
                                                               0.02]

    def test_joint_mu_lambda(self):
        pj, pt = _logreg(lam=0.05)
        _, cont = _both(pj, pt, mu_schedule=[10.0, 1.0],
                        lam_schedule=[0.2, 0.05], stage_epochs=5)
        np.testing.assert_allclose(cont.x.numpy(), _direct(pt).x.numpy(),
                                   atol=1e-8)


def _gl():
    A, y, x_true, x0, groups = jsynth.make_group_lasso_problem(
        64, 32, 8, p_active=0.3, noise_std=0.05, seed=3, dtype=np.float64)
    jk = dict(grad_fx=jlosses.lsq_grad, out_fn=jlosses.linear_out,
              loss_fn=jlosses.lsq_loss, grad_fy=jlosses.lsq_ggn_residual,
              hess_fy_diag=jlosses.lsq_ggn_qdiag, glm=jlosses.LSQ_GLM)
    tk = dict(grad_fx=losses.lsq_grad, out_fn=losses.linear_out,
              loss_fn=losses.lsq_loss, grad_fy=losses.lsq_ggn_residual,
              hess_fy_diag=losses.lsq_ggn_qdiag, glm=losses.LSQ_GLM)
    pj = scso.Problem(A, y, x0, jlosses.lsq_f, [1e-8, 0.01], sol=x_true,
                      groups=groups, dtype=np.float64, **jk)
    tgroups = st.make_groups(np.asarray(groups.segment_ids),
                             np.asarray(groups.weights),
                             n_groups=groups.n_groups, dtype=torch.float64)
    pt = st.Problem(A, y, x0, losses.lsq_f, [1e-8, 0.01], sol=x_true,
                    groups=tgroups, dtype=torch.float64, device="cpu", **tk)
    sm = (scso.PHuberSmootherGL(1e-2, pj), st.PHuberSmootherGL(1e-2, pt))
    return pj, pt, sm


class TestContinuationGL:
    def test_group_lasso_two_lambda_schedule(self):
        pj, pt, sm = _gl()
        _, cont = _both(pj, pt, "gl", sm,
                        lam_schedule=[[1e-8, 0.02], [1e-8, 0.01]],
                        stage_epochs=8)
        direct = _direct(pt, "gl", sm[1])
        np.testing.assert_allclose(cont.x.numpy(), direct.x.numpy(),
                                   atol=1e-6)

    def test_gl_oversparse_stage_traps_groups(self):
        pj, pt, sm = _gl()
        _, cont = _both(pj, pt, "gl", sm,
                        lam_schedule=[[1e-8, 0.1], [1e-8, 0.01]],
                        stage_epochs=8)
        direct = _direct(pt, "gl", sm[1])
        nnz_d = int((direct.x.abs() > 1e-10).sum())
        nnz_c = int((cont.x.abs() > 1e-10).sum())
        assert nnz_c < nnz_d           # groups stayed trapped at zero
        assert float(cont.obj[-1]) > float(direct.obj[-1])
