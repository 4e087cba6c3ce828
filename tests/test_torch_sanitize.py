"""The numeric sanitizer (`scso_tpu_torch.utils.sanitize`) against the
JAX package's, float64 on the CPU (a 64×16 sparse logistic problem with
LOGISTIC01_GLM): its settings restored, also nested; ``disable_jit``
gives the solve's bits; a loss that returns NaN raises
FloatingPointError in both packages; a healthy solve completes in the
port, where the JAX package raises (its own sentinels: the reference's
quirk, pinned here)."""

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.utils import sanitize as jsanitize
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.ops import nancheck
from scso_tpu_torch.ops.cuda.matvec import normal_matvec
from scso_tpu_torch.utils import sanitize


def _data():
    return synthetic.make_sparse_logreg_data(
        64, 16, density=0.3, n_active=4, seed=0, dtype=np.float64,
        label01=True)


def _prob(f=None):
    A, y, x0, _ = _data()
    return st.Problem(A, y, x0, f or losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device="cpu")


def _jprob(f=None):
    A, y, x0, _ = _data()
    return scso.Problem(A, y, x0, f or jlosses.logistic01_f, 1e-2,
                        grad_fx=jlosses.logistic01_grad,
                        glm=jlosses.LOGISTIC01_GLM, dtype=np.float64)


SM = lambda pkg: pkg.PHuberSmootherL1L2(1.0)
#: the healthy solves: the GGN-CG and Newton solves whose NaN sentinels
#: make the JAX package raise, and L-BFGS
HEALTHY = {
    "ggn_cg_fused": (lambda pkg: pkg.ProxGGNSCORE(solver="cg"), "fused"),
    "ggn_cg_timed": (lambda pkg: pkg.ProxGGNSCORE(solver="cg"), "timed"),
    "newton_fused": (lambda pkg: pkg.ProxNSCORE(), "fused"),
    "newton_cg_timed": (lambda pkg: pkg.ProxNSCORE(solver="cg"), "timed"),
    "lbfgs_fused": (lambda pkg: pkg.ProxLQNSCORE(), "fused"),
}


def settings():
    return dict(nancheck.SETTINGS)


def test_settings_restored_also_when_nested():
    base = settings()
    assert base == {"nans": False, "disable_jit": False}
    with sanitize():
        assert settings() == {"nans": True, "disable_jit": False}
        with sanitize(nans=False, disable_jit=True):
            assert settings() == {"nans": False, "disable_jit": True}
            assert nancheck.uncaptured()
            torch.log(-torch.ones(2))  # no check inside
        assert settings() == {"nans": True, "disable_jit": False}
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(-torch.ones(2))
    assert settings() == base and not nancheck.uncaptured()
    with pytest.raises(RuntimeError):
        with sanitize(disable_jit=True):
            raise RuntimeError("inside")
    assert settings() == base
    torch.log(-torch.ones(2))  # unchecked again


@pytest.mark.parametrize("name", sorted(HEALTHY))
def test_disable_jit_and_a_healthy_solve_give_the_solves_bits(name):
    make, mode = HEALTHY[name]
    kw = dict(verbose=0, mode=mode, max_epoch=30)
    ref = st.iterate(make(st), _prob(), "l1", SM(st), **kw)
    for settings_ in (dict(disable_jit=True, nans=False), dict(nans=True)):
        with sanitize(**settings_):
            s = st.iterate(make(st), _prob(), "l1", SM(st), **kw)
        assert s.epochs == ref.epochs
        assert torch.equal(s.x, ref.x)
        assert torch.equal(s.obj, ref.obj)


def _nan_loss(log):
    def f(A, y, x):
        # a loss that really returns NaN: log of a negative number
        return log(losses.logistic01_f(A, y, x) - 10.0) if log is torch.log \
            else log(jlosses.logistic01_f(A, y, x) - 10.0)
    return f


@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_a_nan_loss_raises_in_both_packages(mode):
    import jax.numpy as jnp

    with sanitize(nans=True):
        with pytest.raises(FloatingPointError, match="log"):
            st.iterate(st.ProxLQNSCORE(), _prob(_nan_loss(torch.log)), "l1",
                       SM(st), verbose=0, max_epoch=5, mode=mode)
    with jsanitize(nans=True):
        with pytest.raises(FloatingPointError):
            scso.iterate(scso.ProxLQNSCORE(), _jprob(_nan_loss(jnp.log)),
                         "l1", SM(scso), verbose=0, max_epoch=5, mode=mode)


@pytest.mark.parametrize("mode", ["fused", "timed"])
def test_reference_quirk_a_healthy_ggn_solve_raises_under_jax(mode):
    """The reference's quirk, not the port's behaviour: under the JAX
    package's sanitize(nans=True) a healthy GGN-CG solve raises, set off
    by the NaN sentinels in its own carry (the port completes it:
    test_disable_jit_and_a_healthy_solve_give_the_solves_bits)."""
    with jsanitize(nans=True):
        with pytest.raises(FloatingPointError, match="nan"):
            scso.iterate(scso.ProxGGNSCORE(solver="cg"), _jprob(), "l1",
                         SM(scso), verbose=0, mode=mode)


def test_kernel_wrappers_check_their_outputs():
    """The check the CUDA wrappers run after a launch (their ctypes
    launches bypass the dispatcher): a NaN produced raises naming the
    kernel, a NaN carried in does not; the plain version on the CPU is
    checked op by op."""
    out = torch.tensor([1.0, float("nan")])
    with sanitize(nans=True):
        with pytest.raises(FloatingPointError, match="normal_matvec"):
            nancheck.check("normal_matvec", out, (torch.ones(2),))
        nancheck.check("normal_matvec", out, (out.clone(),))
        A = torch.tensor([[1.0, float("inf")]], dtype=torch.float64)
        with pytest.raises(FloatingPointError):
            normal_matvec(A, torch.zeros(1, dtype=torch.float64),
                          torch.ones(2, dtype=torch.float64))
    nancheck.check("normal_matvec", out, (torch.ones(2),))  # not sanitizing
