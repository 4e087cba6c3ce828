"""Seeded parity fuzz of the port's solver surface against scso_tpu.

A fixed master seed draws the cases (a failure reproduces by index):
random shapes, every method kind the port has — dense and CG Newton,
GGN-CG through the epoch cache and off it, the dense GGN solve, L-BFGS
— the l1, l2 and box regularizers, the three step-size schemes,
``stats_every``, mini-batches and mode. Each case runs through both
packages in float64 and holds:

  * the bookkeeping: records and epochs within the budget, box solves in
    the box;
  * where the JAX package's run stays finite and moderate: the same
    epochs, and the objective history and x to 1e-8 (unshuffled batches
    in fused mode: the JAX package's fused mode draws its permutations
    with jax.random; of a mini-batch run the first six records);
  * interrupt and resume (``resume_state``) in the port: bit for bit the
    uninterrupted run, diverging runs included.
"""

import numpy as np
import pytest
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch.models import losses

torch.set_num_threads(1)

MASTER_SEED = 20261018
N_CASES = 16
METHOD_KINDS = ("newton", "newton_cg", "ggn_cached", "ggn_uncached",
                "ggn_dense", "lbfgs")
HOOKS = dict(out_fn="sigmoid_out", loss_fn="logistic_loss_01",
             grad_fy="logistic_ggn_residual",
             hess_fy_diag="logistic_ggn_qdiag", hess_fx="logistic01_hess")


def _gen_cases():
    rng = np.random.default_rng(MASTER_SEED)
    cases = []
    for i in range(N_CASES):
        cases.append(dict(
            i=i, m=4 * int(rng.integers(24, 64)), n=int(rng.integers(8, 40)),
            kind=str(rng.choice(["l1", "l2", "indbox"])),
            # every kind at least twice, then at random
            method=(METHOD_KINDS[i] if i < len(METHOD_KINDS)
                    else METHOD_KINDS[i - len(METHOD_KINDS)]
                    if i < 2 * len(METHOD_KINDS)
                    else str(rng.choice(METHOD_KINDS))),
            ss_type=int(rng.choice([1, 2, 3])),
            batch=bool(rng.random() < 0.35),
            stats_every=int(rng.choice([1, 3])),
            mode=str(rng.choice(["fused", "timed"])),
            resume_at=int(rng.integers(2, 9)),
            seed=int(rng.integers(0, 2**31))))
    return cases


CASES = _gen_cases()


def _problems(case):
    m, n = case["m"], case["n"]
    A, y, x0, _ = jsynth.make_sparse_logreg_data(
        m, n, density=0.3, n_active=max(2, n // 6), seed=case["seed"],
        dtype=np.float64, label01=True)
    kw = dict(dtype=np.float64)
    lam = 1e-2
    if case["kind"] == "indbox":
        kw["C_set"] = [-0.7, 0.9]
        lam = 1.0
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, lam,
                      grad_fx=jlosses.logistic01_grad,
                      glm=jlosses.LOGISTIC01_GLM,
                      **{k: getattr(jlosses, v) for k, v in HOOKS.items()},
                      **kw)
    pt = st.Problem(A, y, x0, losses.logistic01_f, lam,
                    grad_fx=losses.logistic01_grad,
                    glm=losses.LOGISTIC01_GLM,
                    **{k: getattr(losses, v) for k, v in HOOKS.items()},
                    C_set=kw.get("C_set"), dtype=torch.float64,
                    device="cpu")
    return pj, pt


def _smoother(p, case):
    if case["kind"] == "indbox":
        return p.PHuberSmootherIndBox(-0.7, 0.9, 0.5)
    return p.PHuberSmootherL1L2(1.0)


def _method(p, case, **k):
    mk, ss = case["method"], case["ss_type"]
    if mk == "newton":
        return p.ProxNSCORE(ss_type=ss, solver="dense", **k)
    if mk == "newton_cg":
        return p.ProxNSCORE(ss_type=ss, solver="cg", **k)
    if mk == "ggn_cached":
        return p.ProxGGNSCORE(ss_type=ss, solver="cg", **k)
    if mk == "ggn_uncached":
        return p.ProxGGNSCORE(ss_type=ss, solver="cg", epoch_cache=False,
                              **k)
    if mk == "ggn_dense":
        return p.ProxGGNSCORE(ss_type=ss, solver="auto", **k)
    return p.ProxLQNSCORE(ss_type=ss, m=5, **k)


def _kwargs(case, max_epoch):
    kw = dict(max_epoch=max_epoch, verbose=0, x_tol=1e-12, f_tol=1e-12,
              stats_every=case["stats_every"], mode=case["mode"])
    if case["batch"]:
        # batches of 2n rows or more: a thinner one is rank deficient, and
        # CG on it turns last-ulp differences into 1e-7 ones at once
        kw.update(batch_size=max(case["m"] // 4 + 3, 2 * case["n"] + 3),
                  rng_seed=7, shuffle_batch=case["mode"] == "timed")
    return kw


def _tame(obj):
    obj = np.asarray(obj)
    return bool(np.all(np.isfinite(obj)) and np.abs(obj).max() < 1e6)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"case{c['i']}")
def test_random_config_parity(case):
    pj, pt = _problems(case)
    kw = _kwargs(case, 20)
    s = st.iterate(_method(st, case), pt, case["kind"], _smoother(st, case),
                   **kw)
    assert 0 < len(s.obj) <= kw["max_epoch"] + 1
    assert 0 <= s.epochs <= kw["max_epoch"]
    if case["kind"] == "indbox" and bool(torch.isfinite(s.x).all()):
        assert bool(((s.x >= -0.7 - 1e-12) & (s.x <= 0.9 + 1e-12)).all())

    sj = scso.iterate(_method(scso, case, kernels="xla"), pj, case["kind"],
                      _smoother(scso, case), **kw)
    if _tame(sj.obj):
        assert s.epochs == sj.epochs
        # mini-batch steps (the objective noisy, SGD-like) turn last-ulp
        # differences into 1e-7 ones within ~20 epochs: their first
        # records only
        k = len(sj.obj) if not case["batch"] else min(len(sj.obj), 6)
        np.testing.assert_allclose(s.obj.numpy()[:k],
                                   np.asarray(sj.obj)[:k], rtol=1e-8)
        if not case["batch"]:
            np.testing.assert_allclose(s.x.numpy(), np.asarray(sj.x),
                                       atol=1e-8)

    # interrupt and resume: the uninterrupted run's bits
    at = min(case["resume_at"], max(s.epochs - 1, 1))
    part = st.iterate(_method(st, case), pt, case["kind"],
                      _smoother(st, case), **_kwargs(case, at))
    res = st.iterate(_method(st, case), pt, case["kind"],
                     _smoother(st, case), resume_state=part.state, **kw)
    assert res.epochs == s.epochs
    assert torch.equal(torch.nan_to_num(res.x), torch.nan_to_num(s.x))
    assert torch.equal(torch.nan_to_num(res.obj), torch.nan_to_num(s.obj))
