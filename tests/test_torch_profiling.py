"""Profiling (`scso_tpu_torch.utils.profiling`) against the JAX
package's (tests/test_group_lasso_e2e.py's TestProfiling), float64 on
the CPU: the same epochs as the JAX ``profile_solve`` and as the solve
it profiles, bit for bit that solve's iterate."""

import numpy as np
import torch

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.utils import profile_solve as jprofile_solve
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.utils import (
    PhaseTimer, device_memory_stats, profile_solve, profile_to, trace_phase)


def _data():
    return synthetic.make_sparse_logreg_data(
        64, 16, density=0.3, n_active=4, seed=0, dtype=np.float64)


def test_phase_timer():
    pt = PhaseTimer()
    x = torch.ones(64)
    with pt.phase("mul", sync_value=x):
        y = x * 2
    with pt.phase("mul", sync_value=(y, {"k": y})):
        y = y * 2
    with pt.phase("sum"):
        y.sum()
    pt.add("sum", 0.5)
    tot = pt.totals()
    assert set(tot) == {"mul", "sum"} and tot["mul"] > 0
    assert tot["sum"] >= 0.5
    assert pt.means()["mul"] <= tot["mul"]
    assert pt.means()["sum"] == tot["sum"] / 2
    assert "mul" in pt.report()


def test_profile_solve_matches_the_jax_profile():
    A, y, x0, _ = _data()
    prob = st.Problem(A, y, x0, losses.logistic_f, 1e-2,
                      grad_fx=losses.logistic_grad,
                      hess_fx=losses.logistic_hess, dtype=torch.float64,
                      device="cpu")
    sol, prof = profile_solve(st.ProxNSCORE(), prob, "l1",
                              st.PHuberSmootherL1L2(1.0), max_epoch=15)
    assert prof["epochs"] == sol.epochs
    assert len(prof["epoch_times_s"]) >= 1
    assert len(prof["epoch_deltas_s"]) == len(prof["epoch_times_s"]) - 1
    timed = st.iterate(st.ProxNSCORE(), prob, "l1",
                       st.PHuberSmootherL1L2(1.0), max_epoch=15, verbose=0,
                       mode="timed")
    assert torch.equal(sol.x, timed.x)
    jprob = scso.Problem(A, y, x0, jlosses.logistic_f, 1e-2,
                         grad_fx=jlosses.logistic_grad,
                         hess_fx=jlosses.logistic_hess, dtype=np.float64)
    jsol, jprof = jprofile_solve(scso.ProxNSCORE(), jprob, "l1",
                                 scso.PHuberSmootherL1L2(1.0), max_epoch=15)
    assert set(prof) == set(jprof)
    assert prof["epochs"] == jprof["epochs"] == jsol.epochs
    assert len(prof["epoch_times_s"]) == len(jprof["epoch_times_s"])
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=1e-12)
    assert prof["memory_before"] == prof["memory_after"] == {}


def test_profile_solve_writes_a_trace(tmp_path):
    """With trace_dir: a Chrome trace of the run, its phases named."""
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        64, 16, density=0.3, n_active=4, seed=0, dtype=np.float64,
        label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device="cpu")
    with trace_phase("outer"):
        sol, prof = profile_solve(st.ProxGGNSCORE(solver="cg"), prob, "l1",
                                  st.PHuberSmootherL1L2(1.0), max_epoch=5,
                                  trace_dir=str(tmp_path))
    assert prof["trace_dir"] == str(tmp_path)
    # timed mode records no CG total, in either package
    assert prof["total_cg_iters"] is None and sol.cg_info is None
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with profile_to(str(tmp_path / "again")) as prof_:
        with trace_phase("named"):
            torch.ones(3).sum()
    names = {e.name for e in prof_.events()}
    assert "named" in names


def test_device_memory_stats_on_the_cpu():
    assert device_memory_stats("cpu") == {}


def test_utils_exports_the_jax_names():
    """The port's utils export every name of the JAX package's but the
    orbax checkpoints (no PyTorch counterpart; the port keeps .npz)."""
    import scso_tpu.utils as ju
    import scso_tpu_torch.utils as tu

    orbax = {"save_state_orbax", "load_state_orbax"}
    assert set(tu.__all__) == set(ju.__all__) - orbax
    assert all(hasattr(tu, name) for name in tu.__all__)
