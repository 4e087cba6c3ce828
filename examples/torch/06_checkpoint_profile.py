"""Checkpoint and resume, failure recovery and profiling on the PyTorch
port (the counterpart of examples/06_checkpoint_profile.py).

``sol.state`` is the whole carry of a solve, so a checkpoint resumes it
bit for bit; `solve_with_recovery` retries a failed chunk from the last
good state; `trace_phase` names a phase in the profiler's timeline (and
as an NVTX range on the card).
"""

import tempfile
from pathlib import Path

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch._src.struct import replace
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.utils import (
    load_state, save_state, solve_with_recovery, trace_phase)


def main(device=None):
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        512, 64, density=0.2, n_active=8, seed=5, dtype=np.float64,
        label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 1e-2,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                      device=device)
    sm = st.PHuberSmootherL1L2(1.0)
    method = st.ProxGGNSCORE(solver="cg")

    # 1. partial solve → whole-state checkpoint → bit-identical resume
    with trace_phase("partial-solve"):
        part = st.iterate(method, prob, "l1", sm, max_epoch=20, verbose=0,
                          alpha=1.0)
    ckpt = Path(tempfile.mkdtemp()) / "solver_state.npz"
    save_state(str(ckpt), part.state)
    print(f"checkpointed at epoch {part.epochs}: "
          f"obj={float(part.obj[-1]):.8f}")

    state = load_state(str(ckpt), template=part.state)
    resumed = st.iterate(method, prob, "l1", sm, max_epoch=200, verbose=0,
                         alpha=1.0, resume_state=state)
    print(f"resumed to epoch {resumed.epochs}: "
          f"obj={float(resumed.obj[-1]):.8f}")

    # a warm start (x only) for a changed problem or method
    warm = st.iterate(st.ProxLQNSCORE(), replace(prob, x0=part.x.clone()),
                      "l1", sm, max_epoch=50, verbose=0)
    print(f"warm-started L-BFGS: {warm.epochs} epochs, "
          f"obj={float(warm.obj[-1]):.8f}")

    # 2. chunked solve with snapshot-based failure recovery
    rec = solve_with_recovery(method, prob, "l1", sm, chunk_epochs=25,
                              verbose=0, alpha=1.0)
    print(f"recovery-wrapped solve: {rec.epochs} epochs, "
          f"obj={float(rec.obj[-1]):.8f}")
    return resumed


if __name__ == "__main__":
    main()
