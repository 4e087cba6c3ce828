"""Federated sparse logistic regression on the PyTorch port (the
counterpart of examples/09_federated.py): local SCORE + model averaging.

Rows split across clients; each round solves every client's local
problem as ONE batched solve, then averages. The per-round objective is
the centralized one; the row-sharded solve finishes from the federated
iterate over the ranks the example is started with (one process alone,
or ``torchrun --nproc-per-node=N``).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import scso_tpu_torch as st  # noqa: E402
from scso_tpu_torch._src.struct import replace  # noqa: E402
from scso_tpu_torch.models import losses, synthetic  # noqa: E402
from scso_tpu_torch.parallel import (  # noqa: E402
    federated_solve, make_mesh, shard_problem)
from scso_tpu_torch.problems import resolve_device  # noqa: E402

from _common import ranks  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        1024, 32, density=0.2, n_active=8, seed=3, dtype=np.float64)
    prob = st.Problem(A, y, x0, losses.logistic_f, 1e-2,
                      grad_fx=losses.logistic_grad,
                      hess_fx=losses.logistic_hess, dtype=torch.float64,
                      device=dev)
    meth = st.ProxNSCORE(solver="dense", ss_type=3)
    sm = st.PHuberSmootherL1L2(1.0)

    central = st.iterate(meth, prob, "l1", sm, max_epoch=200, verbose=0)
    print(f"centralized        obj = {float(central.obj[-1]):.8f}")

    fed = federated_solve(meth, prob, "l1", sm, n_clients=8,
                          comm_rounds=8, local_epochs=4, f_tol=1e-8)
    for r, o in enumerate(fed.obj.tolist(), 1):
        print(f"round {r:2d}            obj = {o:.8f}")

    with ranks(dev):
        finish = st.iterate(meth,
                            shard_problem(replace(prob, x0=fed.x),
                                          make_mesh()),
                            "l1", sm, max_epoch=100, verbose=0)
    print(f"sharded finisher   obj = {float(finish.obj[-1]):.8f}")
    return finish


if __name__ == "__main__":
    main()
