"""Box-constrained QP with indicator smoothing on the PyTorch port (the
counterpart of examples/04_box_qp.py).

minimize ½xᵀQx + cᵀx subject to −1 ≤ x ≤ 1, via the box-indicator
regularizer with pseudo-Huber / exponential / log-exp smoothers.
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic


def main(device=None):
    n = 10
    Q, c, x0 = synthetic.make_box_qp(n, seed=1234, dtype=np.float64)

    problem = st.Problem(
        Q, c, x0, losses.qp_f, 1e-4,
        grad_fx=losses.qp_grad, hess_fx=losses.qp_hess,
        C_set=[-1.0, 1.0], dtype=torch.float64, device=device)

    for hmu, name in [
        (st.PHuberSmootherIndBox(-1.0, 1.0, 0.6), "PHuber"),
        (st.ExponentialSmootherIndBox(-1.0, 1.0, 0.6), "Exponential"),
        (st.LogExpSmootherIndBox(-1.0, 1.0, 0.6), "LogExp"),
    ]:
        sol = st.iterate(st.ProxNSCORE(), problem, "indbox", hmu,
                         alpha=0.8, max_epoch=200, verbose=0)
        inside = bool(((sol.x >= -1 - 1e-9) & (sol.x <= 1 + 1e-9)).all())
        print(f"{name:12s} epochs={sol.epochs:4d} "
              f"obj={float(sol.obj[-1]):.8f} feasible={inside}")
    return sol


if __name__ == "__main__":
    main()
