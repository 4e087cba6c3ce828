"""Sparse logistic regression with all three SCORE methods on the
PyTorch port (the counterpart of examples/02_sparse_logistic.py).

Data problem f(A, y, x) with l1 regularization: the closed-form
derivative hooks, the GGN model-output formulation and the GLM spec
that takes the GGN and Newton CG solves through the port's CUDA kernels
on the card.
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic


def main(device=None):
    m, n = 2000, 256
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        m, n, density=0.05, n_active=16, seed=1234, dtype=np.float64,
        label01=True)

    problem = st.Problem(
        A, y, x0, losses.logistic01_f, 0.01,
        grad_fx=losses.logistic01_grad,
        hess_fx=losses.logistic01_hess,
        out_fn=losses.sigmoid_out,
        grad_fy=losses.logistic_ggn_residual,
        hess_fy_diag=losses.logistic_ggn_qdiag,
        loss_fn=losses.logistic_loss_01,
        hvp_w=losses.logistic01_hvp_w,
        ggn_w=losses.logistic_ggn_w,
        glm=losses.LOGISTIC01_GLM,
        dtype=torch.float64, device=device,
    )
    hmu = st.PHuberSmootherL1L2(1.0)

    for method in [
        st.ProxNSCORE(solver="cg"),
        st.ProxGGNSCORE(solver="cg"),
        st.ProxLQNSCORE(m=10),
    ]:
        sol = st.iterate(method, problem, "l1", hmu, max_epoch=200,
                         verbose=0)
        _, label = method.display()
        nnz = int((sol.x.abs() > 1e-8).sum())
        print(f"{label:16s} epochs={sol.epochs:4d} "
              f"obj={float(sol.obj[-1]):.8f} nnz={nnz}/{n}")
    return sol


if __name__ == "__main__":
    main()
