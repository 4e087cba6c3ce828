"""Sparse Poisson regression (log-link GLM) on the PyTorch port (the
counterpart of examples/07_poisson.py).

Counts y_i ~ Poisson(exp(a_i'x)), loss (1/m)·Σ(exp(z_i) − y_i·z_i), with
the closed-form derivative hooks, the GGN out_fn/residual/Q-diagonal
formulation and the GLM spec (``POISSON_GLM``, which the CUDA kernels
compute inside on the card).
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic


def main(device=None):
    m, n = 2000, 192
    A, y, x0, x_true = synthetic.make_sparse_poisson_data(
        m, n, density=0.08, n_active=12, seed=7, dtype=np.float64)

    problem = st.Problem(
        A, y, x0, losses.poisson_f, 5e-2,
        grad_fx=losses.poisson_grad,
        hess_fx=losses.poisson_hess,
        out_fn=losses.exp_out,
        grad_fy=losses.poisson_ggn_residual,
        hess_fy_diag=losses.poisson_ggn_qdiag,
        loss_fn=losses.poisson_loss,
        hvp_w=losses.poisson_hvp_w,
        ggn_w=losses.poisson_ggn_w,
        glm=losses.POISSON_GLM,
        sol=x_true,
        dtype=torch.float64, device=device,
    )
    hmu = st.PHuberSmootherL1L2(1.0)

    true_support = set(np.flatnonzero(np.abs(x_true) > 0).tolist())
    for method in [
        st.ProxNSCORE(solver="cg"),
        st.ProxGGNSCORE(solver="cg"),
        st.ProxLQNSCORE(m=10),
    ]:
        sol = st.iterate(method, problem, "l1", hmu, max_epoch=300,
                         verbose=0)
        _, label = method.display()
        support = set(torch.nonzero(sol.x.abs() > 1e-4).flatten().tolist())
        hits = len(support & true_support)
        print(f"{label:16s} epochs={sol.epochs:4d} "
              f"obj={float(sol.obj[-1]):.8f} nnz={len(support)}/{n} "
              f"true-support recovered={hits}/{len(true_support)}")
    return sol


if __name__ == "__main__":
    main()
