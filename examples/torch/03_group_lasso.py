"""Sparse-group lasso regression on the PyTorch port (the counterpart
of examples/03_group_lasso.py, the reference README's configuration).

Grouped least squares with the 'gl' regularizer, λ = [λ1, λ2] and the
group-lasso pseudo-Huber smoother (which takes the problem, as
`PHuberSmootherGL(μ, problem)` does).
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.ops.groups import group_norms


def main(device=None):
    m, n, grpsize = 50, 100, 10
    A, y, x_true, x0, groups = synthetic.make_group_lasso_problem(
        m, n, grpsize, p_active=0.1, noise_std=0.1, seed=1234, corr=0.5,
        dtype=np.float64)

    lam = [1e-8, 1.0]  # [l1, group]
    problem = st.Problem(
        A, y, x0, losses.lsq_f, lam,
        grad_fx=losses.lsq_grad, hess_fx=losses.lsq_hess,
        out_fn=losses.linear_out, loss_fn=losses.lsq_loss,
        grad_fy=losses.lsq_ggn_residual, hess_fy_diag=losses.lsq_ggn_qdiag,
        sol=x_true, groups=groups, dtype=torch.float64, device=device)

    hmu = st.PHuberSmootherGL(1e-2, problem)
    method = st.ProxLQNSCORE(use_prox=True, ss_type=1, m=10)
    sol = st.iterate(method, problem, "gl", hmu, alpha=1.0, max_epoch=100,
                     verbose=0)

    est = group_norms(problem.groups, sol.x).cpu().numpy()
    tru = group_norms(problem.groups, problem.x_star).cpu().numpy()
    print(sol)
    print("MSE vs ground truth:", float(sol.rel[-1]))
    print("active groups (true):", np.flatnonzero(tru > 1e-8))
    print("largest estimated   :", np.argsort(est)[-3:][::-1])
    return sol


if __name__ == "__main__":
    main()
