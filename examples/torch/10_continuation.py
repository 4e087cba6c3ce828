"""μ/λ continuation (homotopy) on the PyTorch port (the counterpart of
examples/10_continuation.py): `iterate_continuation` anneals the
smoothing parameter and/or the penalty to their targets with warm
starts, the final stage getting the full budget. μ and λ are per-solve
tensors, so on the card all stages replay one captured graph.
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic


def main(device=None):
    m, n = 512, 128
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        m, n, density=0.2, n_active=12, seed=3, dtype=np.float64,
        label01=True)
    problem = st.Problem(
        A, y, x0, losses.logistic01_f, 0.02,
        grad_fx=losses.logistic01_grad,
        out_fn=losses.sigmoid_out,
        grad_fy=losses.logistic_ggn_residual,
        hess_fy_diag=losses.logistic_ggn_qdiag,
        loss_fn=losses.logistic_loss_01,
        hvp_w=losses.logistic01_hvp_w,
        ggn_w=losses.logistic_ggn_w,
        glm=losses.LOGISTIC01_GLM,
        dtype=torch.float64, device=device,
    )
    method = st.ProxGGNSCORE(solver="cg")
    hmu = st.PHuberSmootherL1L2(1.0)
    kw = dict(x_tol=1e-10, f_tol=0.0, max_epoch=150, verbose=0,
              alpha=1.0)

    direct = st.iterate(method, problem, "l1", hmu, **kw)

    # μ-homotopy: two loose-smoothing stages, then the target
    cont = st.iterate_continuation(
        method, problem, "l1", hmu, mu_schedule=[16.0, 4.0, 1.0],
        stage_epochs=6, **kw)
    print("direct:       epochs", direct.epochs,
          "obj", f"{float(direct.obj[-1]):.10f}")
    for stage in cont.cg_info["stages"]:
        print(f"  stage mu={stage['mu']}: {stage['epochs']} epochs")
    print("continuation: epochs", cont.epochs,
          "obj", f"{float(cont.obj[-1]):.10f}")
    assert torch.allclose(cont.x, direct.x, atol=1e-6)  # same fixed point

    # λ-path warm starting (the sparser-first direction)
    cont_lam = st.iterate_continuation(
        method, problem, "l1", hmu,
        lam_schedule=[0.1, 0.05, 0.02], stage_epochs=6, **kw)
    nnz = int((cont_lam.x.abs() > 1e-8).sum())
    print("lambda path:  epochs", cont_lam.epochs, f"nnz={nnz}/{n}")
    return cont


if __name__ == "__main__":
    main()
