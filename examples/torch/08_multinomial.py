"""Multinomial (softmax) regression on the PyTorch port (the
counterpart of examples/08_multinomial.py): vector-valued model outputs.

The dense branches flatten the (m·k)×n Jacobian, residual and Q as the
reference does; the matrix-free route (``Problem.mglm`` =
``losses.multinom_mglm(k)``) applies the per-sample k×k curvature inside
the CG matvec (the K5 kernel on the card), where for this linear-in-x
model the GGN is the exact Hessian.
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses, synthetic


def main(device=None):
    m, p, k = 400, 12, 4  # n = p·k = 48 parameters
    A, Y, x0, x_true = synthetic.make_multinomial_data(
        m, p, k, seed=5, dtype=np.float64)

    problem = st.Problem(
        A, Y, x0, losses.multinom_f, 1e-3,
        grad_fx=losses.multinom_grad,
        out_fn=losses.softmax_out,
        loss_fn=losses.xent_loss,
        mglm=losses.multinom_mglm(k),
        sol=x_true,
        dtype=torch.float64, device=device,
    )
    hmu = st.PHuberSmootherL1L2(1.0)

    def accuracy(x):
        yhat = losses.softmax_out(problem.A, x)
        return float((yhat.argmax(-1) == problem.y.argmax(-1)).double()
                     .mean())

    for method in [
        st.ProxNSCORE(solver="dense", ss_type=3),
        st.ProxGGNSCORE(solver="dense_primal", ss_type=3),
        st.ProxGGNSCORE(solver="cg"),  # matrix-free logits-split GGN
        st.ProxLQNSCORE(m=10),
    ]:
        sol = st.iterate(method, problem, "l1", hmu, max_epoch=200,
                         verbose=0)
        _, label = method.display()
        mf = " (matrix-free mglm)" if getattr(method, "solver", "") == "cg" \
            else ""
        print(f"{label:16s} epochs={sol.epochs:4d} "
              f"obj={float(sol.obj[-1]):.8f} "
              f"train_acc={accuracy(sol.x):.3f}{mf}")
    return sol


if __name__ == "__main__":
    main()
