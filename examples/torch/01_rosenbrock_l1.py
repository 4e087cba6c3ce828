"""l1-regularized Rosenbrock on the PyTorch port (the counterpart of
examples/01_rosenbrock_l1.py).

Generic (data-free) problem: minimize
100(x2−x1²)² + (1−x1)² + λ‖x‖₁ with the proximal L-BFGS SCORE method
and pseudo-Huber smoothing. Runs on the card unless ``device`` says
otherwise:

    python examples/torch/01_rosenbrock_l1.py
"""

import numpy as np
import torch

import scso_tpu_torch as st
from scso_tpu_torch.models import losses


def main(device=None):
    x0 = np.array([0.2, -0.5])
    lam = 1e-8
    problem = st.Problem(x0, losses.rosenbrock, lam, dtype=torch.float64,
                         device=device)

    method = st.ProxLQNSCORE(use_prox=True, ss_type=1, m=10)
    hmu = st.PHuberSmootherL1L2(1.0)
    sol = st.iterate(method, problem, "l1", hmu, max_epoch=2000,
                     x_tol=1e-10, f_tol=1e-10, verbose=0)
    print(sol)
    print("x* =", sol.x.cpu().numpy(), "(expected ≈ [1, 1])")
    return sol


if __name__ == "__main__":
    main()
