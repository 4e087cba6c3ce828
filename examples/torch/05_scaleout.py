"""Scale-out on the PyTorch port (the counterpart of
examples/05_scaleout.py): a row-sharded solve, a λ-path sweep as one
batched solve over a batch axis, the same path in warm-started waves,
and a problem loaded from disk shard by shard.

The mesh is the ranks the example is started with: one process alone,

    python examples/torch/05_scaleout.py

or one rank a card,

    torchrun --nproc-per-node=4 examples/torch/05_scaleout.py
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import scso_tpu_torch as st  # noqa: E402
from scso_tpu_torch.models import losses, synthetic  # noqa: E402
from scso_tpu_torch.parallel import (  # noqa: E402
    load_problem_rows_sharded, make_mesh, save_problem_data, shard_problem,
    sweep)
from scso_tpu_torch.problems import resolve_device  # noqa: E402

from _common import ranks  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    m, n = 4096, 128
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        m, n, density=0.1, n_active=16, seed=7, dtype=np.float32,
        label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      grad_fx=losses.logistic01_grad,
                      hvp_w=losses.logistic01_hvp_w,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                      device=dev)
    # Armijo (ss_type=3): from a far random start the saturated-sigmoid
    # Newton step needs a line search to stay stable at small λ
    method = st.ProxNSCORE(solver="cg", ss_type=3)
    sm = st.PHuberSmootherL1L2(1.0)

    with ranks(dev):
        # 1. row-sharded solve: data parallel over all ranks
        mesh = make_mesh()
        sol = st.iterate(method, shard_problem(prob, mesh), "l1", sm,
                         max_epoch=50, verbose=0)
        print(f"row-sharded over {mesh.size} rank(s):", sol)

        # 2. the λ regularization path as ONE batched solve, its
        # instances split over the ranks of a batch axis
        bmesh = make_mesh(axis_names=("batch",))
        lam_grid = np.logspace(-4, -1, 8).astype(np.float32)
        res = sweep(method, prob, "l1", sm, lam_grid=lam_grid,
                    opts=st.Options(max_epoch=50, verbose=0), mesh=bmesh)
        nnz = (res.x.abs() > 1e-6).sum(dim=1).tolist()
        for lam, k, o in zip(lam_grid, nnz, res.obj.tolist()):
            print(f"  λ={lam:.4f}  nnz={k:4d}  obj={o:.6f}")

        # 3. the same path in glmnet-style warm-started waves: sorted-λ
        # chunks, each starting from the previous wave's solutions;
        # wave_max_epoch bounds the straggler tail of the warm waves
        resw = sweep(method, prob, "l1", sm, lam_grid=lam_grid,
                     opts=st.Options(max_epoch=50, verbose=0),
                     path_waves=4, wave_max_epoch=20)
        print("cold epochs:", int(res.epochs.sum()),
              " warm-wave epochs:", int(resw.epochs.sum()))

        # 4. sharded IO: each rank reads only its rows from disk; the
        # solve from disk matches the in-memory sharded one bit for bit
        with tempfile.TemporaryDirectory() as d:
            save_problem_data(d, A, y)
            loaded = load_problem_rows_sharded(
                d, x0, losses.logistic01_f, 0.01, mesh,
                grad_fx=losses.logistic01_grad,
                hvp_w=losses.logistic01_hvp_w, glm=losses.LOGISTIC01_GLM,
                device=dev)
            sol_disk = st.iterate(method, loaded, "l1", sm, max_epoch=50,
                                  verbose=0)
            print("solve-from-disk matches:",
                  bool(torch.equal(sol_disk.x, sol.x)))
    return res


if __name__ == "__main__":
    main()
