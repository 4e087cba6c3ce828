"""Out-of-core rows on the PyTorch port (the counterpart of
examples/11_outofcore_bigrows.py): disk → chunked loads → row-sharded
solve.

A dataset is synthesized straight to disk (never held in RAM at once,
benchmarks/gen_bigrows.py), each rank reads its own rows in bounded
chunks (`load_problem_rows_sharded(chunk_bytes=...)`) onto its device,
and the GGN-CG solve runs on the row-sharded problem over the ranks the
example is started with:

    python examples/torch/11_outofcore_bigrows.py [--rows R --n N]
    torchrun --nproc-per-node=4 examples/torch/11_outofcore_bigrows.py

The default (65536×64, 16 MiB) is small enough for the CPU.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

import scso_tpu_torch as st  # noqa: E402
from scso_tpu_torch.models import losses  # noqa: E402
from scso_tpu_torch.parallel import (  # noqa: E402
    load_problem_rows_sharded, make_mesh)
from scso_tpu_torch.problems import resolve_device  # noqa: E402

from _common import ranks  # noqa: E402


def _solve(args, workdir, dev):
    """Synthesize the data under ``workdir`` (unless it is there), load
    this rank's rows and solve."""
    datadir = os.path.join(workdir, f"rows_{args.rows}x{args.n}")
    if not os.path.exists(os.path.join(datadir, "manifest.json")):
        # chunked straight-to-disk synthesis (host RSS: one chunk)
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            _HERE)), "benchmarks"))
        from gen_bigrows import generate

        generate(datadir, args.rows, args.n, seed=7)
    x0 = np.load(os.path.join(datadir, "x0.npy"))

    with ranks(dev):
        # one mesh axis over all ranks; each rank reads only its rows,
        # in reads of at most chunk_mib
        mesh = make_mesh(axis_names=("data",))
        prob = load_problem_rows_sharded(
            datadir, x0, losses.logistic01_f, 0.01, mesh,
            chunk_bytes=args.chunk_mib << 20, device=dev,
            grad_fx=losses.logistic01_grad, out_fn=losses.sigmoid_out,
            grad_fy=losses.logistic_ggn_residual,
            hess_fy_diag=losses.logistic_ggn_qdiag,
            loss_fn=losses.logistic_loss_01,
            hvp_w=losses.logistic01_hvp_w, ggn_w=losses.logistic_ggn_w,
            glm=losses.LOGISTIC01_GLM)
        print(f"loaded {args.rows}x{args.n} "
              f"({args.rows * args.n * 4 / 2**30:.2f} GiB) over "
              f"{mesh.size} rank(s)")

        sol = st.iterate(
            st.ProxGGNSCORE(solver="cg"), prob, "l1",
            st.PHuberSmootherL1L2(1.0),
            max_epoch=60, x_tol=1e-8, verbose=0, alpha=1.0)
    return sol


def main(argv=(), device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--chunk-mib", type=int, default=64)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(list(argv))
    dev = resolve_device(device)

    with tempfile.TemporaryDirectory(prefix="scso_bigrows_") as tmp:
        sol = _solve(args, args.workdir or tmp, dev)
    nnz = int((sol.x.abs() > 1e-6).sum())
    print(f"epochs={sol.epochs}  obj={float(sol.obj[-1]):.6f}  "
          f"nnz={nnz}/{sol.x.numel()}")
    return sol


if __name__ == "__main__":
    main(sys.argv[1:])
