#!/usr/bin/env python3
"""How far the JAX package's float32 λ sweep depends on its batch width.

    JAX_PLATFORMS=cpu python3 width_spread_jax.py [--every 8] [--parts 4]

The reference package (`scso_tpu`, JAX on the CPU, float32, x64 off) on
bench.py's family_sweep(big=True) problem: logistic01 at 2048×128 (seed
7), ProxNSCORE(solver='cg', ss_type=3), PHuberSmootherL1L2(1.0),
max_epoch 60, stats_every 4, x_tol 1e-6, the throughput plan. The grid
is every ``--every``-th point of its 4096-point λ = logspace(−3, −0.5),
cut so that the run stays small on a CPU. The same instances are solved
once in one sweep, and again ``--parts`` instances-slices at a time
(``--parts`` sweeps of a narrower batch); then a few instances spread
over the grid as scalar solves (`scso_tpu.iterate`, no vmap). Printed:
for the instances that converged (under 60 epochs) in both runs, the
quantiles of the relative difference of the final objectives, how many
lie beyond 5e-6 (chip_smoke.E2E_RTOL) and how many are equal, for the
narrow sweeps and for the scalar solves, each against the wide sweep;
then one JSON line.

Imports the JAX package only: it witnesses the reference's own
behaviour beside what chip_smoke.py phase 20 and chip_sharded.py report
for the port on the card.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import scso_tpu as scso  # noqa: E402
from scso_tpu._src.struct import replace as dc_replace  # noqa: E402
from scso_tpu.models import losses, synthetic  # noqa: E402
from scso_tpu.parallel import sweep  # noqa: E402

RTOL = 5e-6
CAP = 60
SCALAR = 8


def spread(obj, other, ep, other_ep):
    both = (ep < CAP) & (other_ep < CAP)
    rel = np.abs(other - obj) / np.abs(obj)
    r = rel[both].astype(np.float64)
    return dict(converged_both=int(both.sum()),
                rel_obj_quantiles_50_90_99_100=(
                    np.quantile(r, [0.5, 0.9, 0.99, 1.0]).tolist()
                    if r.size else None),
                beyond_rtol=int((r > RTOL).sum()),
                exactly_equal=int((r == 0).sum()),
                epochs_equal=int((ep == other_ep).sum()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--every", type=int, default=8)
    ap.add_argument("--parts", type=int, default=4)
    args = ap.parse_args()
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        2048, 128, density=0.1, n_active=16, seed=7, dtype=np.float32,
        label01=True)
    prob = scso.Problem(A, y, x0, losses.logistic01_f, 0.01,
                        grad_fx=losses.logistic01_grad,
                        hvp_w=losses.logistic01_hvp_w,
                        glm=losses.LOGISTIC01_GLM, dtype=np.float32)
    lam = np.logspace(-3, -0.5, 4096).astype(np.float32)[::args.every]
    B = lam.size
    opts = scso.Options(max_epoch=CAP, verbose=0, stats_every=4, x_tol=1e-6)
    meth = scso.ProxNSCORE(solver="cg", ss_type=3)
    sm = scso.PHuberSmootherL1L2(1.0)
    run = lambda grid: sweep(meth, prob, "l1", sm, lam_grid=grid, opts=opts,
                             plan="throughput")
    t0 = time.perf_counter()
    wide = run(lam)
    obj, ep = np.asarray(wide.obj), np.asarray(wide.epochs)
    w = B // args.parts
    parts = [run(lam[k * w:(k + 1) * w]) for k in range(args.parts)]
    pobj = np.concatenate([np.asarray(p.obj) for p in parts])
    pep = np.concatenate([np.asarray(p.epochs) for p in parts])
    picks = np.linspace(0, B - 1, SCALAR).round().astype(int)
    sobj, sep = [], []
    for i in picks:
        p = dc_replace(prob, lam=jnp.asarray(lam[i], jnp.float32))
        sol = scso.iterate(meth, p, "l1", sm, max_epoch=CAP, verbose=0,
                           stats_every=4, x_tol=1e-6)
        sobj.append(float(np.asarray(sol.obj)[-1]))
        sep.append(int(sol.epochs))
    out = dict(
        backend=jax.default_backend(), dtype=str(np.asarray(wide.x).dtype),
        instances=B, every=args.every, narrow_width=w,
        converged_wide=int((ep < CAP).sum()),
        narrow_vs_wide=spread(obj, pobj, ep, pep),
        scalar_vs_wide=dict(
            picks=picks.tolist(),
            **spread(obj[picks], np.asarray(sobj), ep[picks],
                     np.asarray(sep))),
        seconds=time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
