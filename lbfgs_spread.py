#!/usr/bin/env python3
"""The three L-BFGS examples' records in the port against the JAX
package's, beside the reference's own spread.

    JAX_PLATFORMS=cpu python3 lbfgs_spread.py

Runs tests/test_torch_examples.py's solves (01_rosenbrock_l1,
03_group_lasso, 07_poisson; float64, CPU) through `scso_tpu` and
`scso_tpu_torch`, and each of the reference's last-ulp variants of the
same problem through `scso_tpu`. Printed for each example: the relative
deviation of the port's record from the reference's, and the spread of
each group of variants (the most any variant of the group moves the
record), at every tenth record and from the record where a group's
spread last changes bits on; then, for 01, how many of 300 points
(seeded) give the reference's jitted ``rosenbrock`` bit for bit when f
is rounded op by op (the port's) and when x₁ − x₀² and the final sum
are each one fused multiply-add, emulated exactly. One JSON line last.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from fractions import Fraction

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: example → {group: variants}
GROUPS = {"01_rosenbrock_l1": {"x0 one ulp": (1, 2, 3, 4),
                               "x1*x1 in f": (5,)},
          "03_group_lasso": {"rows permuted": (1, 2, 3)},
          "07_poisson": {"rows permuted": (1, 2, 3)}}


def _tests():
    spec = importlib.util.spec_from_file_location(
        "test_torch_examples",
        os.path.join(ROOT, "tests", "test_torch_examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fma_points(n=300, seed=0):
    import jax
    import jax.numpy as jnp
    import torch

    from scso_tpu.models import losses as jl
    from scso_tpu_torch.models import losses as tl

    fma = lambda a, b, c: float(Fraction(a) * Fraction(b) + Fraction(c))
    pts = np.random.default_rng(seed).normal(size=(n, 2)) * 0.5 + [0.5, 0.3]
    f = jax.jit(jl.rosenbrock)
    ref = [float(f(jnp.asarray(p))) for p in pts]
    port = [float(tl.rosenbrock(torch.tensor(p, dtype=torch.float64)))
            for p in pts]

    def fused(x0, x1):
        a = fma(-x0, x0, x1)
        return fma(1.0 - x0, 1.0 - x0, 100.0 * (a * a))

    return {"points": n,
            "op_by_op_equal": int(sum(a == b for a, b in zip(port, ref))),
            "two_fmas_equal": int(sum(fused(*p) == r
                                      for p, r in zip(pts, ref)))}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    import scso_tpu as scso
    import scso_tpu_torch as st
    from scso_tpu.models import losses as jl
    from scso_tpu.models import synthetic as js
    from scso_tpu_torch.models import losses as tl
    from scso_tpu_torch.models import synthetic as ts

    t = _tests()
    out = {}
    for name, groups in GROUPS.items():
        solve = t.LBFGS[name][0]
        ref = t._objs(solve(scso, jl, js, 0))
        rel = lambda o: np.abs(o - ref) / np.abs(ref)
        dev = rel(t._objs(solve(st, tl, ts, 0)))
        res = {"records": len(ref), "port": dev}
        for g, variants in groups.items():
            res[g] = np.max([rel(t._objs(solve(scso, jl, js, v)))
                             for v in variants], axis=0)
        print(f"{name}: {len(ref)} records")
        for g in groups:
            moved = np.flatnonzero(res[g] > 0)
            since = int(moved[-1]) + 1 if moved.size else 0
            tail = slice(since, None)
            print(f"  {g}: spread 0 from record {since} on"
                  if since < len(ref) else f"  {g}: spread > 0 at the end")
            if since < len(ref):
                print(f"    there the port deviates {dev[tail].min():.3e} "
                      f"to {dev[tail].max():.3e}")
        for r in range(0, len(ref), 10):
            print(f"  record {r}: port {dev[r]:.3e}, " + ", ".join(
                f"{g} {res[g][r]:.3e}" for g in groups))
        out[name] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in res.items()}
    out["01_f_rounding"] = _fma_points()
    print(f"01's f at {out['01_f_rounding']['points']} points: JAX's bits "
          f"op by op {out['01_f_rounding']['op_by_op_equal']}, with two "
          f"FMAs {out['01_f_rounding']['two_fmas_equal']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
