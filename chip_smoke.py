#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (scso_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It never falls back to the CPU: without
a CUDA device, or outside a checkout, it exits non-zero and prints no
result. Phases, each fatal on failure:

  1. The card (name and power limit from nvidia-smi); build the CUDA
     kernels from ``scso_tpu_torch/csrc`` and print the build seconds.
  2. Each kernel against its plain PyTorch version on the card, in
     float32 and float64, at the main-path and narrow shapes (K1, K2),
     at block-boundary shapes, and at odd n for K3; two runs of a kernel
     must give bitwise-equal outputs. Times (CUDA events, median of 20)
     of each kernel beside its plain version at the main-path shape.
  3. The main path at full width: sparse logistic regression
     196608×10000 (padded to 10112), seed 7, float32 on the card,
     solved by the no-knob ProxGGNSCORE(solver='cg', cg_maxiter=100)
     with the pseudo-Huber l1 smoother — a presolve chain fixes x*, then
     a timed chain from x0 must reach the 1e-6 objective gap with every
     kernel's launch counter > 0.
  4. Cross-checks: the same timed chain with kernels='torch' must agree
     on the final objective, and a small float64 solve through the
     kernels must match the plain path on the CPU.

The last two lines of standard output are one JSON object with each
kernel's numbers, then ``{"ok": true, "device": {...}}``.
Tolerances (stated with each comparison below): float32 rtol 2e-5 and
atol 3e-5·max|ref|; float64 rtol 1e-12 and atol 1e-12·max|ref|.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 7
CHUNK = 60            # epochs per solve in a chain (as bench.py)
GAP = 1e-6
MAIN_SHAPE = (196608, 10000)
NARROW_SHAPE = (524288, 1024)
# tests/test_pallas.py's block-boundary shapes, then ragged n (rows not
# 16-byte aligned: the kernels' one-value-per-load path)
BOUNDARY_SHAPES = [(37, 128), (947, 384), (2249, 1920), (131, 128),
                   (660, 256), (3465, 2432), (999, 1001), (64, 130)]
K3_NS = [7, 129, 1000, 8192, 8320, 9001, 16384, 23456, 131072]
K3_REGS = ["l1", "l2", "indbox", "none"]
TOL = {"float32": (2e-5, 3e-5), "float64": (1e-12, 1e-12)}
E2E_RTOL = 5e-6       # final objective, kernels vs plain, float32
SMALL_RTOL = 1e-9     # small float64 solve, card kernels vs CPU plain

KERNELS = {
    "normal_matvec": ("scso_tpu_torch/csrc/matvec.cu",
                      "scso_tpu/ops/pallas/matvec.py:118"),
    "glm_prep_pair": ("scso_tpu_torch/csrc/glm_prep.cu",
                      "scso_tpu/ops/pallas/glm_prep.py:239"),
    "score_update": ("scso_tpu_torch/csrc/score_update.cu",
                     "scso_tpu/ops/pallas/score_update.py:108"),
}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def compare(name, got, want, dtype_name):
    """Max abs error; fails past rtol + atol·max|ref| (per dtype)."""
    import torch

    rtol, atol_rel = TOL[dtype_name]
    got, want = got.double(), want.double()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = (got - want).abs()
    bound = rtol * want.abs() + atol_rel * scale
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    if bool((err > bound).any()):
        fail(f"{name}: max abs err {float(err.max()):.3e} exceeds "
             f"rtol {rtol:g} + atol {atol_rel:g}·{scale:.3e}")
    return float(err.max()) if err.numel() else 0.0


def same_bits(name, a, b):
    import torch

    for i, (u, v) in enumerate(zip(a, b)):
        if not torch.equal(u, v):
            fail(f"{name}: rerun output {i} differs bitwise")


def time_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of one call, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def data_kernel_case(m, n, dtype, gen, timed=False):
    """K1 and K2 against their plain versions on random data (m, n)."""
    import torch

    from scso_tpu_torch.models.losses import LOGISTIC01_GLM
    from scso_tpu_torch.ops.cuda.glm_prep import (
        glm_prep_pair, glm_prep_pair_torch)
    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_torch)

    dev = "cuda"
    dn = str(dtype).replace("torch.", "")
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
    A.mul_(0.1)
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype) / m
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    y = (torch.rand((m,), generator=gen, device=dev) < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    xd = torch.randn((n,), generator=gen, device=dev, dtype=dtype) * 0.1
    tag = f"({m}x{n} {dn})"
    res = {}

    k1 = normal_matvec(A, w, v)
    same_bits(f"normal_matvec {tag}", [k1], [normal_matvec(A, w, v)])
    res["normal_matvec"] = compare(f"normal_matvec {tag}", k1,
                                   normal_matvec_torch(A, w, v), dn)
    del k1

    pp = glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)
    same_bits(f"glm_prep_pair {tag}", pp,
              glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM))
    ref = glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM)
    res["glm_prep_pair"] = max(
        compare(f"glm_prep_pair.{f} {tag}", g, r, dn)
        for f, g, r in zip(pp._fields, pp, ref))
    del pp, ref
    times = {}
    if timed:
        times["normal_matvec"] = (
            time_ms(lambda: normal_matvec(A, w, v)),
            time_ms(lambda: normal_matvec_torch(A, w, v)))
        times["glm_prep_pair"] = (
            time_ms(lambda: glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_pair_torch(A, y, xt, xd,
                                                LOGISTIC01_GLM)))
    del A
    torch.cuda.empty_cache()
    return res, times


def score_update_case(n, reg, dtype, gen, timed=False):
    import torch

    from scso_tpu_torch.ops.cuda.score_update import (
        score_update, score_update_torch)

    dev = "cuda"
    dn = str(dtype).replace("torch.", "")
    r = lambda: torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    x, d, lgr = r(), r(), r()
    lgr[torch.rand((n,), generator=gen, device=dev) < 0.1] = 0.0
    hr = torch.rand((n,), generator=gen, device=dev, dtype=dtype) + 1e-3
    lam = torch.tensor(0.07, dtype=dtype, device=dev)
    ss = torch.tensor(0.6, dtype=dtype, device=dev)
    lb = torch.full((n,), -0.5, dtype=dtype, device=dev)
    ub = torch.full((n,), 0.7, dtype=dtype, device=dev)
    use_prox = reg != "none"
    args = (x, d, lgr, hr, lam, ss, 3.0, "l1" if reg == "none" else reg,
            use_prox, lb, ub)
    tag = f"score_update (n={n} {reg} {dn})"
    got = score_update(*args)
    same_bits(tag, got, score_update(*args))
    want = score_update_torch(*args)
    err = max(compare(f"{tag}.{f}", g, w_, dn)
              for f, g, w_ in zip(got._fields, got, want))
    times = None
    if timed:
        times = (time_ms(lambda: score_update(*args)),
                 time_ms(lambda: score_update_torch(*args)))
    return err, times


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    main = (MAIN_SHAPE[0], MAIN_SHAPE[1] + (-MAIN_SHAPE[1]) % 128)
    errs = {k: 0.0 for k in KERNELS}
    times = {}
    for dtype in (torch.float32, torch.float64):
        for (m, n) in [main, NARROW_SHAPE] + BOUNDARY_SHAPES:
            timed = dtype == torch.float32 and (m, n) == main
            t0 = time.perf_counter()
            res, t = data_kernel_case(m, n, dtype, gen, timed=timed)
            log(f"  K1/K2 {m}x{n} {dtype}: max abs err "
                f"K1 {res['normal_matvec']:.3e} "
                f"K2 {res['glm_prep_pair']:.3e} "
                f"({time.perf_counter() - t0:.1f} s)")
            if timed:
                times.update(t)
                errs.update(res)
        for n in K3_NS:
            for reg in K3_REGS:
                score_update_case(n, reg, dtype, gen)
        # K3 at the main-path width (not in the odd-n list)
        err, t = score_update_case(main[1], "l1", dtype, gen,
                                   timed=dtype == torch.float32)
        if dtype == torch.float32:
            times["score_update"] = t
            errs["score_update"] = err
        log(f"  K3 {len(K3_NS)}×{len(K3_REGS)} cases + n={main[1]} "
            f"{dtype}: ok")
    for k, (ms, plain) in times.items():
        log(f"  time at the main-path shape, {k}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms (CUDA events, median of 20)")
    return errs, times


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def build_problem(M, N, device, dtype, sol=None):
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        M, N, density=0.05, n_active=64, seed=SEED, dtype=np.float32,
        label01=True)
    return st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      glm=losses.LOGISTIC01_GLM, sol=sol, dtype=dtype,
                      device=device, pad_features=True)


def solve_chunk(method, prob):
    import scso_tpu_torch as st

    return st.iterate(method, prob, "l1", st.PHuberSmootherL1L2(1.0),
                      x_tol=1e-12, f_tol=GAP, max_epoch=CHUNK, verbose=0,
                      stats_every=4, alpha=1.0)


def presolve(method, prob):
    """Chain warm-started solves until the objective stops improving by
    1e-7 relative (at most 12): the best iterate anchors x*."""
    from scso_tpu_torch._src.struct import replace

    best, x_opt, cur, epochs = float("inf"), None, prob, 0
    for _ in range(12):
        s = solve_chunk(method, cur)
        epochs += s.epochs
        obj = float(s.obj[-1])
        improved = obj < best * (1 - 1e-7)
        if obj < best:
            best, x_opt = obj, s.state.x
        if not improved:
            break
        cur = replace(cur, x0=s.state.x)
    return best, x_opt, epochs


def timed_chain(method, prob, best):
    """Fresh solves from x0 against x*, chained until the gap fires."""
    from scso_tpu_torch._src.struct import replace

    t_solve, epochs, cg_total, cur, prev_gap = 0.0, 0, 0, prob, float("inf")
    for _ in range(12):
        t0 = time.perf_counter()
        s = solve_chunk(method, cur)
        t_solve += time.perf_counter() - t0
        epochs += s.epochs
        cg_total += (s.cg_info or {}).get("total_cg_iters", 0)
        gap = float(s.objrel[-1])
        signed_min = float(((s.obj - best) / abs(best)).min())
        if gap <= GAP or signed_min <= GAP:
            break
        if s.epochs < CHUNK and gap >= prev_gap * 0.99:
            break
        prev_gap = gap
        cur = replace(cur, x0=s.state.x)
    if gap > GAP and signed_min <= GAP:
        gap = GAP  # reached below the anchor
    return dict(seconds=t_solve, epochs=epochs, cg_iters=cg_total,
                gap=gap, obj=float(s.obj[-1]))


def phase_main_path():
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_problem(*MAIN_SHAPE, "cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"  data {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]} padded to "
        f"{tuple(prob.A.shape)}, made and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100)
    t0 = time.perf_counter()
    best, x_opt, pre_epochs = presolve(method, prob)
    log(f"  presolve: obj* {best:.9e} after {pre_epochs} epochs "
        f"({time.perf_counter() - t0:.1f} s)")
    prob_t = replace(prob, x_star=x_opt)
    solve_chunk(method, prob_t)  # warm-up

    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
        f"gap {kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the kernel path missed the {GAP:g} gap: {kern['gap']:.3e}")
    for k, c in launches.items():
        if c <= 0:
            fail(f"kernel {k} was not launched on the main path")

    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"final objectives differ: kernels {kern['obj']:.9e}, torch "
             f"{plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    return kern, plain, launches


def phase_small_f64():
    """A small float64 solve through the kernels on the card against the
    plain path on the CPU: the objective histories must agree."""
    import torch

    import scso_tpu_torch as st

    M, N = 512, 200
    method = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    s_gpu = solve_chunk(method, build_problem(M, N, "cuda", torch.float64))
    s_cpu = solve_chunk(method, build_problem(M, N, "cpu", torch.float64))
    if s_gpu.epochs != s_cpu.epochs or s_gpu.x.shape != (N,):
        fail(f"small f64 solve: epochs {s_gpu.epochs} vs {s_cpu.epochs}, "
             f"x shape {tuple(s_gpu.x.shape)}")
    rel = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not bool(torch.isfinite(s_gpu.x).all()) or not rel <= SMALL_RTOL:
        fail(f"small f64 solve: objective histories differ by {rel:.2e}")
    log(f"  small f64 {M}x{N}: {s_gpu.epochs} epochs, card kernels vs "
        f"CPU plain max rel objective diff {rel:.2e} "
        f"(tolerance {SMALL_RTOL:g})")


# ---------------------------------------------------------------------------


def main():
    if not os.path.isdir(os.path.join(ROOT, "scso_tpu_torch")):
        fail("scso_tpu_torch not found beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the GPU and does not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from scso_tpu_torch.ops.cuda import build

    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    res = build.build()
    build.load()
    log(f"  kernels built in {res.seconds:.2f} s -> {res.path} "
        "(nvcc's report: build.log beside it)")

    log("phase 2: kernels against their plain versions")
    errs, times = phase_kernels()

    log("phase 3/4: main path at full width, and cross-checks")
    kern, plain, launches = phase_main_path()
    phase_small_f64()

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "scso_tpu"
              or m.startswith("scso_tpu.")]
    if leaked:
        fail(f"the port imported {leaked}")

    log("main path: " + json.dumps({"card": card, "kernels": kern,
                                    "torch": plain}))
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
