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
     float32 and float64, at the main-path and narrow shapes (K1, K2
     also normalized by another row count, K2s, and K1s under a one-rank NCCL group: bitwise K1, and its
     overlapped form with 2 and 3 column chunks against the plain
     version), at block-boundary shapes, at n above K1's shared-memory form,
     at odd n for K3, for K5 at the multinomial bench shape, at boundary
     shapes (both of its forms) and at k = 1, 17 and 128, and for K4 at
     the L-BFGS path's shape and at other n and m with empty, partial,
     full and wrapped memories and a slot with yᵀs = 0; two runs of a
     kernel must give bitwise-equal outputs. Times (CUDA events, median
     of 20) of each kernel beside its plain version at its path's
     full-width shape, and of one 40 KB NCCL all-reduce.
  3. The sparse-logistic path at full width: 196608×10000 (padded to
     10112), seed 7, float32 on the card, solved by the no-knob
     ProxGGNSCORE(solver='cg', cg_maxiter=100) with the pseudo-Huber l1
     smoother — a presolve chain fixes x*, then a timed chain from x0
     must reach the 1e-6 objective gap with K1, K2 and K3 launched.
  4. Cross-checks: the same timed chain with kernels='torch' must agree
     on the final objective, and a small float64 solve through the
     kernels must match the plain path on the CPU.
  5. The multinomial path at full width (the JAX bench's
     family_multinomial(big=True)): 196608×1024×16, seed 11, float32,
     λ = 1e-3, the same method and protocol — K5 and K3 launched, K1
     and K2 not; the kernels='torch' chain must agree on the final
     objective, and a small float64 multinomial solve through the
     kernels must match the plain path on the CPU.
  6. The L-BFGS path (ProxLQNSCORE(m=10), the default method, with the
     closed-form gradient) on phase 3's data, from x0 for a fixed 300
     epochs, with kernels and with kernels='torch': K4 and K3 launched
     and no other kernel, the two objective histories within 1e-5
     relative, the gap to phase 3's anchor printed; a small float64
     L-BFGS solve through the kernels must match the CPU plain path.
  7. The uncached GGN-CG path (ProxGGNSCORE(solver='cg', cg_maxiter=100,
     epoch_cache=False)) on phase 3's data under phase 3's protocol to
     the 1e-6 gap: K2s, K1 and K3 launched, K2, K4 and K5 not; the
     kernels='torch' chain must agree on the final objective, and a
     small float64 uncached solve through the kernels must match the
     CPU plain path.
  8. The row-sharded cached GGN-CG path. (a) `shard_problem` of phase
     3's problem over the one-rank NCCL mesh under phase 3's protocol:
     the same epochs, CG iterations and final objective, bitwise, with
     K1s, K1, K2 and K3 launched as often as K1, K2 and K3 in phase 3.
     (b) Two ranks on the one card over gloo (NCCL refuses two ranks on
     one card): the parent writes 2×32768×10000 rows (seed 7) with
     `save_problem_data` to a temporary directory, two worker processes
     of this script load their rows with `load_problem_rows_sharded`
     and solve to the 1e-6 gap with comm_overlap_chunks 1 and 2; each
     final objective within E2E_RTOL of the parent's unsharded chain,
     x bitwise equal on both ranks, and a small float64 two-rank solve
     matching the CPU's plain unsharded solve to 1e-9. Its seconds are
     not a scaling number.

The last two lines of standard output are one JSON object with each
kernel's numbers, then ``{"ok": true, "device": {...}}``. Each kernel's
``bound_ms`` is the larger of the bytes it must move (each input read
once, each output written once) over 3.35 TB/s and its multiply-adds
over A (or the vectors) at 67 TFLOP/s, the H100 SXM data sheet's HBM
and FP32 rates, at the shape it was timed; ``library_ms`` is null: no
single PyTorch call computes any of these functions.
Tolerances (stated with each comparison below): float32 rtol 2e-5 and
atol 3e-5·max|ref|; float64 rtol 1e-12 and atol 1e-12·max|ref|.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
WIDE_SHAPES = [(4099, 40000, "float32"), (2049, 20000, "float64")]
MGLM_SHAPE = (196608, 1024, 16)
# tests/test_multioutput.py's kernel and odd shapes, the widest p of
# K5's one-read form (k <= 16, p <= 1024) and the first past it (its
# two-pass form), then k = 1, 17 and 128 at odd m and p
MGLM_SHAPES = [(512, 128, 8), (700, 256, 4), (130, 128, 3), (16, 1, 2),
               (33, 5, 7), (8, 12, 2), (64, 4, 11), (3001, 1024, 16),
               (3001, 1025, 9), (1031, 77, 1), (1031, 77, 17),
               (1031, 77, 128)]
TOL = {"float32": (2e-5, 3e-5), "float64": (1e-12, 1e-12)}
E2E_RTOL = 5e-6       # final objective, kernels vs plain, float32
SMALL_RTOL = 1e-9     # small float64 solve, card kernels vs CPU plain
LBFGS_EPOCHS = 300
LBFGS_RTOL = 1e-5     # L-BFGS objective histories, kernels vs plain, f32
# K4 cases: (n, m, pairs pushed); the first is the L-BFGS path's shape
TWO_LOOP_CASES = [(10112, 10, 10), (10112, 10, 0), (361, 5, 3),
                  (777, 9, 18), (100000, 10, 13), (64, 1, 4)]
TWO_RANK_ROWS = 32768  # rows of each rank in phase 8(b)
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet: HBM3 rate
FP32_FLOP_S = 67e12    # H100 SXM data sheet: FP32 outside the tensor cores

KERNELS = {
    "normal_matvec": ("scso_tpu_torch/csrc/matvec.cu",
                      "scso_tpu/ops/pallas/matvec.py:118"),
    "normal_matvec_sharded": ("scso_tpu_torch/ops/cuda/matvec.py",
                              "scso_tpu/ops/pallas/matvec.py:196"),
    "glm_prep_pair": ("scso_tpu_torch/csrc/glm_prep.cu",
                      "scso_tpu/ops/pallas/glm_prep.py:239"),
    "glm_prep": ("scso_tpu_torch/csrc/glm_prep.cu",
                 "scso_tpu/ops/pallas/glm_prep.py:84"),
    "score_update": ("scso_tpu_torch/csrc/score_update.cu",
                     "scso_tpu/ops/pallas/score_update.py:108"),
    "mglm_matvec": ("scso_tpu_torch/csrc/mglm_matvec.cu",
                    "scso_tpu/ops/pallas/mglm_matvec.py:152"),
    "two_loop": ("scso_tpu_torch/csrc/two_loop.cu",
                 "scso_tpu/ops/pallas/two_loop.py:69"),
}
LOGISTIC_KERNELS = ("normal_matvec", "glm_prep_pair", "score_update")
MGLM_KERNELS = ("mglm_matvec", "score_update")
LBFGS_KERNELS = ("two_loop", "score_update")
UNCACHED_KERNELS = ("glm_prep", "normal_matvec", "score_update")
SHARDED_KERNELS = ("normal_matvec_sharded", "normal_matvec", "glm_prep_pair",
                   "score_update")


def fail(msg: str):
    print(f"{os.path.basename(sys.argv[0])} FAILED: {msg}", file=sys.stderr,
          flush=True)
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


def data_kernel_case(m, n, dtype, gen, mesh, timed=False):
    """K1, K1s (on the one-rank ``mesh``), K2 and K2s against their
    plain versions on random data (m, n)."""
    import torch

    from scso_tpu_torch.models.losses import LOGISTIC01_GLM
    from scso_tpu_torch.ops.cuda.glm_prep import (
        glm_prep, glm_prep_pair, glm_prep_pair_torch, glm_prep_torch)
    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_sharded, normal_matvec_sharded_torch,
        normal_matvec_torch)

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
    # K1s: one rank's all-reduce is a copy, so bitwise K1; its
    # overlapped form against K1s's plain version
    if not torch.equal(normal_matvec_sharded(A, w, v, mesh), k1):
        fail(f"normal_matvec_sharded {tag}: not bitwise K1 on one rank")
    plain = normal_matvec_sharded_torch(A, w, v, mesh)
    res["normal_matvec_sharded"] = max(
        [compare(f"normal_matvec_sharded {tag}", k1, plain, dn)]
        + [compare(f"normal_matvec_sharded overlap {c} {tag}",
                   normal_matvec_sharded(A, w, v, mesh, overlap_chunks=c),
                   plain, dn) for c in (2, 3)])
    del k1, plain

    pp = glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)
    same_bits(f"glm_prep_pair {tag}", pp,
              glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM))
    ref = glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM)
    res["glm_prep_pair"] = max(
        compare(f"glm_prep_pair.{f} {tag}", g, r, dn)
        for f, g, r in zip(pp._fields, pp, ref))
    del pp, ref
    # normalized by the rows of all ranks, as on one rank of four
    m_norm = 4 * m + 3
    pp = glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM, m_norm)
    ref = glm_prep_pair_torch(A, y, xt, xd, LOGISTIC01_GLM, m_norm)
    res["glm_prep_pair"] = max(
        [res["glm_prep_pair"]]
        + [compare(f"glm_prep_pair.{f} m_norm={m_norm} {tag}", g, r, dn)
           for f, g, r in zip(pp._fields, pp, ref)])
    del pp, ref

    k2s = glm_prep(A, y, xt, LOGISTIC01_GLM)
    same_bits(f"glm_prep {tag}", k2s, glm_prep(A, y, xt, LOGISTIC01_GLM))
    ref = glm_prep_torch(A, y, xt, LOGISTIC01_GLM)[:3]
    res["glm_prep"] = max(
        compare(f"glm_prep.{f} {tag}", g, r, dn)
        for f, g, r in zip(("w", "b", "hd"), k2s, ref))
    del k2s, ref
    times = {}
    if timed:
        times["normal_matvec"] = (
            time_ms(lambda: normal_matvec(A, w, v)),
            time_ms(lambda: normal_matvec_torch(A, w, v)))
        times["normal_matvec_sharded"] = (
            time_ms(lambda: normal_matvec_sharded(A, w, v, mesh)),
            time_ms(lambda: normal_matvec_sharded_torch(A, w, v, mesh)))
        times["glm_prep_pair"] = (
            time_ms(lambda: glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_pair_torch(A, y, xt, xd,
                                                LOGISTIC01_GLM)))
        times["glm_prep"] = (
            time_ms(lambda: glm_prep(A, y, xt, LOGISTIC01_GLM)),
            time_ms(lambda: glm_prep_torch(A, y, xt, LOGISTIC01_GLM)))
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


def two_loop_case(n, m, pushes, dtype, gen, timed=False):
    """K4 against its plain version on a memory of ``pushes``
    SPD-quadratic pairs (γ = B·δ); with two or more, one valid slot gets
    an s and a y of disjoint support, so yᵀs = 0 exactly."""
    import torch

    from scso_tpu_torch.ops import lbfgs_core
    from scso_tpu_torch.ops.cuda.two_loop import two_loop, two_loop_torch

    dev, dn = "cuda", str(dtype).replace("torch.", "")
    bdiag = torch.rand((n,), generator=gen, device=dev, dtype=dtype) * 4 + 0.5
    mem = lbfgs_core.init_memory(n, m, dtype, dev)
    for _ in range(pushes):
        delta = torch.randn((n,), generator=gen, device=dev,
                            dtype=dtype) * 0.1
        mem = lbfgs_core.update_memory(mem, delta, bdiag * delta)
    if pushes >= 2:
        slot = (int(mem.pos) - 2) % m
        S, Y = mem.S.clone(), mem.Y.clone()
        S[slot, n // 2:] = 0
        Y[slot, : n // 2] = 0
        mem = mem._replace(S=S, Y=Y)
    g = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    tag = f"two_loop (n={n} m={m} pairs={pushes} {dn})"
    got = two_loop(mem, g)
    same_bits(tag, [got], [two_loop(mem, g)])
    err = compare(tag, got, two_loop_torch(mem, g), dn)
    if pushes == 0 and not torch.equal(got, -g):
        fail(f"{tag}: an empty memory must give -g exactly")
    times = None
    if timed:
        times = (time_ms(lambda: two_loop(mem, g)),
                 time_ms(lambda: two_loop_torch(mem, g)))
    return err, times


def wide_matvec_case(m, n, dtype, gen):
    """K1 above its shared-memory form's n limit."""
    import torch

    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_torch)

    dev, dn = "cuda", str(dtype).replace("torch.", "")
    A = torch.randn((m, n), generator=gen, device=dev, dtype=dtype) * 0.1
    w = torch.rand((m,), generator=gen, device=dev, dtype=dtype) / m
    v = torch.randn((n,), generator=gen, device=dev, dtype=dtype)
    tag = f"normal_matvec wide ({m}x{n} {dn})"
    got = normal_matvec(A, w, v)
    same_bits(tag, [got], [normal_matvec(A, w, v)])
    return compare(tag, got, normal_matvec_torch(A, w, v), dn)


def mglm_case(m, p, k, dtype, gen, timed=False):
    """K5 against its plain version. Returns (max err, (kernel ms, plain
    ms) or None)."""
    import torch

    from scso_tpu_torch.models.losses import multinom_mglm
    from scso_tpu_torch.ops.cuda.mglm_matvec import (
        mglm_matvec, mglm_matvec_torch)

    dev, dn = "cuda", str(dtype).replace("torch.", "")
    A = torch.randn((m, p), generator=gen, device=dev, dtype=dtype)
    labels = torch.randint(0, k, (m,), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(labels, k).to(dtype)
    Z = A @ (torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
             * 0.3)
    V = torch.randn((p, k), generator=gen, device=dev, dtype=dtype)
    spec = multinom_mglm(k)
    tag = f"mglm_matvec ({m}x{p}x{k} {dn})"
    got = mglm_matvec(A, y, Z, V, spec)
    same_bits(tag, [got], [mglm_matvec(A, y, Z, V, spec)])
    err = compare(tag, got, mglm_matvec_torch(A, y, Z, V, spec), dn)
    times = None
    if timed:
        times = (time_ms(lambda: mglm_matvec(A, y, Z, V, spec)),
                 time_ms(lambda: mglm_matvec_torch(A, y, Z, V, spec)))
    del A
    torch.cuda.empty_cache()
    return err, times


def work_bounds(main, mglm_shape, lbfgs_case):
    """(bytes, flops) each kernel must move and do at its timed shape,
    float32: each input read once and each output written once; the
    multiply-adds over A (or, for K3 and K4, over the vectors). K1s is
    K1 plus one all-reduce of n values (read and written once on one
    rank)."""
    m, n = main
    mm, p, k = mglm_shape
    n4, mem = lbfgs_case[0], lbfgs_case[1]
    f = 4
    k1 = (f * (m * n + m + 2 * n), 4 * m * n)
    return {
        "normal_matvec": k1,
        "normal_matvec_sharded": (k1[0] + 2 * f * n, k1[1]),
        "glm_prep_pair": (f * (m * n + 3 * m + 6 * n + 2), 14 * m * n),
        "glm_prep": (f * (m * n + 2 * m + 3 * n), 7 * m * n),
        "score_update": (f * 5 * n, 20 * n),
        "mglm_matvec": (f * (mm * p + 2 * mm * k + 2 * p * k),
                        4 * mm * p * k),
        "two_loop": (f * (2 * mem * n4 + 2 * n4), 8 * mem * n4),
    }


def bound(bytes_, flops):
    """(bound_ms, bound_by) on the data sheet's H100 SXM peaks."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / FP32_FLOP_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(mesh):
    import torch
    import torch.distributed as dist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    main = (MAIN_SHAPE[0], MAIN_SHAPE[1] + (-MAIN_SHAPE[1]) % 128)
    errs = {k: 0.0 for k in KERNELS}
    times = {}
    for dtype in (torch.float32, torch.float64):
        for (m, n) in [main, NARROW_SHAPE] + BOUNDARY_SHAPES:
            timed = dtype == torch.float32 and (m, n) == main
            t0 = time.perf_counter()
            res, t = data_kernel_case(m, n, dtype, gen, mesh, timed=timed)
            log(f"  K1/K1s/K2/K2s {m}x{n} {dtype}: max abs err "
                f"K1 {res['normal_matvec']:.3e} "
                f"K1s {res['normal_matvec_sharded']:.3e} "
                f"K2 {res['glm_prep_pair']:.3e} "
                f"K2s {res['glm_prep']:.3e} "
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
        dn = str(dtype).replace("torch.", "")
        for (m, n, wdn) in WIDE_SHAPES:
            if wdn == dn:
                log(f"  K1 wide {m}x{n} {dn}: max abs err "
                    f"{wide_matvec_case(m, n, dtype, gen):.3e}")
        for (m, p, k) in [MGLM_SHAPE] + MGLM_SHAPES:
            timed = dtype == torch.float32 and (m, p, k) == MGLM_SHAPE
            t0 = time.perf_counter()
            err, t = mglm_case(m, p, k, dtype, gen, timed=timed)
            if (m, p, k) == MGLM_SHAPE:
                log(f"  K5 {m}x{p}x{k} {dn}: max abs err {err:.3e} "
                    f"({time.perf_counter() - t0:.1f} s)")
            if timed:
                times["mglm_matvec"] = t
                errs["mglm_matvec"] = err
        log(f"  K5 {len(MGLM_SHAPES)} boundary shapes {dn}: ok")
        for i, (n, m, pushes) in enumerate(TWO_LOOP_CASES):
            timed = dtype == torch.float32 and i == 0
            err, t = two_loop_case(n, m, pushes, dtype, gen, timed=timed)
            if i == 0:
                log(f"  K4 n={n} m={m} {dn}: max abs err {err:.3e}")
            if timed:
                times["two_loop"] = t
                errs["two_loop"] = err
        log(f"  K4 {len(TWO_LOOP_CASES)} memories {dn}: ok")
    for k, (ms, plain) in times.items():
        log(f"  time at the main-path shape, {k}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms (CUDA events, median of 20)")
    buf = torch.ones(main[1], device="cuda")
    ar_ms = time_ms(lambda: dist.all_reduce(buf, group=mesh.group))
    log(f"  one all-reduce of {buf.numel() * 4} bytes over the one-rank "
        f"NCCL group: {ar_ms:.4f} ms (CUDA events, median of 20)")
    return errs, times, work_bounds(main, MGLM_SHAPE, TWO_LOOP_CASES[0])


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
                      grad_fx=losses.logistic01_grad,
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


def timed_chain(method, prob, best, keep_x=False):
    """Fresh solves from x0 against x*, chained until the gap fires.
    ``keep_x`` adds the final iterate (a tensor) as ``x``."""
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
    out = dict(seconds=t_solve, epochs=epochs, cg_iters=cg_total, gap=gap,
               obj=float(s.obj[-1]))
    if keep_x:
        out["x"] = s.x
    return out


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
    check_launches(launches, LOGISTIC_KERNELS, "sparse-logistic")

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
    return kern, plain, launches, prob_t, best


def phase_small_f64(method, what, solve=None):
    """A small float64 solve through the kernels on the card against the
    plain path on the CPU: the objective histories must agree."""
    import torch

    M, N = 512, 200
    solve = solve or solve_chunk
    s_gpu = solve(method, build_problem(M, N, "cuda", torch.float64))
    s_cpu = solve(method, build_problem(M, N, "cpu", torch.float64))
    if s_gpu.epochs != s_cpu.epochs or s_gpu.x.shape != (N,):
        fail(f"small f64 {what} solve: epochs {s_gpu.epochs} vs "
             f"{s_cpu.epochs}, x shape {tuple(s_gpu.x.shape)}")
    rel = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not bool(torch.isfinite(s_gpu.x).all()) or not rel <= SMALL_RTOL:
        fail(f"small f64 {what} solve: objective histories differ by "
             f"{rel:.2e}")
    log(f"  small f64 {what} {M}x{N}: {s_gpu.epochs} epochs, card kernels "
        f"vs CPU plain max rel objective diff {rel:.2e} "
        f"(tolerance {SMALL_RTOL:g})")


def check_launches(launches, expected, what):
    for k, c in launches.items():
        if (c > 0) != (k in expected):
            fail(f"kernel {k} was launched {c} times on the {what} path")


# ---------------------------------------------------------------------------
# phase 5: the multinomial path
# ---------------------------------------------------------------------------


def build_mglm_problem(m, p, k, device, dtype, seed=11, lam=1e-3):
    import numpy as np

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, Y, x0, _ = synthetic.make_multinomial_data(m, p, k, seed=seed,
                                                  dtype=np.float32)
    return st.Problem(A, Y, x0, losses.multinom_f, lam,
                      grad_fx=losses.multinom_grad,
                      mglm=losses.multinom_mglm(k), dtype=dtype,
                      device=device)


def phase_multinomial():
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters

    t0 = time.perf_counter()
    prob = build_mglm_problem(*MGLM_SHAPE, "cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"  data {'x'.join(map(str, MGLM_SHAPE))} made and moved in "
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
        fail(f"the multinomial kernel path missed the {GAP:g} gap: "
             f"{kern['gap']:.3e}")
    check_launches(launches, MGLM_KERNELS, "multinomial")

    plain_method = dataclasses.replace(method, kernels="torch")
    solve_chunk(plain_method, prob_t)  # warm-up
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"multinomial final objectives differ: kernels "
             f"{kern['obj']:.9e}, torch {plain['obj']:.9e} (rel {rel:.2e} "
             f"> {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")

    # small float64 solve: card kernels against the CPU plain path
    small = (256, 32, 4)
    method64 = st.ProxGGNSCORE(solver="cg", greedy_alpha=False)
    s_gpu = solve_chunk(method64, build_mglm_problem(
        *small, "cuda", torch.float64, lam=1e-2))
    s_cpu = solve_chunk(method64, build_mglm_problem(
        *small, "cpu", torch.float64, lam=1e-2))
    if (s_gpu.epochs != s_cpu.epochs
            or s_gpu.x.shape != (small[1] * small[2],)):
        fail(f"small f64 multinomial solve: epochs {s_gpu.epochs} vs "
             f"{s_cpu.epochs}, x shape {tuple(s_gpu.x.shape)}")
    rel64 = float(((s_gpu.obj - s_cpu.obj).abs() / s_cpu.obj.abs()).max())
    if not bool(torch.isfinite(s_gpu.x).all()) or not rel64 <= SMALL_RTOL:
        fail(f"small f64 multinomial solve: objective histories differ "
             f"by {rel64:.2e}")
    log(f"  small f64 multinomial {'x'.join(map(str, small))}: "
        f"{s_gpu.epochs} epochs, card kernels vs CPU plain max rel "
        f"objective diff {rel64:.2e} (tolerance {SMALL_RTOL:g})")
    return kern, plain, launches


# ---------------------------------------------------------------------------
# phases 6 and 7: the L-BFGS and the uncached GGN-CG paths
# ---------------------------------------------------------------------------


def solve_lbfgs(method, prob, max_epoch=LBFGS_EPOCHS):
    """A fixed number of L-BFGS epochs from x0 (x_tol = f_tol = 0: no
    stopping test fires), stats every 4 epochs."""
    import scso_tpu_torch as st

    return st.iterate(method, prob, "l1", st.PHuberSmootherL1L2(1.0),
                      x_tol=0.0, f_tol=0.0, max_epoch=max_epoch, verbose=0,
                      stats_every=4)


def phase_lbfgs(prob_t):
    import dataclasses

    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    method = st.ProxLQNSCORE(m=10)
    solve_lbfgs(method, prob_t, max_epoch=8)  # warm-up
    runs = {}
    for mode in ("cuda", "torch"):
        m_ = dataclasses.replace(method, kernels=mode)
        counters.reset()
        t0 = time.perf_counter()
        s = solve_lbfgs(m_, prob_t)
        seconds = time.perf_counter() - t0
        launches = counters.snapshot()
        if s.epochs != LBFGS_EPOCHS or not bool(torch.isfinite(s.obj).all()):
            fail(f"L-BFGS ({mode}): {s.epochs} epochs, finite objective "
                 f"{bool(torch.isfinite(s.obj).all())}")
        runs[mode] = (s, dict(seconds=seconds, epochs=s.epochs,
                              ms_per_epoch=1e3 * seconds / s.epochs,
                              gap=float(s.objrel[-1]),
                              obj=float(s.obj[-1])), launches)
        log(f"  L-BFGS {LBFGS_EPOCHS} epochs, kernels={mode!r}: "
            f"{seconds:.4f} s ({1e3 * seconds / s.epochs:.3f} ms an "
            f"epoch), obj {float(s.obj[0]):.6e} at x0 → "
            f"{float(s.obj[-1]):.9e}, gap to the anchor "
            f"{float(s.objrel[-1]):.3e}, launches {launches}")
    (s_k, kern, launches), (s_p, plain, _) = runs["cuda"], runs["torch"]
    check_launches(launches, LBFGS_KERNELS, "L-BFGS")
    rel = float(((s_k.obj - s_p.obj).abs() / s_p.obj.abs()).max())
    if not rel <= LBFGS_RTOL:
        fail(f"L-BFGS objective histories differ by {rel:.2e} "
             f"(> {LBFGS_RTOL:g})")
    log(f"  L-BFGS objective histories, kernels vs torch: max rel diff "
        f"{rel:.2e} (tolerance {LBFGS_RTOL:g})")
    phase_small_f64(st.ProxLQNSCORE(), "L-BFGS",
                    lambda m_, p: solve_lbfgs(m_, p, max_epoch=40))
    return kern, plain, launches


def phase_uncached(prob_t, best):
    import dataclasses

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100, epoch_cache=False)
    warm = lambda m_: st.iterate(m_, prob_t, "l1", st.PHuberSmootherL1L2(1.0),
                                 x_tol=1e-12, f_tol=GAP, max_epoch=4,
                                 verbose=0, stats_every=4, alpha=1.0)
    warm(method)
    counters.reset()
    kern = timed_chain(method, prob_t, best)
    launches = counters.snapshot()
    log(f"  timed solve, kernels: {kern['seconds']:.4f} s, "
        f"{kern['epochs']} epochs, {kern['cg_iters']} CG iterations, "
        f"gap {kern['gap']:.3e}, launches {launches}")
    if not kern["gap"] <= GAP * 1.05:
        fail(f"the uncached kernel path missed the {GAP:g} gap: "
             f"{kern['gap']:.3e}")
    check_launches(launches, UNCACHED_KERNELS, "uncached GGN-CG")

    plain_method = dataclasses.replace(method, kernels="torch")
    warm(plain_method)
    plain = timed_chain(plain_method, prob_t, best)
    log(f"  timed solve, kernels='torch': {plain['seconds']:.4f} s, "
        f"{plain['epochs']} epochs, {plain['cg_iters']} CG iterations, "
        f"gap {plain['gap']:.3e}")
    rel = abs(kern["obj"] - plain["obj"]) / abs(plain["obj"])
    if not rel <= E2E_RTOL:
        fail(f"uncached final objectives differ: kernels {kern['obj']:.9e}, "
             f"torch {plain['obj']:.9e} (rel {rel:.2e} > {E2E_RTOL:g})")
    log(f"  final objective: kernels {kern['obj']:.9e}, torch "
        f"{plain['obj']:.9e}, rel diff {rel:.2e} (tolerance {E2E_RTOL:g})")
    phase_small_f64(st.ProxGGNSCORE(solver="cg", greedy_alpha=False,
                                    epoch_cache=False), "uncached GGN-CG")
    return kern, plain, launches


# ---------------------------------------------------------------------------
# phase 8: the row-sharded cached GGN-CG path
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded_one_rank(mesh, prob_t, best, kern, launches3):
    """8(a): phase 3's chain on the problem sharded over one rank."""
    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import shard_problem

    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100)
    sp = shard_problem(prob_t, mesh)
    solve_chunk(method, sp)  # warm-up
    counters.reset()
    sh = timed_chain(method, sp, best)
    launches = counters.snapshot()
    log(f"  timed solve, one rank (NCCL): {sh['seconds']:.4f} s, "
        f"{sh['epochs']} epochs, {sh['cg_iters']} CG iterations, gap "
        f"{sh['gap']:.3e}, launches {launches}; phase 3 unsharded: "
        f"{kern['seconds']:.4f} s")
    for key in ("epochs", "cg_iters", "obj"):
        if sh[key] != kern[key]:
            fail(f"one-rank sharded {key} {sh[key]!r} != phase 3's "
                 f"{kern[key]!r}")
    check_launches(launches, SHARDED_KERNELS, "one-rank sharded")
    want = dict(launches3, normal_matvec_sharded=launches3["normal_matvec"])
    if launches != want:
        fail(f"one-rank sharded launches {launches} != {want}")
    log(f"  final objective {sh['obj']:.9e}, epochs and CG iterations: "
        "bitwise phase 3's")
    return sh, launches


def build_two_rank_problem(device):
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses, synthetic

    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        2 * TWO_RANK_ROWS, MAIN_SHAPE[1], density=0.05, n_active=64,
        seed=SEED, dtype=np.float32, label01=True)
    prob = st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                      grad_fx=losses.logistic01_grad,
                      glm=losses.LOGISTIC01_GLM, dtype=torch.float32,
                      device=device, pad_features=True)
    return prob, (A, y, x0)


def rank_worker(port, rank, workdir):
    """One of phase 8(b)'s two ranks (``--rank-worker``): load this
    rank's rows from ``workdir``, solve to the gap with
    comm_overlap_chunks 1 and 2, then the small float64 solve; save."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch.models import losses
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import (
        distributed_init, load_problem_rows_sharded, make_mesh,
        shard_problem)

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(rank)
    if distributed_init("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank) != 2:
        fail(f"rank {rank}: the two-rank gloo group did not form")
    mesh = make_mesh()
    with open(os.path.join(workdir, "anchor.json")) as fh:
        best = json.load(fh)["best"]
    prob = load_problem_rows_sharded(
        os.path.join(workdir, "data"), np.load(os.path.join(workdir,
                                                            "x0.npy")),
        losses.logistic01_f, 0.01, mesh, device="cuda",
        grad_fx=losses.logistic01_grad, glm=losses.LOGISTIC01_GLM,
        sol=np.load(os.path.join(workdir, "xstar.npy")), pad_features=True)
    out = {}
    for chunks in (1, 2):
        method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100,
                                 comm_overlap_chunks=chunks)
        solve_chunk(method, prob)  # warm-up
        counters.reset()
        r = timed_chain(method, prob, best, keep_x=True)
        r["launches"] = counters.snapshot()
        out[f"x{chunks}"] = r.pop("x").cpu().numpy()
        out[f"chain{chunks}"] = json.dumps(r)
    s = solve_chunk(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                    shard_problem(build_problem(512, 200, "cuda",
                                                torch.float64), mesh))
    out["small_obj"] = s.obj.numpy()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def wait_all(procs, timeout):
    """Wait for every process; the first to fail, or the timeout, ends
    the others (a rank left alone would wait at its next collective)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            return
        time.sleep(0.2)


def phase_sharded_two_ranks():
    """8(b): two worker ranks on the one card over gloo against the
    parent's unsharded chain on the same data."""
    import numpy as np
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.parallel import save_problem_data

    workdir = tempfile.mkdtemp(prefix="scso_chip_smoke_")
    procs = []
    try:
        t0 = time.perf_counter()
        prob, (A, y, x0) = build_two_rank_problem("cuda")
        save_problem_data(os.path.join(workdir, "data"), A, y)
        np.save(os.path.join(workdir, "x0.npy"), x0)
        del A, y
        log(f"  data 2x{TWO_RANK_ROWS}x{MAIN_SHAPE[1]} made and written in "
            f"{time.perf_counter() - t0:.1f} s")
        method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100)
        best, x_opt, _ = presolve(method, prob)
        prob_t = replace(prob, x_star=x_opt)
        solve_chunk(method, prob_t)  # warm-up
        ref = timed_chain(method, prob_t, best)
        del prob, prob_t
        torch.cuda.empty_cache()
        np.save(os.path.join(workdir, "xstar.npy"),
                x_opt[:MAIN_SHAPE[1]].cpu().numpy())
        with open(os.path.join(workdir, "anchor.json"), "w") as fh:
            json.dump({"best": best}, fh)
        log(f"  unsharded chain, kernels: {ref['seconds']:.4f} s, "
            f"{ref['epochs']} epochs, {ref['cg_iters']} CG iterations, "
            f"obj {ref['obj']:.9e}")
        port = free_port()
        t0 = time.perf_counter()
        logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             str(port), str(r), workdir], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(2)]
        wait_all(procs, timeout=400)
        for r, (p, fh) in enumerate(zip(procs, logs)):
            fh.seek(0)
            if p.returncode != 0:
                fail(f"phase 8(b) rank {r} exited {p.returncode}:\n"
                     f"{fh.read()[-4000:]}")
            fh.close()
        log(f"  two ranks done in {time.perf_counter() - t0:.1f} s "
            "(start-up, loading and solves)")
        ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
                 for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    res = {"unsharded": ref}
    for chunks in (1, 2):
        got = json.loads(str(ranks[0][f"chain{chunks}"]))
        if not np.array_equal(ranks[0][f"x{chunks}"], ranks[1][f"x{chunks}"]):
            fail(f"two ranks (comm_overlap_chunks={chunks}) hold different "
                 "x")
        rel = abs(got["obj"] - ref["obj"]) / abs(ref["obj"])
        if not (rel <= E2E_RTOL and got["gap"] <= GAP * 1.05):
            fail(f"two ranks (comm_overlap_chunks={chunks}): obj "
                 f"{got['obj']:.9e} vs unsharded {ref['obj']:.9e} (rel "
                 f"{rel:.2e}), gap {got['gap']:.3e}")
        lc = got["launches"]
        # the overlapped form's local products are matrix products: it
        # launches neither K1 nor K1s
        check_launches(lc, SHARDED_KERNELS if chunks == 1 else tuple(
            k for k in SHARDED_KERNELS
            if k not in ("normal_matvec", "normal_matvec_sharded")),
            f"two-rank (comm_overlap_chunks={chunks})")
        if chunks == 1 and lc["normal_matvec_sharded"] != lc["normal_matvec"]:
            fail(f"two-rank: K1s launched {lc['normal_matvec_sharded']} "
                 f"times but K1 {lc['normal_matvec']}")
        log(f"  gloo, two ranks on one card, comm_overlap_chunks={chunks}: "
            f"{got['seconds']:.4f} s, {got['epochs']} epochs, "
            f"{got['cg_iters']} CG iterations, obj {got['obj']:.9e} (rel "
            f"diff to unsharded {rel:.2e}, tolerance {E2E_RTOL:g}), x "
            f"bitwise equal on both ranks, launches on rank 0 {lc}")
        res[f"two_ranks_overlap{chunks}"] = got
    s_cpu = solve_chunk(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                        build_problem(512, 200, "cpu", torch.float64))
    small = [r["small_obj"] for r in ranks]
    want = s_cpu.obj.numpy()
    if not (np.array_equal(small[0], small[1])
            and small[0].shape == want.shape):
        fail("small f64 two-rank solve: the ranks' histories differ or "
             "its epochs differ from the CPU's")
    rel64 = float(np.max(np.abs(small[0] - want) / np.abs(want)))
    if not rel64 <= SMALL_RTOL:
        fail(f"small f64 two-rank solve: histories differ by {rel64:.2e}")
    log(f"  small f64 two-rank 512x200: card vs CPU plain unsharded max rel "
        f"objective diff {rel64:.2e} (tolerance {SMALL_RTOL:g})")
    return res


def one_rank_nccl():
    """A one-rank NCCL group in this process (a TCP store on
    localhost) and its mesh."""
    import torch.distributed as dist

    from scso_tpu_torch.parallel import distributed_init, make_mesh

    # a failed init warns and returns 1 too: read the group itself
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        size = distributed_init(init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    if not (size == 1 and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        fail("the one-rank NCCL group did not form: "
             + "; ".join(str(w.message) for w in caught))
    return make_mesh()


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
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(*sys.argv[2:])
    import torch.distributed as dist

    import scso_tpu_torch as st
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

    mesh = one_rank_nccl()
    log("phase 2: kernels against their plain versions")
    errs, times, work = phase_kernels(mesh)

    log("phase 3/4: sparse-logistic path at full width, and cross-checks")
    kern, plain, launches, prob_t, best = phase_main_path()
    phase_small_f64(st.ProxGGNSCORE(solver="cg", greedy_alpha=False),
                    "GGN-CG")

    log("phase 5: multinomial path at full width, and cross-checks")
    mkern, mplain, mlaunches = phase_multinomial()

    log("phase 6: L-BFGS path at full width, and cross-checks")
    lkern, lplain, llaunches = phase_lbfgs(prob_t)

    log("phase 7: uncached GGN-CG path at full width, and cross-checks")
    ukern, uplain, ulaunches = phase_uncached(prob_t, best)

    log("phase 8: the row-sharded cached GGN-CG path")
    log(" (a) one rank over NCCL, full width")
    skern, slaunches = phase_sharded_one_rank(mesh, prob_t, best, kern,
                                              launches)
    del prob_t
    torch.cuda.empty_cache()
    log(" (b) two ranks on the one card over gloo")
    two = phase_sharded_two_ranks()
    dist.destroy_process_group()
    launches = {k: launches[k] + mlaunches[k] + llaunches[k] + ulaunches[k]
                + slaunches[k] for k in launches}

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "scso_tpu"
              or m.startswith("scso_tpu.")]
    if leaked:
        fail(f"the port imported {leaked}")

    log("main path: " + json.dumps({"card": card, "kernels": kern,
                                    "torch": plain}))
    log("multinomial path: " + json.dumps({"card": card, "kernels": mkern,
                                           "torch": mplain}))
    log("L-BFGS path: " + json.dumps({"card": card, "kernels": lkern,
                                      "torch": lplain}))
    log("uncached GGN-CG path: " + json.dumps({"card": card,
                                               "kernels": ukern,
                                               "torch": uplain}))
    log("sharded path: " + json.dumps({"card": card, "one_rank": skern,
                                       **two}))
    rows = []
    for k, (src, rep) in KERNELS.items():
        bound_ms, bound_by = bound(*work[k])
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k],
                     "max_abs_err": errs[k], "ms": times[k][0],
                     "plain_ms": times[k][1], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
