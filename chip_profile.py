#!/usr/bin/env python3
"""Profile chip_smoke.py's cached chains on one GPU with torch.profiler.

    python3 chip_profile.py [--trace PREFIX]

Run from the root of a checkout, on a machine with one NVIDIA H100. For
each problem — phase 3's sparse logistic (196608×10000 padded to 10112,
seed 7, float32), phase 9's (524288×1024), and phase 5's multinomial
(196608×1024×16, seed 11, float32) — it builds the problem, presolves
for x*, warms up, then profiles one timed chain to the 1e-6 gap (CPU
and CUDA activities): with A in float32 (chip_smoke's F32_CG), and for
the two logistic problems also with the bfloat16 copy of A
(auto_lp=True, phase 11's lp chain). It prints the card's name and
power limit, then one JSON line a chain: the chain's host seconds; the
device's busy time (the union of the intervals of its kernels, copies
and sets) and its idle share of the profiled window (first to last
device activity); and the device ms and kernel runs of the port's
kernels in that chain, by kernel — K1 on the bf16 copy (its partial
sums), K1 (its partial sums on A and the fixed-order sums of both), K2
(either form and its finalize), K3, K5 (any of its forms and its
fixed-order sum) — and of everything else.
``--trace PREFIX`` also writes each chain's Chrome trace to
PREFIX.<chain>.json. Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel-name fragments of each of the port's kernels, by problem kind
# (sum_partials is K1's on the logistic path and K5's on the multinomial)
GROUPS = {
    "logistic": {
        "K1 on the bf16 copy": ("normal_matvec_partial<__nv_bfloat16",),
        "K1 normal_matvec": ("normal_matvec_partial", "sum_partials"),
        "K2 glm_prep_pair": ("glm_onepass", "glm_rows", "glm_cols",
                             "glm_finalize"),
        "K3 score_update": ("score_update",),
    },
    "multinomial": {
        "K5 mglm_matvec": ("mglm_tc", "mglm_rows", "mglm_cols",
                           "sum_partials"),
        "K3 score_update": ("score_update",),
    },
}


def device_events(prof):
    """(name, start µs, end µs) of every device activity in the trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def busy_us(spans):
    """The length of the union of the [start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_problem(name, prob, card, kind, lp=False):
    """Presolve, then profile the f32 chain (and with ``lp`` the chain
    with the bf16 copy) on the anchored problem."""
    import chip_smoke as cs
    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    f32 = st.ProxGGNSCORE(**cs.F32_CG)
    best, x_opt, _ = cs.presolve(f32, prob)
    prob_t = replace(prob, x_star=x_opt)
    profile_chain(name, prob_t, best, f32, card, kind)
    if lp:
        profile_chain(f"{name}_lp", prob_t, best, st.ProxGGNSCORE(
            **dict(cs.F32_CG, auto_lp=True)), card, kind)


def profile_chain(name, prob_t, best, method, card, kind):
    """Warm up, then profile one timed chain; print its line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    cs.solve_chunk(method, prob_t)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain = cs.timed_chain(method, prob_t, best)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if "--trace" in sys.argv:
        prof.export_chrome_trace(
            f"{sys.argv[sys.argv.index('--trace') + 1]}.{name}.json")
    events = device_events(prof)
    if not events:
        print("chip_profile.py FAILED: the trace holds no device activity",
              file=sys.stderr)
        sys.exit(1)
    window = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = busy_us([(s, e) for _, s, e in events])
    groups = GROUPS[kind]
    kernels = {k: {"ms": 0.0, "runs": 0} for k in groups}
    kernels["other"] = {"ms": 0.0, "runs": 0}
    for ev, s, e in events:
        key = next((k for k, frags in groups.items()
                    if any(f in ev for f in frags)), "other")
        kernels[key]["ms"] += (e - s) / 1e3
        kernels[key]["runs"] += 1
    print(json.dumps({
        "chain": name, "card": card, "chain_s": chain["seconds"],
        "wall_s": wall, "epochs": chain["epochs"],
        "cg_iters": chain["cg_iters"], "gap": chain["gap"],
        "window_ms": window / 1e3, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window, "kernels": kernels}), flush=True)


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py FAILED: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    for name, shape in (("main", cs.MAIN_SHAPE),
                        ("narrow", cs.NARROW_SHAPE)):
        profile_problem(name, cs.build_problem(*shape, "cuda",
                                               torch.float32),
                        card, "logistic", lp=True)
        torch.cuda.empty_cache()
    profile_problem("multinomial", cs.build_mglm_problem(
        *cs.MGLM_SHAPE, "cuda", torch.float32), card, "multinomial")


if __name__ == "__main__":
    main()
