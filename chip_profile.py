#!/usr/bin/env python3
"""Profile chip_smoke.py's phase-3 and phase-5 chains on one GPU with
torch.profiler.

    python3 chip_profile.py [--trace PREFIX]

Run from the root of a checkout, on a machine with one NVIDIA H100. For
each of two chains — phase 3's sparse-logistic problem (196608×10000
padded to 10112, seed 7, float32) and phase 5's multinomial problem
(196608×1024×16, seed 11, float32) — it builds the problem, presolves
for x*, warms up, then profiles one timed chain to the 1e-6 gap (CPU
and CUDA activities). It prints the card's name and power limit, then
one JSON line a chain: the chain's host seconds; the device's busy time
(the union of the intervals of its kernels, copies and sets) and its
idle share of the profiled window (first to last device activity); and
the device ms and kernel runs of the port's kernels in that chain, by
kernel — K1 (its partial sums and their fixed-order sum), K2 (either
form and its finalize), K3, K5 (any of its forms and its fixed-order
sum) — and of everything else.
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

# kernel-name fragments of each of the port's kernels, by chain
# (sum_partials is K1's on the logistic path and K5's on the multinomial)
GROUPS = {
    "main": {
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


def profile_chain(name, prob, card):
    """Presolve, warm up, then profile one timed chain; print its line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100)
    best, x_opt, _ = cs.presolve(method, prob)
    prob_t = replace(prob, x_star=x_opt)
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
    groups = GROUPS[name]
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
    profile_chain("main", cs.build_problem(*cs.MAIN_SHAPE, "cuda",
                                           torch.float32), card)
    torch.cuda.empty_cache()
    profile_chain("multinomial", cs.build_mglm_problem(
        *cs.MGLM_SHAPE, "cuda", torch.float32), card)


if __name__ == "__main__":
    main()
