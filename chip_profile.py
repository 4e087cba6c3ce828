#!/usr/bin/env python3
"""Profile chip_smoke.py's cached chains on one GPU with torch.profiler.

    python3 chip_profile.py [--trace PREFIX]

Run from the root of a checkout, on a machine with one NVIDIA H100. For
each problem — phase 3's sparse logistic (196608×10000 padded to 10112,
seed 7, float32), phase 9's (524288×1024), and phase 5's multinomial
(196608×1024×16, seed 11, float32) — it builds the problem, presolves
for x*, warms up, then profiles one timed chain to the 1e-6 gap (CPU
and CUDA activities): with A in float32 (chip_smoke's F32_CG) in the
default fused mode (replays of the captured solve) and in its eager
form (``capture=False``: the same bodies with a host read a predicate,
the chain the port ran before its solves were captured, ``_eager``),
and for the two logistic problems also with the bfloat16 copy of A
(auto_lp=True, phase 11's lp chain, fused and eager). It prints the
card's name and power limit, then one JSON line a chain: the chain's
host seconds; the device's busy time (the union of the intervals of its
kernels, copies and sets) and its idle share of the profiled window
(first to last device activity), and beside it the idle share against
the best of 3 unprofiled runs of the chain, all timed before the
profiler first runs (the profiler slows a captured graph's replays, for
the rest of the process: their window grows, their busy time does not),
with the three runs' seconds and the captures each made (a capture
inside a timed run would be counted as idle time). The trace of a
replayed graph can miss kernels that run inside its WHILE nodes: where a
fused chain's trace holds fewer runs of the port's kernels than its
eager twin's (the same kernels on the same inputs, bitwise the same
run), the idle share uses the twin's busy time (``busy_from``), which
leaves out only the fused chain's one-thread conditional sets and
launch counts; and the device
ms and kernel runs of the port's
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


def prepare(name, prob, kind, lp=False):
    """Presolve, then the chains to profile on the anchored problem: the
    f32 chain fused and eager (and with ``lp`` the chain with the bf16
    copy, fused and eager), each warmed up (its capture) and timed unprofiled (3
    runs). Returns (name, prob_t, best, method, kind, capture, runs) a
    chain, ``runs`` the (seconds, captures) of each timed run."""
    import chip_smoke as cs
    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace

    f32 = st.ProxGGNSCORE(**cs.F32_CG)
    best, x_opt, _ = cs.presolve(f32, prob)
    prob_t = replace(prob, x_star=x_opt)
    arms = [(name, f32, True), (f"{name}_eager", f32, False)]
    if lp:
        lp_method = st.ProxGGNSCORE(**dict(cs.F32_CG, auto_lp=True))
        arms += [(f"{name}_lp", lp_method, True),
                 (f"{name}_lp_eager", lp_method, False)]
    chains = []
    for chain, method, capture in arms:
        cs.solve_chunk(method, prob_t, capture)  # warm-up (the capture)
        runs = []
        for _ in range(3):
            r = cs.timed_chain(method, prob_t, best, capture=capture)
            runs.append((r["seconds"], r["loop"]["captures"]))
        chains.append((chain, prob_t, best, method, kind, capture, runs))
    return chains


def profile_chain(name, prob_t, best, method, kind, capture, runs, card):
    """Profile one timed chain (timed unprofiled by `prepare`) after a
    warm-up (a capture again where the cast it read is gone: `cast_once`
    keeps one); returns its line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    cs.solve_chunk(method, prob_t, capture)
    torch.cuda.synchronize()
    unprofiled = min(sec for sec, _ in runs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain = cs.timed_chain(method, prob_t, best, capture=capture)
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
    return {
        "chain": name, "card": card, "chain_s": chain["seconds"],
        "unprofiled_s": unprofiled,
        "unprofiled_runs_s": [sec for sec, _ in runs],
        "unprofiled_captures": [n for _, n in runs],
        "wall_s": wall, "epochs": chain["epochs"],
        "cg_iters": chain["cg_iters"], "gap": chain["gap"],
        "host_reads": chain["loop"]["host_reads"],
        "captures": chain["loop"]["captures"],
        "window_ms": window / 1e3, "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window, "kernels": kernels}


def with_idle(line, twin):
    """``line`` with its idle share against its unprofiled seconds: its
    own busy time, or its eager ``twin``'s where its trace holds fewer
    runs of the port's kernels than the twin's."""
    busy, src = line["busy_ms"], "trace"
    if twin is not None:
        short = any(line["kernels"][k]["runs"] < twin["kernels"][k]["runs"]
                    for k in line["kernels"] if k != "other")
        line["trace_runs_short"] = short
        if short:
            busy, src = twin["busy_ms"], "eager twin"
    line["busy_from"] = src
    line["idle_share_unprofiled"] = 1.0 - busy / 1e3 / line["unprofiled_s"]
    return line


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
    # every unprofiled time first: once the profiler has run, the
    # replays of a captured graph stay slower for the process
    chains = []
    for name, shape in (("main", cs.MAIN_SHAPE),
                        ("narrow", cs.NARROW_SHAPE)):
        chains += prepare(name, cs.build_problem(*shape, "cuda",
                                                 torch.float32),
                          "logistic", lp=True)
    chains += prepare("multinomial", cs.build_mglm_problem(
        *cs.MGLM_SHAPE, "cuda", torch.float32), "multinomial")
    lines = {c[0]: profile_chain(*c, card) for c in chains}
    for name, line in lines.items():
        twin = None if name.endswith("_eager") else lines[f"{name}_eager"]
        print(json.dumps(with_idle(line, twin)), flush=True)


if __name__ == "__main__":
    main()
