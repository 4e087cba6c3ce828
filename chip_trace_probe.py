"""Which kernel launches a profiler trace of a loaded sharded program
holds (chip_smoke.py phase 26(b)).

Builds chip_smoke.py phase 3's problem (196608×10000 f32, padded to
10112) on one card, serves its row shard over a one-rank NCCL group
(the counters' K1/K2/K3 launches), exports the shard's solve, loads it,
and then traces the loaded solve in several profiler sessions of one
process. For each session it reports the kernel events by chip_smoke's
TRACE_MARKS, the op calls by OP_MARKS, and for every call of K2's op
whether a ``glm_finalize`` kernel event carries the correlation id of a
launch made inside that call; for a call without one, the CUDA API
events inside it and the kernel events of its correlation ids.
Each session's trace is kept, gzipped, under OUTDIR.

    python3 chip_trace_probe.py OUTDIR

It needs one card; it writes its summary as the last line of its
standard output.
"""

from __future__ import annotations

import faulthandler
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

K2_OPS = ("scso::glm_prep_pair", "scso::glm_prep")


def events_of(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def k2_calls(events):
    """[(ts, end, tid)] of the outermost calls of K2's ops."""
    calls, ends = [], {}
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"
                     and e.get("name") in K2_OPS), key=lambda e: e["ts"]):
        key = (e.get("tid"), e["name"])
        if e["ts"] < ends.get(key, float("-inf")):
            continue
        ends[key] = e["ts"] + e.get("dur", 0)
        calls.append((e["ts"], ends[key], e.get("tid")))
    return calls


def session(events, want):
    """The session's readings (see the module)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_corr = {}
    for k in kernels:
        by_corr.setdefault(k.get("args", {}).get("correlation"), []).append(
            k["name"])
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    missing = []
    calls = k2_calls(events)
    for i, (t0, t1, tid) in enumerate(calls):
        inside = [e for e in launches if e.get("tid") == tid
                  and t0 <= e["ts"] <= t1]
        corrs = [e.get("args", {}).get("correlation") for e in inside]
        names = [n for c in corrs for n in by_corr.get(c, [])]
        if not any("glm_finalize" in n for n in names):
            missing.append(dict(call=i, runtime=[e["name"] for e in inside],
                                kernels=names,
                                ts_from_first=t0 - calls[0][0]))
    ts = sorted(k["ts"] for k in kernels)
    counts = {k: sum(any(m in e["name"] for m in marks) for e in kernels)
              for k, marks in cs.TRACE_MARKS.items()}
    return dict(counts=counts, want=want,
                op_calls=len(calls), kernels=len(kernels),
                k2_calls_without_finalize=missing,
                kernel_span_us=(ts[-1] - ts[0]) if ts else None)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    if len(sys.argv) != 2:
        cs.fail("usage: python3 chip_trace_probe.py OUTDIR")
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    faulthandler.dump_traceback_later(240, exit=True)

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import build, counters
    from scso_tpu_torch.parallel import (
        distributed_init, distributed_shutdown, make_mesh, shard_problem)
    from scso_tpu_torch.utils import (
        export_solver, load_solver, make_serving_fn)

    t_start = time.perf_counter()
    build.load()
    ops_build = cs.start_ops_build()
    dev = torch.device("cuda")
    prob = cs.build_problem(*cs.MAIN_SHAPE, dev, torch.float32)
    meth, sm = st.ProxGGNSCORE(**cs.F32_CG), st.PHuberSmootherL1L2(1.0)
    best, x_opt, _ = cs.presolve(meth, prob)
    prob_t = replace(prob, x_star=x_opt)
    del prob
    tpl, opts = cs.chain_template(prob_t)
    args = (prob_t.A, prob_t.y, prob_t.x0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    res = {"card": smi.stdout.strip().splitlines()[0].strip(),
           "ops_build": ops_build}
    with tempfile.TemporaryDirectory() as d:
        distributed_init(init_method=f"file://{d}/rdv", world_size=1,
                         rank=0)
        try:
            sp = shard_problem(tpl, make_mesh())
            serve = make_serving_fn(meth, sp, "l1", sm, opts)
            total = dict.fromkeys(counters.KERNEL_LAUNCHES, 0)
            _, _, lc = cs.launches_of(lambda: serve(*args), total)
            want = {"normal_matvec": lc["normal_matvec"],
                    "glm_prep": lc["glm_prep_pair"],
                    "score_update": lc["score_update"]}
            del serve
            cs.free_graphs()
            build.load_ops()
            blob = export_solver(meth, sp, "l1", sm, opts)
            loaded = load_solver(blob, "cuda")
            loaded(*args)
            torch.cuda.synchronize()
            sessions = {}
            for name, lead, trail in (("plain", False, False),
                                      ("lead", True, False),
                                      ("lead", True, False),
                                      ("trail", False, True),
                                      ("lead_trail", True, True),
                                      ("plain", False, False)):
                name = f"{len(sessions)}_{name}"
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    if lead:
                        torch.ones(1, device=dev).add_(1)
                        torch.cuda.synchronize()
                    loaded(*args)
                    torch.cuda.synchronize()
                    if trail:
                        torch.ones(1, device=dev).add_(1)
                        torch.cuda.synchronize()
                path = os.path.join(out_dir, f"trace_{name}.json")
                prof.export_chrome_trace(path)
                sessions[name] = session(events_of(path), want)
                with open(path, "rb") as f, \
                        gzip.open(path + ".gz", "wb") as g:
                    shutil.copyfileobj(f, g)
                os.remove(path)
                print(name, json.dumps(sessions[name]), flush=True)
            del loaded
        finally:
            distributed_shutdown()
    res["sessions"] = sessions
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
