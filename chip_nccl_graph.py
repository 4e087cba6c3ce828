#!/usr/bin/env python3
"""Whether NCCL collectives across ranks can sit inside a captured CUDA
graph, and what a process group's teardown waits for.

    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_nccl_graph.py
    python3 chip_nccl_graph.py --teardown OUTDIR [--ranks 4]

The first form (one process per card) captures NCCL collectives
plainly, inside an IF node and inside a WHILE node (`ops/cuda/graph.py`),
under the NCCL_GRAPH_MIXING_SUPPORT setting of the run; where both
conditionals capture, a small row-sharded cached GGN-CG solve
(chip_smoke's data, 16384×1000, float32, 30 epochs) captured in fused
mode against timed mode. Fused mode on a row shard of more than one
rank raises in the port where the process group was made without the
variable (`iterate._check_capturable`); this form lifts that check for
its own solve only, so that it probes either setting. Each rank prints
one line: each capture's outcome (True: the replay gave the right sum;
else the error), and the fused solve's epochs and whether its x and
objective history equal timed mode's bit for bit. It ends without a
teardown (after a failed capture the communicator's state is unknown).

``--teardown`` runs the cases of `CASES` one after the other, each in a
world of its own (``torchrun --nproc-per-node=RANKS``, under
NCCL_GRAPH_MIXING_SUPPORT=0 and torch's flight recorder), and each
ending in ``dist.destroy_process_group()``: what a case leaves behind is
what the teardown meets. Each rank writes under OUTDIR:
``<case>.rank<r>.json`` (the case's result,
the flight recorder's entries that are not completed just before the
teardown, and the seconds the teardown took, or null), and
``<case>.rank<r>.stacks.txt`` (faulthandler: every thread's stack, should
the teardown last DESTROY_WAIT_S seconds; the rank then exits 1). The
launcher prints one JSON line: each case's exit code, seconds, and
whether every rank's teardown returned. On four H100s over NVLink the
teardown returned in under a second wherever no captured graph with a
collective was left, and never where one was (`kept`,
`kept_eager_async`, `solve_uncaptured_after_capture`), with no
collective open in any rank's flight recorder: NCCL's teardown of a
communicator waits for every CUDA graph that holds one of its
collectives, which is why `parallel.distributed_shutdown` drops the
cached captures first (ROADMAP C15).
"""
import faulthandler
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: seconds a rank's teardown may take before it dumps its stacks and exits
DESTROY_WAIT_S = 30
#: seconds a case's world may take in all (build excluded)
CASE_TIMEOUT_S = 240
#: the small row-sharded solve of the solve cases
SOLVE_SHAPE = (16384, 1000)
SOLVE_KW = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=30, verbose=0,
                alpha=1.0, stats_every=1)


def probe():
    """The first form (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.ops.cuda import graph
    from scso_tpu_torch.parallel import distributed_init

    world = distributed_init()
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    buf = torch.ones(1024, device=dev)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    dist.all_reduce(buf)  # the communicator, before any capture
    torch.cuda.synchronize()
    res = {}
    for what in ("plain", "if", "while"):
        k = torch.zeros((), dtype=torch.int32, device=dev)
        live = torch.ones((), dtype=torch.bool, device=dev)

        def body():
            dist.all_reduce(buf)
            k.add_(1)
            live.copy_(k < 2)

        def fn():
            if what == "plain":
                dist.all_reduce(buf)
            elif what == "if":
                graph.device_if(pred, lambda: dist.all_reduce(buf))
            else:
                k.zero_()
                live.fill_(True)
                graph.device_loop(live, 2, body)

        try:
            cap = graph.capture(fn, dev)
            buf.fill_(1.0)
            cap.replay()
            torch.cuda.synchronize()
            want = world ** (2 if what == "while" else 1)
            res[what] = float(buf[0]) == want
        except Exception as e:  # noqa: BLE001 - a probe reports any failure
            res[what] = repr(e)[:160]
            break
    if res.get("if") is True and res.get("while") is True:
        from scso_tpu_torch.algorithms import iterate as it

        it._check_capturable = lambda prob: None
        try:
            a, b = fused_and_timed(dev, chunks=1)
            res["fused_sharded"] = compare(a, b)
        except Exception as e:  # noqa: BLE001
            res["fused_sharded"] = repr(e)[:300]
    print(f"rank {rank} NCCL_GRAPH_MIXING_SUPPORT="
          f"{os.environ.get('NCCL_GRAPH_MIXING_SUPPORT')}: {res}", flush=True)
    os._exit(0)


def sharded_problem(dev):
    import torch

    import chip_smoke as cs
    from scso_tpu_torch.parallel import make_mesh, shard_problem

    return shard_problem(cs.build_problem(*SOLVE_SHAPE, dev, torch.float32),
                         make_mesh())


def fused_and_timed(dev, chunks, prob=None):
    """The small row-sharded cached GGN-CG solve in fused and in timed
    mode with ``chunks`` chunks: the two Solutions."""
    import chip_smoke as cs
    import scso_tpu_torch as st

    sp = sharded_problem(dev) if prob is None else prob
    m = st.ProxGGNSCORE(**cs.F32_CG, comm_overlap_chunks=chunks)
    sm = st.PHuberSmootherL1L2(1.0)
    a = st.iterate(m, sp, "l1", sm, **SOLVE_KW)
    b = st.iterate(m, sp, "l1", sm, **dict(SOLVE_KW, mode="timed"))
    return a, b


def compare(a, b) -> dict:
    import torch

    return dict(epochs=(a.epochs, b.epochs),
                x_equal=bool(torch.equal(a.x, b.x)),
                obj_equal=bool(torch.equal(a.obj, b.obj)))


# ---------------------------------------------------------------------------
# --teardown: each case in a world of its own, ending in the teardown
# ---------------------------------------------------------------------------


def _capture_sum(dev, ctx, reduces=1, loop=False):
    """A graph whose IF node (or, with ``loop``, WHILE node of two runs)
    holds ``reduces`` all-reduces of one buffer on the capturing stream;
    replayed once. Returns whether the sum was right; the graph is kept
    in ``ctx``."""
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.ops.cuda import graph

    world = dist.get_world_size()
    buf = torch.ones(1024, device=dev)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)

    def reduce_all():
        for _ in range(reduces):
            dist.all_reduce(buf)

    def body():
        reduce_all()
        k.add_(1)
        live.copy_(k < 2)

    def fn():
        if loop:
            k.zero_()
            live.fill_(True)
            graph.device_loop(live, 2, body)
        else:
            graph.device_if(pred, reduce_all)

    ctx["graph"] = graph.capture(fn, dev)
    buf.fill_(1.0)
    ctx["graph"].replay()
    torch.cuda.synchronize()
    want = world ** (reduces * (2 if loop else 1))
    return float(buf[0]) == want


def _eager_chunks(dev, n=10112, chunks=2):
    """``chunks`` async all-reduces of n/chunks values each, waited on as
    `ops.cuda.matvec._sharded` does uncaptured; whether each sum is
    right."""
    import torch
    import torch.distributed as dist

    parts = [torch.ones(n // chunks, device=dev) for _ in range(chunks)]
    works = [dist.all_reduce(p, async_op=True) for p in parts]
    for w in works:
        w.wait()
    torch.cuda.synchronize()
    return all(float(p[0]) == dist.get_world_size() for p in parts)


def _drop(ctx):
    """Every capture dropped and the card idle: the cases' teardown
    repair (`parallel.distributed_shutdown` does the same)."""
    import torch

    from scso_tpu_torch.ops.cuda import graph

    ctx.clear()
    graph.clear()
    gc.collect()
    torch.cuda.synchronize()


def case_kept(dev, ctx):
    """A replayed graph with an all-reduce kept alive at the teardown."""
    return {"sum_right": _capture_sum(dev, ctx)}


def case_kept_eager_async(dev, ctx):
    """Issue's case 1: a replayed graph with an all-reduce, then eager
    async all-reduces on the same communicator; the graph kept."""
    return {"sum_right": _capture_sum(dev, ctx),
            "eager_right": _eager_chunks(dev)}


def case_dropped_eager_async(dev, ctx):
    """Case 1 with the capture dropped and the card synchronized before
    the teardown."""
    out = case_kept_eager_async(dev, ctx)
    _drop(ctx)
    return out


def case_eager_only(dev, ctx):
    """Eager async all-reduces alone: no graph ever captured."""
    return {"eager_right": _eager_chunks(dev)}


def case_while2(dev, ctx):
    """Two all-reduces in one WHILE body on the capturing stream; the
    graph dropped before the teardown."""
    out = {"sum_right": _capture_sum(dev, ctx, reduces=2, loop=True)}
    _drop(ctx)
    return out


def case_while3(dev, ctx):
    """Three all-reduces in one WHILE body, as :func:`case_while2`."""
    out = {"sum_right": _capture_sum(dev, ctx, reduces=3, loop=True)}
    _drop(ctx)
    return out


def _uncaptured_chunks(dev, prob=None):
    from scso_tpu_torch.algorithms import iterate as it
    from scso_tpu_torch.ops.cuda import graph

    real = it._uncaptured
    it._uncaptured = lambda p: True  # the program run uncaptured
    try:
        graph.reset_stats()
        a, b = fused_and_timed(dev, 2, prob)
    finally:
        it._uncaptured = real
    return dict(compare(a, b), captures=graph.STATS["captures"])


def case_solve_uncaptured(dev, ctx):
    """The fused chunks-2 solve run uncaptured (and timed chunks 2), no
    capture in the process."""
    return _uncaptured_chunks(dev)


def case_solve_uncaptured_after_capture(dev, ctx):
    """A captured fused chunks-1 solve of the same problem first (its
    graph cached while the problem lives), then the uncaptured chunks-2
    solve; the problem kept to the teardown."""
    ctx["prob"] = sharded_problem(dev)
    a, b = fused_and_timed(dev, 1, ctx["prob"])
    return {"chunks1": compare(a, b),
            "chunks2_uncaptured": _uncaptured_chunks(dev, ctx["prob"])}


def case_solve_captured_chunks(dev, ctx):
    """The fused chunks-2 solve captured (each chunk's all-reduce in
    order on the capturing stream) against timed chunks 2, the problem
    kept, then the teardown repair."""
    from scso_tpu_torch.ops.cuda import counters

    ctx["prob"] = sharded_problem(dev)
    counters.reset()
    a, b = fused_and_timed(dev, 2, ctx["prob"])
    out = dict(compare(a, b), launches={
        k: v for k, v in counters.snapshot().items() if v})
    _drop(ctx)
    return out


CASES = {f.__name__[5:]: f for f in (
    case_eager_only, case_kept, case_kept_eager_async,
    case_dropped_eager_async, case_while2, case_while3,
    case_solve_uncaptured, case_solve_uncaptured_after_capture,
    case_solve_captured_chunks)}


def _flight_record():
    """The flight recorder's entries that are not completed (pg, seq,
    name, state) and how many entries it holds; or the error."""
    import pickle

    import torch

    c10d = torch._C._distributed_c10d
    try:
        if hasattr(c10d, "_dump_nccl_trace"):
            raw = pickle.loads(c10d._dump_nccl_trace())
        else:
            raw = pickle.loads(c10d._dump_fr_trace())
        entries = raw.get("entries", [])
        pending = [e for e in entries if e.get("state") != "completed"]
        return {"entries": len(entries), "open": len(pending), "last_open": [
            {k: str(e.get(k)) for k in ("process_group", "collective_seq_id",
                                         "profiling_name", "state",
                                         "input_sizes")}
            for e in pending[-8:]]}
    except Exception as e:  # noqa: BLE001 - a probe reports any failure
        return {"error": repr(e)[:200]}


def run_case(name, out):
    """One rank of case ``name`` (under torchrun), its files in
    ``out``."""
    import torch
    import torch.distributed as dist

    from scso_tpu_torch.parallel import distributed_init

    distributed_init()
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    warm = torch.ones(8, device=dev)
    dist.all_reduce(warm)  # the communicator
    torch.cuda.synchronize()
    path = os.path.join(out, f"{name}.rank{rank}")
    stacks = open(path + ".stacks.txt", "w")
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S - 30, exit=True,
                                      file=stacks)
    ctx = {}
    try:
        res = CASES[name](dev, ctx)
    except Exception as e:  # noqa: BLE001
        res = {"error": repr(e)[:400]}
    torch.cuda.synchronize()
    rec = {"case": name, "rank": rank, "result": res,
           "flight_recorder": _flight_record(), "teardown_s": None}
    with open(path + ".json", "w") as fh:
        json.dump(rec, fh)
    faulthandler.cancel_dump_traceback_later()
    faulthandler.dump_traceback_later(DESTROY_WAIT_S, exit=True, file=stacks)
    t0 = time.perf_counter()
    dist.destroy_process_group()
    rec["teardown_s"] = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    with open(path + ".json", "w") as fh:
        json.dump(rec, fh)
    print(json.dumps(rec), flush=True)


def teardown(out, ranks):
    """``--teardown``: build once, then every case in its own world, its
    files in ``out``."""
    os.makedirs(out, exist_ok=True)
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from scso_tpu_torch.ops.cuda import build; build.load()",
                    ROOT], check=True)
    env = dict(os.environ, NCCL_GRAPH_MIXING_SUPPORT="0",
               TORCH_NCCL_TRACE_BUFFER_SIZE="20000",
               TORCH_NCCL_DUMP_ON_TIMEOUT="1",
               TORCH_FR_DUMP_TEMP_FILE=os.path.join(out, "fr_"))
    summary = {}
    for name in CASES:
        t0 = time.perf_counter()
        with open(os.path.join(out, f"{name}.torchrun.txt"), "w") as log:
            try:
                rc = subprocess.run(
                    ["torchrun", f"--nproc-per-node={ranks}", __file__,
                     "--case", name, out], env=env, stdout=log,
                    stderr=subprocess.STDOUT,
                    timeout=CASE_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        recs = []
        for r in range(ranks):
            try:
                with open(os.path.join(out, f"{name}.rank{r}.json")) as fh:
                    recs.append(json.load(fh))
            except (OSError, ValueError):
                recs.append(None)
        summary[name] = dict(
            rc=rc, seconds=round(time.perf_counter() - t0, 1),
            teardown_returned=all(r is not None and r["teardown_s"]
                                  is not None for r in recs),
            result=recs[0]["result"] if recs[0] else None,
            open_collectives=[r["flight_recorder"].get("open")
                              if r else None for r in recs])
        print(name, json.dumps(summary[name]), flush=True)
    print(json.dumps(summary), flush=True)


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_nccl_graph.py FAILED: no CUDA device", file=sys.stderr)
        sys.exit(1)
    args = sys.argv[1:]
    if args[:1] == ["--teardown"]:
        ranks = int(args[3]) if args[2:3] == ["--ranks"] else 4
        teardown(os.path.abspath(args[1]), ranks)
    elif args[:1] == ["--case"]:
        run_case(args[1], args[2])
    else:
        probe()


if __name__ == "__main__":
    main()
