#!/usr/bin/env python3
"""Every single-instance method on a row shard over NCCL, captured, on
every card of one host; the λ sweep over the ranks.

    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_sharded.py
    torchrun --nproc-per-node=4 chip_sharded.py --refuse
    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_sharded.py --sweep
    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_sharded.py --mesh2d
    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_sharded.py --overlap

One process per card (torchrun's RANK, LOCAL_RANK, WORLD_SIZE and
rendezvous). A fused (captured) solve over several NCCL ranks puts the
collectives inside the CUDA graph's conditional nodes, which NCCL allows
only under NCCL_GRAPH_MIXING_SUPPORT=0 when the communicator is made:
without it the script fails at once, and ``--refuse`` instead requires
that a fused solve raise, naming the variable, before any collective.

Every rank builds chip_smoke.py's phase 3 problem (196608×10000 padded
to 10112, seed 7, float32) on its own card, runs phase 3's presolve
there (the anchor x*), and then, for each path of `paths` — phase 3's
cached GGN-CG chain, phase 7's uncached chain, phase 12's Newton-CG
chain (greedy off), phase 5's multinomial chain (196608×1024×16, its own
presolve), phase 6's L-BFGS (300 epochs), L-BFGS with the Armijo line
search (60 epochs: an all-reduce a trial inside its WHILE node), phase
16's mini-batches and phase 18's test set off the epoch cache — the
path on the whole problem (the same on every rank: "one card"), then
on its row shard over all ranks (`shard_problem`: 196608/world rows a
rank) in fused mode. Required for each: the final objective within
chip_smoke.E2E_RTOL of the one-card run's; every rank holding rank 0's
x bit for bit; its kernels launched on the shard, K1s as often as K1;
and one solve of it with a record every epoch in fused and in timed
mode (uncaptured) on the shard: the same epochs, x and objective
history, bit for bit. The cached chain also runs sharded in timed mode
with comm_overlap_chunks 1 and 2 (the overlapped form launches neither
K1 nor K1s), and fused with comm_overlap_chunks 2 (the chunks'
all-reduces captured in order inside the CG loop's WHILE node): the
same chain as timed chunks 2 (epochs and final objective), x the same on
every rank, K2 and K3 launched but neither K1 nor K1s, and one solve
with a record every epoch fused = timed bit for bit. Then phase 3's
solve served and exported on the shard (`serving`): `make_serving_fn`
called three times on every rank with its rows (the shard's data, which
captures; a fresh shard, this rank's rows in reverse order with flipped
labels, with no new capture; the shard's data again), each giving the
sharded fused solve's bits; `export_solver` on rank 0 (its op library
built in a thread there from the start), the artifact's bytes
broadcast, loaded on every rank (`load_solver`, which checks the
groups) and run on the shard's data twice and on the fresh shard once,
with the same bits. Times: each run's seconds (host clock, the sum of a
chain's solves, after a warm-up run that captures), the served calls',
the export's, the load's and the loaded solves', and, CUDA events,
median of 5 runs: K1 on the shard, K1s, and one all-reduce of n float32
values (the collectives COLLECTIVE_CALLS times a run on every rank).

Then chip_smoke.py phase 20's λ sweep (4096 instances at 2048×128, the
throughput plan) on each card alone, and with its batch axis over all
ranks (`mesh=`, 4096/world instances a rank, one all_gather after the
solve); ``--sweep`` runs this part alone. Required: every rank holds
rank 0's result bit for bit; each rank's share of it is bit for bit the
one-card sweep of that share alone (the same products); and
SHARE_CHECKED instances spread over each rank's share lie within
E2E_RTOL of the scalar fused solve at their λ, run on that rank's card
to its own stop, wherever both converged (chip_smoke.py phase 20's
check; an instance at the epoch cap in one run only is reported).
Reported beside it: each instance's objective against the 4096-wide
one-card sweep — the quantiles of the relative difference over the
instances that converged in both, and how many lie beyond E2E_RTOL. In
float32 that comparison depends on the batch width: the products of
1024 and of 4096 instances round differently, and an instance whose
x_tol test fires on a step that Armijo shrank stops at another point
(chip_smoke.py phase 20 reports the same spread on one card, solving
the four shares one by one). The seconds of both (host clock, the
second call of each: the first captures). Rank 0 prints the card and
power limit, then one JSON line, and every rank tears its groups down
with `parallel.distributed_shutdown`, which drops the cached captures
first: NCCL's teardown waits for every graph that holds a collective of
the communicator (ROADMAP C15). A rank still running EXIT_WAIT_S
seconds later prints its stacks (faulthandler). Without CUDA it exits
non-zero.

``--overlap`` runs the cached path and the comm_overlap_chunks chains
alone (timed chunks 1 and 2, fused chunks 2), with the same checks.

``--mesh2d`` (four ranks) runs meshes of two axes instead, all fused
(captured over NCCL) on chip_smoke.py phase 3's problem and anchor:
phase 23's 16-λ sweep (the throughput plan, max_epoch 60, cached
GGN-CG) on one card, on a 2×2 ('batch', 'data') mesh (the problem's
rows over 'data', the instances over 'batch') and on a ('data',) mesh
of four; phase 3's cached chain on one card, feature-sharded on a
('model',) mesh of four and on a 2×2 ('data', 'model') mesh (the
products route: K3 alone launches); and the sweep with plan='auto' on
the 2×2 mesh, whose ranks must resolve one plan. Required: every rank
holds its group's x bit for bit (the sweeps gather over 'batch', so
there every rank the whole result); objectives within E2E_RTOL of the
one-card runs wherever both converged; and, for the chains, one solve
with a record every epoch in fused and in timed mode (uncaptured) bit
for bit. The seconds of each (host clock, after a warm-up run that
captures).
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time

import chip_smoke as cs

#: calls a timed run of a collective makes, on every rank
COLLECTIVE_CALLS = 20
#: seconds after the JSON line past which every rank dumps its stacks
EXIT_WAIT_S = 120
#: instances of each rank's share of the sweep held against scalar solves
SHARE_CHECKED = 4
#: the L-BFGS run with the Armijo line search: epochs, and its step 1/L
ARMIJO_EPOCHS = 60


def paths(prob_t, best, mprob_t, mbest):
    """name → (problem, run(method, problem, mode, every) → (Solution,
    timed_chain's dict or None), method, the kernels it launches). A run
    is a chain to the 1e-6 gap against its anchor, or one solve; with
    ``every`` one solve with a record every epoch (the fused-vs-timed
    check)."""
    import scso_tpu_torch as st

    sm = st.PHuberSmootherL1L2(1.0)

    def chain(anchor):
        def run(method, prob, mode, every):
            if every:
                return st.iterate(method, prob, "l1", sm, **dict(
                    cs.CHUNK_KW, stats_every=1, mode=mode)), None
            r = cs.timed_chain(method, prob, anchor, keep_x=True, mode=mode)
            return r, r
        return run

    def one(kw):
        def run(method, prob, mode, every):
            kw_ = dict(kw, mode=mode, **({"stats_every": 1} if every
                                         else {}))
            return st.iterate(method, prob, "l1", sm, **kw_), None
        return run

    lbfgs_kw = dict(x_tol=0.0, f_tol=0.0, verbose=0, stats_every=4)
    uncached = st.ProxGGNSCORE(**cs.F32_CG, epoch_cache=False)
    return {
        "cached": (prob_t, chain(best), st.ProxGGNSCORE(**cs.F32_CG),
                   cs.LOGISTIC_KERNELS),
        "uncached": (prob_t, chain(best), uncached, cs.UNCACHED_KERNELS),
        "newton_cg": (prob_t, chain(best),
                      st.ProxNSCORE(**cs.NEWTON_GREEDY_OFF),
                      cs.NEWTON_KERNELS),
        "multinomial": (mprob_t, chain(mbest), st.ProxGGNSCORE(**cs.F32_CG),
                        cs.MGLM_KERNELS),
        "lbfgs": (prob_t, one(dict(lbfgs_kw, max_epoch=cs.LBFGS_EPOCHS)),
                  st.ProxLQNSCORE(m=10), cs.LBFGS_KERNELS),
        "lbfgs_armijo": (prob_t, one(dict(lbfgs_kw, max_epoch=ARMIJO_EPOCHS,
                                          alpha=1.0)),
                         st.ProxLQNSCORE(m=10, ss_type=3), cs.LBFGS_KERNELS),
        "mini_batches": (prob_t, one(cs.BATCH_KW),
                         st.ProxGGNSCORE(**cs.F32_CG), cs.UNCACHED_KERNELS),
        "test_set": (cs.test_set_problem(prob_t), one(cs.CHUNK_KW), uncached,
                     cs.UNCACHED_KERNELS),
    }


def timed(run, method, prob, mode="fused", every=False):
    """A warm-up ``run`` (it captures), then the timed one: (Solution or
    chain dict, chain dict or None, seconds, launches)."""
    import torch

    from scso_tpu_torch.ops.cuda import counters

    run(method, prob, mode, every)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    s, r = run(method, prob, mode, every)
    torch.cuda.synchronize()
    return s, r, time.perf_counter() - t0, counters.snapshot()


def final(s, r):
    """(final objective, x, epochs) of a run."""
    if r is not None:
        return r["obj"], r["x"], r["epochs"]
    return float(s.obj[-1]), s.x, s.epochs


def same_on_every_rank(x, mesh, dev):
    """True when every rank holds rank 0's ``x`` bit for bit."""
    import torch
    import torch.distributed as dist

    x0 = x.clone()
    dist.broadcast(x0, 0, group=mesh.group)
    bad = torch.tensor(float(not torch.equal(x, x0)), device=dev)
    dist.all_reduce(bad, group=mesh.group)
    return float(bad) == 0


def run_paths(mesh, dev, say, prob_t, best, mprob_t, mbest, names=None):
    """Each path on one card and on the shard (see the module
    docstring), or those in ``names``; name → its numbers."""
    import torch

    from scso_tpu_torch.parallel import shard_problem

    out = {}
    for name, (prob, run, method, kernels) in paths(
            prob_t, best, mprob_t, mbest).items():
        if names is not None and name not in names:
            continue
        s1, r1, sec1, _ = timed(run, method, prob)
        obj1 = final(s1, r1)[0]
        sp = shard_problem(prob, mesh)
        s4, r4, sec4, lc = timed(run, method, sp)
        obj4, x4, ep4 = final(s4, r4)
        rel = abs(obj4 - obj1) / abs(obj1)
        if not same_on_every_rank(x4, mesh, dev):
            cs.fail(f"{name}: ranks hold different x")
        if not rel <= cs.E2E_RTOL:
            cs.fail(f"{name}: sharded objective {obj4:.9e} against one "
                    f"card's {obj1:.9e} (rel {rel:.2e} > {cs.E2E_RTOL:g})")
        cs.check_launches(lc, kernels + (
            ("normal_matvec_sharded",) if "normal_matvec" in kernels
            else ()), f"sharded {name}")
        if lc["normal_matvec_sharded"] != lc["normal_matvec"]:
            cs.fail(f"{name}: K1s launched {lc['normal_matvec_sharded']} "
                    f"times, K1 {lc['normal_matvec']}")
        fused, _ = run(method, sp, "fused", True)
        slow, _ = run(method, sp, "timed", True)
        if not (fused.epochs == slow.epochs and torch.equal(fused.x, slow.x)
                and torch.equal(fused.obj, slow.obj)):
            cs.fail(f"{name}: fused and timed mode differ on the shard "
                    f"(epochs {fused.epochs} vs {slow.epochs}, x equal "
                    f"{torch.equal(fused.x, slow.x)})")
        say(f"{name}: {mesh.size} ranks fused {sec4:.4f} s, one card "
            f"{sec1:.4f} s ({sec1 / sec4:.2f}x); {ep4} epochs, obj "
            f"{obj4:.9e} (rel diff {rel:.2e}); x bitwise on every rank; "
            f"fused = timed bit for bit ({fused.epochs} epochs, a record "
            f"each); launches on rank 0 {lc}")
        out[name] = dict(seconds=sec4, one_card_seconds=sec1, epochs=ep4,
                         obj=obj4, rel=rel, launches=lc,
                         fused_eq_timed_epochs=fused.epochs)
        del sp
        torch.cuda.empty_cache()
    return out


def refuse(mesh, dev, say):
    """``--refuse`` (run without NCCL_GRAPH_MIXING_SUPPORT=0): a fused
    solve on the shard must raise RuntimeError naming the
    variable, before any collective; timed mode runs."""
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch.parallel import shard_problem

    if mesh.captures:
        cs.fail("--refuse runs without NCCL_GRAPH_MIXING_SUPPORT=0")
    sp = shard_problem(cs.build_problem(4096 * mesh.size, 500, dev,
                                        torch.float32), mesh)
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda *a, **k: calls.append(a)
    try:
        st.iterate(st.ProxGGNSCORE(**cs.F32_CG), sp, "l1",
                   st.PHuberSmootherL1L2(1.0), max_epoch=3, verbose=0)
        cs.fail("a fused solve over NCCL ranks without "
                "NCCL_GRAPH_MIXING_SUPPORT=0 did not raise")
    except RuntimeError as e:
        if "NCCL_GRAPH_MIXING_SUPPORT" not in str(e) or calls:
            cs.fail(f"the refusal {e!r} after {len(calls)} collectives")
        msg = str(e)
    finally:
        dist.all_reduce = real
    s = st.iterate(st.ProxGGNSCORE(**cs.F32_CG), sp, "l1",
                   st.PHuberSmootherL1L2(1.0), max_epoch=3, verbose=0,
                   mode="timed")
    say(f"without the variable a fused solve raised before any "
        f"collective: {msg!r}; timed mode ran {s.epochs} epochs")
    return {"refused": msg, "timed_epochs": s.epochs}



def mesh2d(world, dev, say):
    """``--mesh2d`` (see the module docstring): name → its numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.parallel import (
        make_mesh, shard_problem, shard_problem_features, sweep)

    swp = __import__("importlib").import_module(
        "scso_tpu_torch.parallel.sweep")
    if world != 4:
        cs.fail(f"--mesh2d needs four ranks, not {world}")
    meshes = {"batch_data": make_mesh((2, 2), ("batch", "data")),
              "data": make_mesh((4,), ("data",)),
              "model": make_mesh((4,), ("model",)),
              "data_model": make_mesh((2, 2), ("data", "model"))}
    if not all(m.captures for m in meshes.values()):
        cs.fail("a mesh's communicators were made without "
                "NCCL_GRAPH_MIXING_SUPPORT=0")
    prob = cs.build_problem(*cs.MAIN_SHAPE, dev, torch.float32)
    meth = st.ProxGGNSCORE(**cs.F32_CG)
    best, x_opt, _ = cs.presolve(meth, prob)
    prob_t = replace(prob, x_star=x_opt)
    del prob
    sm = st.PHuberSmootherL1L2(1.0)
    lam = cs.mesh2d_lams()
    opts = st.Options(**cs.MESH2D_KW)
    cap = cs.MESH2D_KW["max_epoch"]
    out = {}

    def run_sweep(prob, mesh, plan="throughput"):
        go = lambda: sweep(meth, prob, "l1", sm, lam_grid=lam, opts=opts,
                           plan=plan, mesh=mesh)
        go()  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = go()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    cs.free_graphs()  # the presolve's captures
    one, one_s = run_sweep(prob_t, None)
    cs.free_graphs()
    out["sweep_one_card"] = dict(seconds=one_s, epochs=one.epochs.tolist())
    say(f"sweep, one card: {one_s:.4f} s, epochs {one.epochs.tolist()}")
    for name, bmesh in (("batch_data", meshes["batch_data"]),
                        ("data", None)):
        sp = shard_problem(prob_t, meshes[name])
        r, secs = run_sweep(sp, bmesh)
        flat = torch.cat([r.x.reshape(-1), r.obj, r.epochs.float()])
        if not same_on_every_rank(flat, meshes[name], dev):
            cs.fail(f"sweep on {name}: ranks hold different results")
        both = (r.epochs < cap) & (one.epochs < cap)
        rel = ((r.obj - one.obj).abs() / one.obj.abs()).double()
        worst = float(rel[both].max()) if bool(both.any()) else None
        if not bool(both.any()) or worst > cs.E2E_RTOL:
            cs.fail(f"sweep on {name}: objectives {worst} from one card's "
                    f"(converged in both: {int(both.sum())})")
        out[f"sweep_{name}"] = dict(
            seconds=secs, one_card_seconds=one_s,
            converged_both=int(both.sum()), max_rel=worst,
            epochs_equal=int((r.epochs == one.epochs).sum()))
        say(f"sweep on {name}: {secs:.4f} s (one card {one_s:.4f} s); "
            + json.dumps(out[f"sweep_{name}"]))
        del sp
        cs.free_graphs()
    # plan='auto' over the four ranks: one plan, agreed
    sp = shard_problem(prob_t, meshes["batch_data"])
    plans = [None] * world
    dist.all_gather_object(plans, swp._resolve_plan(
        "auto", sp, len(lam), opts, 2, meshes["batch_data"]))
    if len(set(map(tuple, plans))) != 1:
        cs.fail(f"plan='auto': the ranks resolved {plans}")
    r, secs = run_sweep(sp, meshes["batch_data"], plan="auto")
    if not same_on_every_rank(torch.cat([r.x.reshape(-1), r.obj]),
                              meshes["batch_data"], dev):
        cs.fail("plan='auto': ranks hold different results")
    out["sweep_auto"] = dict(seconds=secs, plan=list(plans[0]),
                             latency_s=swp._dispatch_latency_s(dev),
                             agreed_latency_s=swp._agreed_latency_s(
                                 sp, meshes["batch_data"]))
    say("plan='auto' on ('batch', 'data') 2x2: " + json.dumps(
        out["sweep_auto"]))
    del sp, r
    cs.free_graphs()

    # phase 3's cached chain: one card, then feature-sharded
    def chain(prob):
        cs.solve_chunk(meth, prob)  # warm-up: the capture
        torch.cuda.synchronize()
        counters.reset()
        r = cs.timed_chain(meth, prob, best, keep_x=True)
        r["launches"] = counters.snapshot()
        r.pop("objs")
        r.pop("first_info")
        return r

    c1 = chain(prob_t)
    x1 = c1.pop("x")
    out["chain_one_card"] = c1
    say(f"cached chain, one card: {c1['seconds']:.4f} s, {c1['epochs']} "
        f"epochs, obj {c1['obj']:.9e}")
    del x1
    for name in ("model", "data_model"):
        mesh = meshes[name]
        base = shard_problem(prob_t, mesh) if "data" in name else prob_t
        cp = shard_problem_features(base, mesh)
        r = chain(cp)
        x = r.pop("x")
        if not same_on_every_rank(x, mesh, dev):
            cs.fail(f"chain on {name}: ranks hold different x")
        rel = abs(r["obj"] - c1["obj"]) / abs(c1["obj"])
        if not (rel <= cs.E2E_RTOL and r["gap"] <= cs.GAP * 1.05):
            cs.fail(f"chain on {name}: obj rel {rel:.2e} to one card, gap "
                    f"{r['gap']:.3e}")
        cs.check_launches(r["launches"], ("score_update",),
                          f"feature-sharded ({name})")
        kw = dict(cs.CHUNK_KW, stats_every=1)
        fused = st.iterate(meth, cp, "l1", sm, **kw)
        slow = st.iterate(meth, cp, "l1", sm, **dict(kw, mode="timed"))
        if not (fused.epochs == slow.epochs and torch.equal(fused.x, slow.x)
                and torch.equal(fused.obj, slow.obj)):
            cs.fail(f"chain on {name}: fused and timed mode differ")
        out[f"chain_{name}"] = dict(r, rel=rel,
                                    one_card_seconds=c1["seconds"],
                                    fused_eq_timed_epochs=fused.epochs)
        say(f"cached chain on {name}: {r['seconds']:.4f} s (one card "
            f"{c1['seconds']:.4f} s), {r['epochs']} epochs, {r['cg_iters']} "
            f"CG iterations, obj {r['obj']:.9e} (rel {rel:.2e}); x bitwise "
            f"on every rank; fused = timed bit for bit ({fused.epochs} "
            f"epochs); launches on rank 0 {r['launches']}")
        del cp, base
        cs.free_graphs()
    return out

def main():
    sys.path.insert(0, cs.ROOT)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script measures "
                "the GPUs and does not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters
    from scso_tpu_torch.ops.cuda.matvec import (
        normal_matvec, normal_matvec_sharded)
    from scso_tpu_torch.parallel import (
        distributed_init, make_mesh, shard_problem)

    world = distributed_init()
    if not (world >= 2 and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        cs.fail(f"needs torchrun with two ranks or more over NCCL; got "
                f"{world} rank(s)")
    mesh = make_mesh()
    rank0 = mesh.rank == 0
    say = cs.log if rank0 else (lambda msg: None)
    dev = torch.device("cuda", torch.cuda.current_device())
    if rank0:
        cs.log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    if sys.argv[1:] == ["--refuse"]:
        return finish({"world": world, **refuse(mesh, dev, say)}, mesh, say)
    if not mesh.captures:
        cs.fail("run under NCCL_GRAPH_MIXING_SUPPORT=0 (a fused solve over "
                "NCCL ranks needs it; --refuse checks the run without it)")
    if sys.argv[1:] == ["--sweep"]:
        return finish({"world": world,
                       "sweep": sweep_over_ranks(dev, say)}, mesh, say)
    if sys.argv[1:] == ["--mesh2d"]:
        t0 = time.perf_counter()
        out = {"world": world, **mesh2d(world, dev, say)}
        out["seconds"] = time.perf_counter() - t0
        return finish(out, mesh, say)
    overlap = sys.argv[1:] == ["--overlap"]
    if rank0 and not overlap:
        # the op library of `sharded_serving`'s export, built beside the
        # paths on the host's spare cores (after the kernels' nvcc build)
        from scso_tpu_torch.ops.cuda import build

        build.load()
        cs.start_ops_build()
    prob = cs.build_problem(*cs.MAIN_SHAPE, dev, torch.float32)
    method = st.ProxGGNSCORE(**cs.F32_CG)
    best, x_opt, _ = cs.presolve(method, prob)
    prob_t = replace(prob, x_star=x_opt)
    del prob
    mprob_t = mbest = None
    if not overlap:
        mprob = cs.build_mglm_problem(*cs.MGLM_SHAPE, dev, torch.float32)
        mbest, mx_opt, _ = cs.presolve(method, mprob)
        mprob_t = replace(mprob, x_star=mx_opt)
        del mprob
    out = {"world": world, "rows_per_rank": prob_t.A.shape[0] // world}
    out["paths"] = run_paths(mesh, dev, say, prob_t, best, mprob_t, mbest,
                             names=("cached",) if overlap else None)
    del mprob_t
    sp = shard_problem(prob_t, mesh)
    del prob_t
    torch.cuda.empty_cache()
    for chunks in (1, 2):
        m_ = st.ProxGGNSCORE(**cs.F32_CG, comm_overlap_chunks=chunks)
        cs.solve_chunk(m_, sp, mode="timed")  # warm-up
        counters.reset()
        r = cs.timed_chain(m_, sp, best, keep_x=True, mode="timed")
        r["launches"] = counters.snapshot()
        x = r.pop("x")
        r.pop("objs")
        ref = out["paths"]["cached"]
        rel = abs(r["obj"] - ref["obj"]) / abs(ref["obj"])
        say(f"{world} ranks, timed mode, comm_overlap_chunks={chunks}: "
            f"{r['seconds']:.4f} s (fused, chunks 1: {ref['seconds']:.4f} "
            f"s), {r['epochs']} epochs, obj {r['obj']:.9e} (rel diff to "
            f"fused {rel:.2e}), launches on rank 0 {r['launches']}")
        if not same_on_every_rank(x, mesh, dev):
            cs.fail(f"comm_overlap_chunks={chunks}: ranks hold different x")
        if not (rel <= cs.E2E_RTOL and r["gap"] <= cs.GAP * 1.05):
            cs.fail(f"comm_overlap_chunks={chunks}: rel diff {rel:.2e}, "
                    f"gap {r['gap']:.3e}")
        lc = r["launches"]
        # chunks=1 is K1 on the shard plus an all_reduce; the overlapped
        # form's products are matrix products and launch neither K1 nor
        # K1s
        k1s_ok = (lc["normal_matvec_sharded"] == lc["normal_matvec"] > 0
                  if chunks == 1 else
                  lc["normal_matvec_sharded"] == lc["normal_matvec"] == 0)
        if not (k1s_ok and lc["glm_prep_pair"] > 0):
            cs.fail(f"comm_overlap_chunks={chunks}: launches {lc}")
        out[f"timed_overlap{chunks}"] = r
    out["fused_overlap2"] = fused_overlap(mesh, dev, say, sp, best, out)
    if overlap:
        return finish(out, mesh, say)
    out["serving"] = sharded_serving(mesh, dev, say, sp)
    out["sweep"] = sweep_over_ranks(dev, say)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + mesh.rank)
    n = sp.A.shape[1]
    w = torch.rand((sp.A.shape[0],), generator=gen, device=dev) / sp.m_total
    v = torch.randn((n,), generator=gen, device=dev)
    buf = torch.ones(n, device=dev)
    # the collectives run as often on every rank: a count taken from each
    # rank's own clock left ranks waiting in all-reduces that no other
    # rank made, and the script hung after its JSON line (ROADMAP C9)
    out["ms"] = {
        "normal_matvec_shard": cs.time_ms(lambda: normal_matvec(sp.A, w, v)),
        "normal_matvec_sharded": cs.time_ms(
            lambda: normal_matvec_sharded(sp.A, w, v, mesh),
            calls=COLLECTIVE_CALLS),
        "all_reduce_n_f32": cs.time_ms(
            lambda: dist.all_reduce(buf, group=mesh.group),
            calls=COLLECTIVE_CALLS),
    }
    say(f"CUDA events, median of 5 runs of {COLLECTIVE_CALLS} calls "
        f"(K1 alone: as many as fill 20 ms), rank 0: {out['ms']}")
    finish(out, mesh, say)


def fused_overlap(mesh, dev, say, sp, best, out):
    """Phase 3's chain fused with comm_overlap_chunks 2 on the shard
    (see the module docstring): its numbers."""
    import torch

    import scso_tpu_torch as st
    from scso_tpu_torch.ops.cuda import counters

    m2 = st.ProxGGNSCORE(**cs.F32_CG, comm_overlap_chunks=2)
    cs.solve_chunk(m2, sp)  # warm-up: the capture
    torch.cuda.synchronize()
    counters.reset()
    r = cs.timed_chain(m2, sp, best, keep_x=True)
    lc = r["launches"] = counters.snapshot()
    x = r.pop("x")
    r.pop("objs")
    timed = out["timed_overlap2"]
    if not same_on_every_rank(x, mesh, dev):
        cs.fail("fused comm_overlap_chunks=2: ranks hold different x")
    if (r["epochs"], r["obj"]) != (timed["epochs"], timed["obj"]):
        cs.fail(f"fused comm_overlap_chunks=2: {r['epochs']} epochs, obj "
                f"{r['obj']!r} against timed chunks 2's {timed['epochs']}, "
                f"{timed['obj']!r}")
    if not (lc["normal_matvec"] == lc["normal_matvec_sharded"] == 0
            and lc["glm_prep_pair"] > 0 and lc["score_update"] > 0):
        cs.fail(f"fused comm_overlap_chunks=2: launches {lc}")
    kw = dict(cs.CHUNK_KW, stats_every=1)
    sm = st.PHuberSmootherL1L2(1.0)
    fused = st.iterate(m2, sp, "l1", sm, **kw)
    slow = st.iterate(m2, sp, "l1", sm, **dict(kw, mode="timed"))
    if not (fused.epochs == slow.epochs and torch.equal(fused.x, slow.x)
            and torch.equal(fused.obj, slow.obj)):
        cs.fail("fused comm_overlap_chunks=2: fused and timed mode differ "
                f"(epochs {fused.epochs} vs {slow.epochs})")
    r["fused_eq_timed_epochs"] = fused.epochs
    say(f"{mesh.size} ranks, fused, comm_overlap_chunks=2: "
        f"{r['seconds']:.4f} s (fused chunks 1 "
        f"{out['paths']['cached']['seconds']:.4f} s, timed chunks 2 "
        f"{timed['seconds']:.4f} s), {r['epochs']} epochs, timed chunks "
        f"2's chain; x bitwise on every rank; fused = timed bit for bit "
        f"({fused.epochs} epochs, a record each); launches on rank 0 {lc}")
    return r


def sharded_serving(mesh, dev, say, sp):
    """Phase 3's solve served and exported on the shard (see the module
    docstring): its numbers."""
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch._src.struct import replace
    from scso_tpu_torch.ops.cuda import counters, graph
    from scso_tpu_torch.utils import (
        export_solver, load_solver, make_serving_fn)

    meth, sm = st.ProxGGNSCORE(**cs.F32_CG), st.PHuberSmootherL1L2(1.0)
    tpl, opts = cs.chain_template(sp)
    fresh = replace(sp, A=sp.A.flip(0), y=(1 - sp.y).flip(0))
    data = {"shard": sp, "fresh": fresh}
    refs = {name: cs.solve_chunk(meth, p) for name, p in data.items()}
    serve = make_serving_fn(meth, tpl, "l1", sm, opts)
    out = {}
    for i, name in enumerate(("shard", "fresh", "shard")):
        p = data[name]
        graph.reset_stats()
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = serve(p.A, p.y, p.x0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cs.same_served(f"served call {i + 1} ({name})", got, refs[name])
        lc = counters.snapshot()
        cs.check_launches(lc, cs.SHARDED_KERNELS,
                          f"served call {i + 1} ({name})")
        if i and graph.STATS["captures"]:
            cs.fail(f"served call {i + 1} captured anew")
        out[f"call{i + 1}_{name}"] = dict(
            seconds=secs, epochs=refs[name].epochs,
            captures=graph.STATS["captures"],
            launches={k: lc[k] for k in cs.SHARDED_KERNELS})
    say(f"served on {mesh.size} ranks, the sharded fused solve's bits: "
        + json.dumps(out))
    del serve
    cs.free_graphs()
    t0 = time.perf_counter()
    blob = [export_solver(meth, tpl, "l1", sm, opts)
            if mesh.rank == 0 else None]
    out["export_s"] = time.perf_counter() - t0
    dist.broadcast_object_list(blob, 0)
    blob = blob[0]
    t0 = time.perf_counter()
    loaded = load_solver(blob)
    out["load_s"] = time.perf_counter() - t0
    out["artifact_bytes"] = len(blob)
    for name, reps in (("shard", 2), ("fresh", 1)):
        p = data[name]
        got, secs = cs.loaded_solve(loaded, (p.A, p.y, p.x0), reps=reps)
        cs.same_served(f"the loaded sharded program ({name})", got,
                       refs[name])
        out[f"loaded_{name}_s"] = secs
    say(f"exported on rank 0 in {out['export_s']:.2f} s ({len(blob)} "
        f"bytes), loaded on every rank in {out['load_s']:.2f} s (rank 0), "
        f"loaded solves {out['loaded_shard_s']} s (fresh "
        f"{out['loaded_fresh_s']} s), the sharded fused solve's bits")
    del loaded, blob, fresh, tpl
    cs.free_graphs()
    return out


def finish(out, mesh, say):
    """The JSON line, then the groups torn down after the cached captures
    are dropped (should a rank still wait after the line, each rank
    prints where)."""
    from scso_tpu_torch.parallel import distributed_shutdown

    say(json.dumps(out))
    faulthandler.dump_traceback_later(EXIT_WAIT_S)
    distributed_shutdown()
    faulthandler.cancel_dump_traceback_later()


def sweep_over_ranks(dev, say):
    """Phase 20's throughput sweep on this card alone, then split over
    the ranks (see the module docstring)."""
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    import scso_tpu_torch as st
    from scso_tpu_torch.parallel import make_mesh, sweep

    bmesh = make_mesh(axis_names=("batch",))
    prob = cs.sweep_problem(dev)
    lam = np.logspace(-3, -0.5, cs.SWEEP_B).astype(np.float32)
    meth = st.ProxNSCORE(solver="cg", ss_type=3)
    sm = st.PHuberSmootherL1L2(1.0)
    run = lambda mesh, grid: sweep(
        meth, prob, "l1", sm, lam_grid=grid, opts=st.Options(**cs.SWEEP_KW),
        plan="throughput", mesh=mesh)
    share = cs.SWEEP_B // bmesh.size
    lo = bmesh.rank * share
    secs = {}
    res = {}
    for name, mesh, grid in (("one_card", None, lam),
                             ("ranks", bmesh, lam),
                             ("share", None, lam[lo:lo + share])):
        run(mesh, grid)  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = run(mesh, grid)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    r, one, own = res["ranks"], res["one_card"], res["share"]
    fields = ("x", "obj", "epochs", "n_rec", "obj_hist")
    flat = lambda res_, sl: torch.cat([getattr(res_, f)[sl].reshape(-1)
                                       .double() for f in fields])
    mine = flat(r, slice(None))
    theirs = mine.clone()
    dist.broadcast(theirs, 0, group=bmesh.group)
    bad = torch.tensor([float(not torch.equal(mine, theirs)),
                        float(not torch.equal(flat(r, slice(lo, lo + share)),
                                              flat(own, slice(None))))],
                       device=dev)
    dist.all_reduce(bad, group=bmesh.group)
    if float(bad[0]) != 0:
        cs.fail("sweep over ranks: ranks hold different results")
    if float(bad[1]) != 0:
        cs.fail("sweep over ranks: a rank's share differs from the "
                "one-card sweep of that share alone")
    # instances spread over this rank's share against scalar fused solves
    picks = np.linspace(0, share - 1, SHARE_CHECKED).round().astype(int)
    checked, edge = cs.against_scalar(prob, lam, own, picks, meth, sm,
                                      offset=lo)
    rows = [None] * bmesh.size
    dist.all_gather_object(rows, dict(checked=checked, edge=edge),
                           group=bmesh.group)
    checked = [row for got in rows for row in got["checked"]]
    edge = [row for got in rows for row in got["edge"]]
    far = [row for row in checked if not row["rel"] <= cs.E2E_RTOL]
    if far or not checked:
        cs.fail(f"sweep over ranks: of {len(checked)} instances converged "
                f"in both, {len(far)} lie beyond {cs.E2E_RTOL} of their "
                f"scalar solves: {json.dumps(far)}")
    cap = cs.SWEEP_KW["max_epoch"]
    rel = ((r.obj - one.obj).abs() / one.obj.abs()).double()
    both = (r.epochs < cap) & (one.epochs < cap)
    q = torch.quantile(rel[both], torch.tensor(
        [0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=dev)).tolist()
    out = dict(world=bmesh.size, instances=cs.SWEEP_B, per_rank=share,
               seconds=secs["ranks"], one_card_seconds=secs["one_card"],
               share_alone_seconds=secs["share"],
               converged_frac=float((r.epochs < cap).float().mean()),
               shares_bitwise=True,
               vs_scalar=dict(checked=len(checked),
                              max_rel=max(row["rel"] for row in checked),
                              edge=edge),
               vs_one_card=dict(
                   converged_both=int(both.sum()),
                   rel_obj_quantiles_50_90_99_100=q,
                   beyond_e2e_rtol=int((rel[both] > cs.E2E_RTOL).sum()),
                   exactly_equal=int((rel[both] == 0).sum()),
                   epochs_equal_frac=float((r.epochs == one.epochs)
                                           .float().mean())))
    say(f"sweep over {bmesh.size} ranks: " + json.dumps(out))
    return out


if __name__ == "__main__":
    if not os.path.isdir(os.path.join(cs.ROOT, "scso_tpu_torch")):
        cs.fail("scso_tpu_torch not found beside chip_sharded.py")
    main()
