#!/usr/bin/env python3
"""The row-sharded cached GGN-CG path over NCCL on every card of one host.

    torchrun --nproc-per-node=4 chip_sharded.py

One process per card (torchrun's RANK, LOCAL_RANK, WORLD_SIZE and
rendezvous). Every rank builds chip_smoke.py's phase 3 problem
(196608×10000 padded to 10112, seed 7, float32) on its own card, runs
phase 3's presolve and unsharded timed chain there (the reference, the
same on every rank), then the same chain on its row shard
(`shard_problem` over all ranks: K1s, K2 on the shard, one packed
all-reduce an epoch, K3), with comm_overlap_chunks 1 and 2. Required:
each sharded chain reaches the 1e-6 gap with its final objective within
chip_smoke.E2E_RTOL of the unsharded one, and every rank holds rank 0's
x bit for bit; K2 launched, and K1s as often as K1 with chunks 1 (the
overlapped form launches neither). Times: the chains (host clock, the
sum of the chained solves), and, CUDA events, median of 20: K1 on the
shard, K1s, and one all-reduce of n float32 values. Rank 0 prints the
card and power limit, then one JSON line. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke as cs


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
    prob = cs.build_problem(*cs.MAIN_SHAPE, dev, torch.float32)
    method = st.ProxGGNSCORE(solver="cg", cg_maxiter=100)
    best, x_opt, _ = cs.presolve(method, prob)
    prob_t = replace(prob, x_star=x_opt)
    cs.solve_chunk(method, prob_t)  # warm-up
    ref = cs.timed_chain(method, prob_t, best)
    say(f"unsharded on each card: {ref['seconds']:.4f} s, {ref['epochs']} "
        f"epochs, {ref['cg_iters']} CG iterations, obj {ref['obj']:.9e}")
    sp = shard_problem(prob_t, mesh)
    del prob, prob_t
    torch.cuda.empty_cache()
    out = {"world": world, "rows_per_rank": sp.A.shape[0], "unsharded": ref}
    for chunks in (1, 2):
        m_ = st.ProxGGNSCORE(solver="cg", cg_maxiter=100,
                             comm_overlap_chunks=chunks)
        cs.solve_chunk(m_, sp)  # warm-up
        counters.reset()
        r = cs.timed_chain(m_, sp, best, keep_x=True)
        r["launches"] = counters.snapshot()
        x = r.pop("x")
        x_rank0 = x.clone()
        dist.broadcast(x_rank0, 0, group=mesh.group)
        bad = torch.tensor(float(not torch.equal(x, x_rank0)), device=dev)
        dist.all_reduce(bad, group=mesh.group)
        rel = abs(r["obj"] - ref["obj"]) / abs(ref["obj"])
        say(f"{world} ranks, comm_overlap_chunks={chunks}: "
            f"{r['seconds']:.4f} s, {r['epochs']} epochs, {r['cg_iters']} "
            f"CG iterations, obj {r['obj']:.9e} (rel diff {rel:.2e}), "
            f"launches on rank 0 {r['launches']}")
        if float(bad) != 0:
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
        out[f"overlap{chunks}"] = r
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + mesh.rank)
    n = sp.A.shape[1]
    w = torch.rand((sp.A.shape[0],), generator=gen, device=dev) / sp.m_total
    v = torch.randn((n,), generator=gen, device=dev)
    buf = torch.ones(n, device=dev)
    out["ms"] = {
        "normal_matvec_shard": cs.time_ms(lambda: normal_matvec(sp.A, w, v)),
        "normal_matvec_sharded": cs.time_ms(
            lambda: normal_matvec_sharded(sp.A, w, v, mesh)),
        "all_reduce_n_f32": cs.time_ms(
            lambda: dist.all_reduce(buf, group=mesh.group)),
    }
    say(f"CUDA events, median of 20, rank 0: {out['ms']}")
    say(json.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    if not os.path.isdir(os.path.join(cs.ROOT, "scso_tpu_torch")):
        cs.fail("scso_tpu_torch not found beside chip_sharded.py")
    main()
