#!/usr/bin/env python3
"""Whether NCCL collectives across ranks can sit inside a captured CUDA
graph: plainly, inside an IF node and inside a WHILE node
(`ops/cuda/graph.py`), under the NCCL_GRAPH_MIXING_SUPPORT setting of
the run; where both conditionals capture, a small row-sharded cached
GGN-CG solve (chip_smoke's data, 16384×1000, float32, 30 epochs)
captured in fused mode against timed mode.

    NCCL_GRAPH_MIXING_SUPPORT=0 torchrun --nproc-per-node=4 chip_nccl_graph.py

One process per card. Fused mode on a row shard of more than one rank
raises in the port where the process group was made without the
variable (`iterate._check_capturable`); this script lifts that check for
its own solve only, so that it probes either setting. Each rank prints one line: each
capture's outcome (True: the replay gave the right sum; else the
error), and the fused solve's epochs and whether its x and objective
history equal timed mode's bit for bit.
"""
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_nccl_graph.py FAILED: no CUDA device", file=sys.stderr)
        sys.exit(1)
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
        import chip_smoke as cs
        import scso_tpu_torch as st
        from scso_tpu_torch.algorithms import iterate as it
        from scso_tpu_torch.parallel import make_mesh, shard_problem

        it._check_capturable = lambda prob, method=None: None
        sp = shard_problem(
            cs.build_problem(16384, 1000, dev, torch.float32), make_mesh())
        kw = dict(x_tol=1e-12, f_tol=1e-10, max_epoch=30, verbose=0,
                  alpha=1.0, stats_every=1)
        m = st.ProxGGNSCORE(**cs.F32_CG)
        try:
            a = st.iterate(m, sp, "l1", st.PHuberSmootherL1L2(1.0), **kw)
            b = st.iterate(m, sp, "l1", st.PHuberSmootherL1L2(1.0),
                           **dict(kw, mode="timed"))
            res["fused_sharded"] = dict(epochs=(a.epochs, b.epochs),
                                        x_equal=bool(torch.equal(a.x, b.x)),
                                        obj_equal=bool(torch.equal(a.obj,
                                                                   b.obj)))
        except Exception as e:  # noqa: BLE001
            res["fused_sharded"] = repr(e)[:300]
    print(f"rank {rank} NCCL_GRAPH_MIXING_SUPPORT="
          f"{os.environ.get('NCCL_GRAPH_MIXING_SUPPORT')}: {res}", flush=True)
    # no teardown: after a failed capture the communicator's state is unknown
    os._exit(0)


if __name__ == "__main__":
    main()
