#!/usr/bin/env python3
"""Time K3 and K4 of two checkouts of the port in turns on one GPU.

    python3 chip_ab.py BASE

BASE is the root of another checkout (for instance the parent commit,
unpacked with ``git archive``); this script's own checkout is the other
arm. Both kernel libraries are built first, side by side. Then four
arms run, each in a fresh process, in the order BASE, this checkout,
this checkout, BASE. Each arm times K3 (the 'l1' prox, float32) at n in
K3_TIMED_NS and K4 (float32, a full memory) at TWO_LOOP_TIMED with
chip_smoke.py's three times: per call (``time_ms``), the device time
alone (``graph_ms``) and the host time a call (``host_ms``). Only the
public wrappers are called, so any checkout of the port runs. An arm of
this checkout also times an empty kernel's launch (the floor under both)
and, on the host clock alone, each step of a wrapper call. The last line
of standard output is one JSON object with every arm's numbers and the
card's name and power limit; without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def smoke():
    """chip_smoke.py of this checkout, as a module (its helpers import the
    port only inside their bodies, so they time whichever port is first
    on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_steps(cs):
    """ms on the host clock (host_ms) of the steps a K3 call takes, at
    the main path's n: the parts of the parent's wrapper beside the ones
    that replace them."""
    import torch

    from scso_tpu_torch.ops.cuda import launch

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(10112, device=dev)
    lam = torch.tensor(0.07, device=dev)
    stats = torch.empty(3, device=dev)
    ten = dict(x=x, d=x, lgr=x, hr=x, lam=lam, ss=lam, lb=x)

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "as_tensor(0-d).reshape(())": lambda: torch.as_tensor(
            lam, dtype=torch.float32, device=dev).reshape(()),
        "check_operands, 7 tensors": lambda: launch.check_operands(
            "score_update", torch.float32, dev, **ten),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.cuda.device context": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "launch.stream (raw handle)": lambda: launch.stream(dev),
        "stats[0], stats[1], stats[2]": lambda: (stats[0], stats[1],
                                                 stats[2]),
        "stats.unbind()": stats.unbind,
        "max_cluster (cached)": lambda: launch.max_cluster(
            "scso_score_update", torch.float32, dev.index),
    }
    return {k: cs.host_ms(fn, calls=2000) for k, fn in steps.items()}


def arm(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_ab.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = smoke()
    from scso_tpu_torch.ops.cuda import build
    from scso_tpu_torch.ops.cuda.score_update import score_update
    from scso_tpu_torch.ops.cuda.two_loop import two_loop

    build.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    keys = ("ms", "device_ms", "host_ms")
    out = {"root": root, "k3": {}, "k4": {}}
    for n in cs.K3_TIMED_NS:
        args = cs.score_update_inputs(n, "l1", torch.float32, gen)
        out["k3"][n] = dict(zip(keys, cs.three_times(
            lambda: score_update(*args))))
    for n, m in cs.TWO_LOOP_TIMED:
        mem, g = cs.two_loop_inputs(n, m, m + 3, torch.float32, gen)
        out["k4"][f"{n}x{m}"] = dict(zip(keys, cs.three_times(
            lambda: two_loop(mem, g))))
    if os.path.samefile(root, HERE):
        out["floor"] = {k: dict(zip(keys, v))
                        for k, v in cs.launch_floor().items()}
        out["host_steps_ms"] = host_steps(cs)
    return out


def run(cmd) -> str:
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    sys.stderr.write(p.stderr)
    if p.returncode != 0:
        sys.exit(f"chip_ab.py: {' '.join(cmd)} failed ({p.returncode})")
    return p.stdout


def main():
    if sys.argv[1:2] == ["--arm"]:
        print(json.dumps(arm(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 2 or not os.path.isdir(
            os.path.join(sys.argv[1], "scso_tpu_torch")):
        sys.exit(__doc__)
    base = os.path.abspath(sys.argv[1])
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_ab.py: no CUDA device")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    print(card, flush=True)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from scso_tpu_torch.ops.cuda import build; "
             "print(sys.argv[1], build.build().seconds)")
    procs = [subprocess.Popen([sys.executable, "-c", build, root])
             for root in (base, HERE)]
    if any(p.wait(timeout=900) for p in procs):
        sys.exit("chip_ab.py: a build failed")
    arms = []
    for root in (base, HERE, HERE, base):
        res = json.loads(run([sys.executable, os.path.abspath(__file__),
                              "--arm", root]).strip().splitlines()[-1])
        res["arm"] = "base" if root == base else "head"
        arms.append(res)
        print(f"{res['arm']}: " + ", ".join(
            f"K3 n={n} {v['ms']:.4f}/{v['device_ms']:.4f}/{v['host_ms']:.4f}"
            for n, v in res["k3"].items()) + "; " + ", ".join(
            f"K4 {s} {v['ms']:.4f}/{v['device_ms']:.4f}/{v['host_ms']:.4f}"
            for s, v in res["k4"].items())
            + " ms (per call/device/host)", flush=True)
    print(json.dumps({"card": card, "arms": arms}))


if __name__ == "__main__":
    main()
