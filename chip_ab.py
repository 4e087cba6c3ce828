#!/usr/bin/env python3
"""Time the port's kernels of two checkouts in turns on one GPU.

    python3 chip_ab.py BASE [--sweep]

BASE is the root of another checkout (for instance the parent commit,
unpacked with ``git archive``); this script's own checkout is the other
arm. Both kernel libraries are built first, side by side. Then four
arms run, each in a fresh process, in the order BASE, this checkout,
this checkout, BASE. Each arm times, with chip_smoke.py's per-call time
(``time_ms``: runs of back-to-back calls between CUDA events, median of
5) and device time alone (``graph_ms``: a CUDA graph of 20 calls):

  * K2 with A in bfloat16 (float32 candidates, logistic01), both
    flavours, and K2s, at 196608×10112 and 524288×1024 (K2_SHAPES);
  * K5 with A in bfloat16 (float32 V, multinomial) at 196608×p×16 for p
    = 1024, 512, 256, 128 (K5_PS);
  * K3 (the 'l1' prox, float32) at n in K3_TIMED_NS and K4 (float32, a
    full memory) at TWO_LOOP_TIMED, as chip_smoke.py times them;

and digests (SHA-256 of the output bytes) of K2 (both flavours), K2s
and K5 with A in float32 and in float64 at BIT_SHAPES: the forms this
checkout left alone must give the parent's bits. Only the public
wrappers are called, so any checkout of the port runs. With
``--sweep``, an arm of this checkout also times the design points of
K2's cluster form (cluster size, rows a group, stages: SWEEP_K2), K2s
in the cluster form against its one-pass form, and K5's
bfloat16 form at 1, 2 and 3 blocks an SM, from which the shipped
choices come (PERF.md), and the launch floor. The last line of standard
output is one JSON object with every arm's numbers and the card's name
and power limit; without a CUDA device it exits non-zero.

On one H100 the whole run takes about 3 minutes with both builds.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
K2_SHAPES = ((196608, 10112), (524288, 1024))
K5_M, K5_K = 196608, 16
K5_PS = (1024, 512, 256, 128)
# (m, n) of K2/K2s's and (m, p, k) of K5's same-bits digests, float32
# and float64 (one-pass, wide and tensor-core / two-pass forms)
BIT_SHAPES = {"k2": ((4099, 10112), (1031, 14340), (2049, 1024)),
              "k5": ((3001, 1024, 16), (999, 129, 5), (1031, 77, 17))}
# K2's cluster form: (cluster, rows a group, stages) at each of
# K2_SHAPES; stages None: the most that fit
SWEEP_K2 = {(196608, 10112): ((3, 8, None), (3, 8, 3), (4, 8, None),
                              (4, 8, 4)),
            (524288, 1024): ((1, 16, 3), (1, 16, 4), (1, 8, None),
                             (2, 16, 3), (2, 8, None))}


def smoke():
    """chip_smoke.py of this checkout, as a module (its helpers import the
    port only inside their bodies, so they time whichever port is first
    on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def two_times(cs, fn):
    return {"ms": cs.time_ms(fn), "device_ms": cs.graph_ms(fn)}


def prep_inputs(m, n, dtype, a_dtype, seed):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + m + n)
    A = (torch.randn((m, n), generator=gen, device="cuda", dtype=dtype)
         * 0.1).to(a_dtype)
    y = (torch.rand((m,), generator=gen, device="cuda") < 0.5).to(dtype)
    xt = torch.randn((n,), generator=gen, device="cuda", dtype=dtype) * 0.1
    xd = torch.randn((n,), generator=gen, device="cuda", dtype=dtype) * 0.1
    return A, y, xt, xd


def mglm_inputs(m, p, k, dtype, a_dtype, seed):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + m + p + k)
    A = torch.randn((m, p), generator=gen, device="cuda", dtype=dtype)
    y = torch.nn.functional.one_hot(
        torch.randint(0, k, (m,), generator=gen, device="cuda"), k).to(dtype)
    Z = A @ (torch.randn((p, k), generator=gen, device="cuda", dtype=dtype)
             * 0.3)
    V = torch.randn((p, k), generator=gen, device="cuda", dtype=dtype)
    return A.to(a_dtype), y, Z, V


def digest(tensors) -> str:
    import torch

    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bits(cs):
    """{kernel shape dtype: digest} of the forms left alone."""
    import torch

    from scso_tpu_torch.models.losses import LOGISTIC01_GLM, multinom_mglm
    from scso_tpu_torch.ops.cuda.glm_prep import glm_prep, glm_prep_pair
    from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_matvec

    out = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).replace("torch.", "")
        for m, n in BIT_SHAPES["k2"]:
            A, y, xt, xd = prep_inputs(m, n, dtype, dtype, cs.SEED)
            for fl in ("ggn", "newton"):
                out[f"K2 {fl} {m}x{n} {dn}"] = digest(glm_prep_pair(
                    A, y, xt, xd, LOGISTIC01_GLM, flavour=fl))
            out[f"K2s {m}x{n} {dn}"] = digest(glm_prep(A, y, xt,
                                                       LOGISTIC01_GLM))
        for m, p, k in BIT_SHAPES["k5"]:
            A, y, Z, V = mglm_inputs(m, p, k, dtype, dtype, cs.SEED)
            out[f"K5 {m}x{p}x{k} {dn}"] = digest(
                [mglm_matvec(A, y, Z, V, multinom_mglm(k))])
    return out


def sweep(cs):
    """K2's cluster-form design points, K2s's forms and K5's blocks an SM
    (this checkout only: private grids)."""
    import torch

    from scso_tpu_torch.models.losses import LOGISTIC01_GLM, multinom_mglm
    from scso_tpu_torch.ops.cuda import glm_prep as k2
    from scso_tpu_torch.ops.cuda import mglm_matvec as k5

    out = {"k2": {}, "k2s": {}, "k5": {}}
    for (m, n), points in SWEEP_K2.items():
        A, y, xt, xd = prep_inputs(m, n, torch.float32, torch.bfloat16,
                                   cs.SEED)
        for c, r, s in points:
            g = k2.cluster_grid(m, n, 2, 132, cluster=c, group_rows=r,
                                stages=s)
            if g.smem_bytes > 224 * 1024 or g.threads > 512:
                continue
            g = k2.cluster_grid(
                m, n, 2, 132, cluster=c, group_rows=r, stages=s,
                fit=lambda c_, th, sm, r_: k2._clusters_fit(
                    0, 2, r_, c_, th, sm))
            key = f"{m}x{n} C={c} R={r} S={g.stages}"
            out["k2"][key] = dict(two_times(cs, lambda: k2._pair(
                A, y, xt, xd, LOGISTIC01_GLM, m, "ggn", g)),
                clusters=g.blocks, threads=g.threads, smem=g.smem_bytes)
        # K2s: its one-pass form against the cluster form
        one = k2.one_pass_grid(m, n, torch.float32, 1, 132, torch.bfloat16)
        cl = k2.cluster_grid(m, n, 1, 132, fit=lambda c_, th, sm, r_: (
            k2._clusters_fit(0, 1, r_, c_, th, sm)))
        for name, g in (("one_pass", one), ("cluster", cl)):
            out["k2s"][f"{m}x{n} {name}"] = two_times(
                cs, lambda: k2._single(A, y, xt, LOGISTIC01_GLM, m, g))
        del A
        torch.cuda.empty_cache()
    for p in K5_PS:
        A, y, Z, V = mglm_inputs(K5_M, p, K5_K, torch.float32,
                                 torch.bfloat16, cs.SEED)
        spec = multinom_mglm(K5_K)
        base = k5.mglm_grid(K5_M, p, K5_K, torch.float32, 132,
                            a_dtype=torch.bfloat16)
        for per_sm in (1, 2, 3):
            if (per_sm * (base.smem_bytes + 2048) > 228 * 1024
                    or per_sm > k5.tc_blocks_per_sm(p, K5_K) + 1):
                continue
            rows = 16 * -(-K5_M // (16 * 132 * per_sm))
            g = base._replace(blocks=-(-K5_M // rows), rows_per_block=rows)
            try:
                out["k5"][f"p={p} blocks/SM={per_sm}"] = two_times(
                    cs, lambda: k5._launch(A, y, Z, V, spec, g))
            except RuntimeError as e:  # more blocks than its registers
                out["k5"][f"p={p} blocks/SM={per_sm}"] = str(e)
        del A
        torch.cuda.empty_cache()
    out["floor"] = {k: dict(zip(("ms", "device_ms", "host_ms"), v))
                    for k, v in cs.launch_floor().items()}
    return out


def arm(root: str, with_sweep: bool) -> dict:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_ab.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = smoke()
    from scso_tpu_torch.models.losses import LOGISTIC01_GLM, multinom_mglm
    from scso_tpu_torch.ops.cuda import build
    from scso_tpu_torch.ops.cuda.glm_prep import glm_prep, glm_prep_pair
    from scso_tpu_torch.ops.cuda.mglm_matvec import mglm_matvec
    from scso_tpu_torch.ops.cuda.score_update import score_update
    from scso_tpu_torch.ops.cuda.two_loop import two_loop

    build.load()
    out = {"root": root, "k2_bf16": {}, "k5_bf16": {}, "k3": {}, "k4": {}}
    for m, n in K2_SHAPES:
        A, y, xt, xd = prep_inputs(m, n, torch.float32, torch.bfloat16,
                                   cs.SEED)
        for fl in ("ggn", "newton"):
            out["k2_bf16"][f"K2 {fl} {m}x{n}"] = two_times(
                cs, lambda: glm_prep_pair(A, y, xt, xd, LOGISTIC01_GLM,
                                          flavour=fl))
        out["k2_bf16"][f"K2s {m}x{n}"] = two_times(
            cs, lambda: glm_prep(A, y, xt, LOGISTIC01_GLM))
        del A
        torch.cuda.empty_cache()
    for p in K5_PS:
        A, y, Z, V = mglm_inputs(K5_M, p, K5_K, torch.float32,
                                 torch.bfloat16, cs.SEED)
        spec = multinom_mglm(K5_K)
        out["k5_bf16"][f"{K5_M}x{p}x{K5_K}"] = two_times(
            cs, lambda: mglm_matvec(A, y, Z, V, spec))
        del A
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for n in cs.K3_TIMED_NS:
        args = cs.score_update_inputs(n, "l1", torch.float32, gen)
        out["k3"][n] = two_times(cs, lambda: score_update(*args))
    for n, m in cs.TWO_LOOP_TIMED:
        mem, g = cs.two_loop_inputs(n, m, m + 3, torch.float32, gen)
        out["k4"][f"{n}x{m}"] = two_times(cs, lambda: two_loop(mem, g))
    out["bits"] = bits(cs)
    if with_sweep and os.path.samefile(root, HERE):
        out["sweep"] = sweep(cs)
    return out


def run(cmd) -> str:
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    sys.stderr.write(p.stderr)
    if p.returncode != 0:
        sys.exit(f"chip_ab.py: {' '.join(cmd)} failed ({p.returncode})")
    return p.stdout


def show(res):
    """One line an arm: ms a call / device ms."""
    parts = [f"{k} {v['ms']:.4f}/{v['device_ms']:.4f}"
             for group in ("k2_bf16", "k5_bf16") for k, v in res[group].items()]
    parts += [f"K3 n={n} {v['ms']:.4f}/{v['device_ms']:.4f}"
              for n, v in res["k3"].items()]
    parts += [f"K4 {s} {v['ms']:.4f}/{v['device_ms']:.4f}"
              for s, v in res["k4"].items()]
    return f"{res['arm']}: " + ", ".join(parts) + " ms (per call/device)"


def main():
    if sys.argv[1:2] == ["--arm"]:
        print(json.dumps(arm(sys.argv[2], "--sweep" in sys.argv[3:])),
              flush=True)
        return
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    if len(args) != 1 or not os.path.isdir(
            os.path.join(args[0], "scso_tpu_torch")):
        sys.exit(__doc__)
    base = os.path.abspath(args[0])
    with_sweep = "--sweep" in sys.argv[1:]
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
    for i, root in enumerate((base, HERE, HERE, base)):
        cmd = [sys.executable, os.path.abspath(__file__), "--arm", root]
        if with_sweep and i == 1:
            cmd.append("--sweep")
        res = json.loads(run(cmd).strip().splitlines()[-1])
        res["arm"] = "base" if root == base else "head"
        arms.append(res)
        print(show(res), flush=True)
    same = {k: len({a["bits"].get(k) for a in arms}) == 1
            for k in arms[0]["bits"]}
    print("same bits as BASE: " + ("all " + str(len(same)) if all(
        same.values()) else str([k for k, v in same.items() if not v])),
          flush=True)
    if with_sweep:
        print("sweep: " + json.dumps(arms[1]["sweep"]), flush=True)
    print(json.dumps({"card": card, "same_bits": same, "arms": arms}))


if __name__ == "__main__":
    main()
