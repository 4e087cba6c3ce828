"""One launcher for the port's multi-rank tests (`scso_tpu_torch` over
torch.distributed/gloo on the CPU).

The ranks meet at a ``file://`` rendezvous in the test's own temporary
directory: there is no port number to pick, so two tests (or two xdist
workers) launching ranks at the same time cannot take each other's
rendezvous. Each rank writes its output to a log file of its own (never
a pipe that nobody reads while another rank is waited for), and a rank
that fails or runs out of time shows that log in the assertion.

A worker rank is the test file itself, run as a script:
``python FILE INIT_METHOD RANK WORLD WORKDIR [PART]``; it passes
INIT_METHOD to `parallel.distributed_init` as it is, and saves its
results to `result_path`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def file_init(workdir, name: str = "group") -> str:
    """A ``file://`` init_method for one process group: a new file in
    ``workdir`` (the file may not be left over from another group)."""
    path = os.path.join(str(workdir), f"{name}.rendezvous")
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def _tail(path: str, limit: int = 20000) -> str:
    try:
        with open(path, errors="replace") as f:
            text = f.read()
    except OSError as e:
        return f"<no output: {e}>"
    return text if len(text) <= limit else "...\n" + text[-limit:]


#: the ranks compute on one thread each (torch's own pool is set to one
#: thread in the workers): no BLAS or OpenMP pool of their own either
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


def _job(job):
    """(world, part, name) of a job: a world size, or (world size, part)
    where ``part`` names the share of the worker's cases it runs."""
    world, part = (job, None) if isinstance(job, int) else job
    return world, part, str(world) if part is None else f"{world}.{part}"


def launch(script: str, jobs, workdir, timeout: float = 300) -> None:
    """Run ``script``'s worker ranks for each job of ``jobs``: a world
    size, or (world size, part) — then the workers also get ``part`` as
    their last argument and run that share of their cases. The jobs run
    one after the other, each on a rendezvous of its own and given at
    most ``timeout`` seconds from its launch. Raises AssertionError with
    the output of every rank that failed or was still running at its
    job's deadline (those are killed); a job that failed stops the
    launch.

    The ranks' time is mostly the latency of their gloo collectives,
    which grows with the load on the machine: one job at a time, and one
    thread a rank, keep this launch's own processes from adding to it."""
    workdir = str(workdir)
    env = dict(os.environ, PYTHONPATH=ROOT, **_ONE_THREAD)
    procs, late = [], []
    for job in jobs:
        world, part, name = _job(job)
        init = file_init(workdir, f"world{name}")
        extra = [] if part is None else [part]
        ranks = []
        for r in range(world):
            log = os.path.join(workdir, f"rank{r}_of{name}.log")
            with open(log, "w") as out:
                p = subprocess.Popen(
                    [sys.executable, os.path.abspath(script), init, str(r),
                     str(world), workdir, *extra], stdout=out,
                    stderr=subprocess.STDOUT, cwd=ROOT, env=env)
            ranks.append((name, r, p, log))
        procs += ranks
        deadline = time.monotonic() + timeout
        try:
            for _, r, p, _ in ranks:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    late.append((name, r))
        finally:
            for _, _, p, _ in ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if late or any(p.returncode != 0 for _, _, p, _ in ranks):
            break
    bad = [(name, r, p, log) for name, r, p, log in procs
           if (name, r) in late or p.returncode != 0]
    if bad:
        report = []
        for name, r, p, log in bad:
            what = (f"still running {timeout:.0f} s after its launch "
                    "(killed)"
                    if (name, r) in late else
                    f"failed with exit code {p.returncode}")
            report.append(f"rank {r} of job {name} {what}:\n{_tail(log)}")
        raise AssertionError("\n\n".join(report))


def result_path(workdir, rank: int, world: int, part=None) -> str:
    """Where a worker rank saves its results (``np.savez``)."""
    name = str(world) if part is None else f"{world}.{part}"
    return os.path.join(str(workdir), f"rank{rank}_of{name}.npz")


def saved(workdir, world: int, parts=(None,)) -> list:
    """The results each rank of ``world`` saved (`result_path`), by rank:
    one dict a rank, the parts' saves merged."""
    import numpy as np

    out = []
    for r in range(world):
        merged = {}
        for part in parts:
            merged.update(np.load(result_path(workdir, r, world, part)))
        out.append(merged)
    return out
