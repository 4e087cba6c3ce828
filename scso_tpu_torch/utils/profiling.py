"""Profiling and observability (port of `scso_tpu.utils.profiling`).

  * `trace_phase` / `profile_to` — a named range in the profiler's
    timeline (``torch.profiler.record_function``, and an NVTX range
    where there is a card), and one-call trace capture
    (``torch.profiler.profile``, CPU and CUDA activities, written as a
    Chrome trace);
  * `PhaseTimer` — accumulating named wall-clock phases; with
    ``block=True`` a phase given a CUDA ``sync_value`` waits for its
    card before it reads the clock (kernels launch asynchronously, and
    would otherwise bill their time to whoever waits next);
  * `device_memory_stats` — live and peak bytes of the caching
    allocator on one card;
  * `profile_solve` — a solve in timed mode with its per-epoch wall
    times, CG totals and device memory, optionally traced.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from scso_tpu_torch.problems import resolve_device


@contextlib.contextmanager
def trace_phase(name: str):
    """Annotate a host-side phase in the profiler timeline (and, where
    there is a card, as an NVTX range)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a trace of the host and, where there is a card, of its
    kernels; on exit it is written into ``logdir`` as a Chrome trace
    (``trace_<ns>.json``: Perfetto or chrome://tracing). Yields the
    ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def _cuda_device(value):
    """The card of the first CUDA tensor in ``value`` (a tensor or a
    nest of tuples, lists and dicts of them), else None."""
    if isinstance(value, torch.Tensor):
        return value.device if value.device.type == "cuda" else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> pt = PhaseTimer()
    >>> with pt.phase("grad", sync_value=g):   # doctest: +SKIP
    ...     g = grad_fn(x)
    >>> pt.totals()["grad"]                     # doctest: +SKIP

    With ``block=True`` (default) a phase given a ``sync_value`` that
    holds a CUDA tensor calls ``torch.cuda.synchronize`` on that card
    before it reads the clock, so the phase ends after its kernels."""

    def __init__(self, block: bool = True):
        self.block = block
        self._acc: dict = {}
        self._counts: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        with trace_phase(name):
            yield
        dev = _cuda_device(sync_value) if self.block else None
        if dev is not None:
            torch.cuda.synchronize(dev)
        self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> dict:
        return dict(self._acc)

    def means(self) -> dict:
        return {k: v / self._counts[k] for k, v in self._acc.items()}

    def report(self) -> str:
        lines = ["phase                 total_s    calls   mean_ms"]
        for k in sorted(self._acc, key=self._acc.get, reverse=True):
            t, c = self._acc[k], self._counts[k]
            lines.append(f"{k:20s} {t:9.4f} {c:8d} {t/c*1e3:9.3f}")
        return "\n".join(lines)


def device_memory_stats(device=None) -> dict:
    """Live and peak bytes on one card (default: the current one), under
    the JAX package's keys: ``bytes_in_use`` and ``peak_bytes_in_use``
    (the caching allocator's allocated bytes, now and at their peak
    since the last ``torch.cuda.reset_peak_memory_stats``) and
    ``bytes_limit`` (the card's memory). ``largest_alloc_size`` has no
    counterpart in PyTorch's statistics and is left out, as the JAX
    function leaves out what a device lacks. ``{}`` for a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    out = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
           "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
           "bytes_limit": int(total)}
    return {k: int(v) for k, v in out.items() if v is not None}


def profile_solve(method, prob, reg_name: str, sm, *,
                  trace_dir: Optional[str] = None, **iterate_kwargs):
    """Run `iterate` in timed mode and return (solution, profile dict).

    The profile dict has the JAX package's keys: the total time, the
    epochs, per-epoch wall times (``epoch_times_s``) and their deltas,
    the CG total and the device memory before and after. Pass
    ``trace_dir`` to also write a trace of the run (`profile_to`).

    On the card timed mode replays a captured step, whose CG loop is a
    WHILE node of the graph: a replayed conditional node hides its
    kernel launches from the trace. So the solve runs in the eager form
    (``_capture=False``), which gives the same bits, and the trace
    holds every launch of the solve's kernels (K1, K2s and K3 on a
    GGN-CG problem with a GLM spec: timed mode runs off the epoch
    cache, as in the JAX package)."""
    from scso_tpu_torch.algorithms.iterate import iterate

    iterate_kwargs.setdefault("verbose", 0)
    iterate_kwargs["mode"] = "timed"
    iterate_kwargs.setdefault("_capture", False)
    dev = prob.device
    mem_before = device_memory_stats(dev)
    ctx = profile_to(trace_dir) if trace_dir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        sol = iterate(method, prob, reg_name, sm, **iterate_kwargs)
    total = time.perf_counter() - t0
    times = [float(t) for t in sol.times]
    deltas = [b - a for a, b in zip(times, times[1:])]
    prof = {
        "total_s": total,
        "epochs": sol.epochs,
        "epoch_times_s": times,
        "epoch_deltas_s": deltas,
        "mean_epoch_s": (sum(deltas) / len(deltas)) if deltas else None,
        "total_cg_iters": (sol.cg_info or {}).get("total_cg_iters"),
        "memory_before": mem_before,
        "memory_after": device_memory_stats(dev),
        "trace_dir": trace_dir,
    }
    return sol, prof
