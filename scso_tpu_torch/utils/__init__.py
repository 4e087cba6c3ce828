"""Utilities: the carry of arrays from the JAX package (`convert`),
checkpoints of the solver state, metrics and data helpers, numeric
sanitizers and failure recovery, profiling, and serving and export."""

from scso_tpu_torch.utils.checkpoint import (
    load_state, save_state, solution_to_state)
from scso_tpu_torch.utils.debug import sanitize, solve_with_recovery
from scso_tpu_torch.utils.deploy import (
    export_solver, load_solver, make_serving_fn)
from scso_tpu_torch.utils.metrics import (
    batch_iter, mean_square_error, slice_data)
from scso_tpu_torch.utils.profiling import (
    PhaseTimer, device_memory_stats, profile_solve, profile_to, trace_phase)

__all__ = [
    "sanitize",
    "solve_with_recovery",
    "trace_phase",
    "profile_to",
    "PhaseTimer",
    "device_memory_stats",
    "profile_solve",
    "make_serving_fn",
    "export_solver",
    "load_solver",
    "mean_square_error",
    "slice_data",
    "batch_iter",
    "save_state",
    "load_state",
    "solution_to_state",
]
