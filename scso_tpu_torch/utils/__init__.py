"""Utilities: the carry of arrays from the JAX package (`convert`),
checkpoints of the solver state, metrics and data helpers, and failure
recovery."""

from scso_tpu_torch.utils.checkpoint import (
    load_state, save_state, solution_to_state)
from scso_tpu_torch.utils.debug import solve_with_recovery
from scso_tpu_torch.utils.metrics import (
    batch_iter, mean_square_error, slice_data)

__all__ = [
    "solve_with_recovery",
    "mean_square_error",
    "slice_data",
    "batch_iter",
    "save_state",
    "load_state",
    "solution_to_state",
]
