"""Failure recovery (port of `scso_tpu.utils.debug.solve_with_recovery`).

The JAX package's numeric sanitizers (``sanitize``: jax_debug_nans) are
not ported (ROADMAP A12).
"""

from __future__ import annotations

import torch


def solve_with_recovery(method, model, reg_name, h_mu, *, chunk_epochs=50,
                        max_chunks=20, retries=2, on_nan="restart",
                        fault_inject=None, **kwargs):
    """A solve in chunks of ``chunk_epochs`` epochs, each resumed from the
    last good state (``Solution.state``: the whole carry), so that a
    recovered run gives the bits of an uninterrupted one.

    A chunk that raises RuntimeError or FloatingPointError, or (with
    ``on_nan='restart'``) ends at a non-finite iterate, is run again from
    the last good state, up to ``retries`` times; a failure that repeats
    from the same state is raised. ``fault_inject(chunk, attempt)``,
    called before each attempt, may raise RuntimeError to simulate a
    transient fault."""
    from scso_tpu_torch.algorithms.iterate import iterate

    kwargs.pop("max_epoch", None)
    kwargs.pop("resume_state", None)
    state = sol = None
    for chunk in range(max_chunks):
        cap = (chunk + 1) * chunk_epochs
        attempt = 0
        while True:
            try:
                if fault_inject is not None:
                    fault_inject(chunk, attempt)
                s = iterate(method, model, reg_name, h_mu, max_epoch=cap,
                            resume_state=state, **kwargs)
                if on_nan == "restart" and not bool(
                        torch.isfinite(s.x).all()):
                    raise FloatingPointError("non-finite iterate")
                break
            except (FloatingPointError, RuntimeError):
                attempt += 1
                if attempt > retries:
                    raise
        sol = s
        state = s.state  # the last good carry (epochs are cumulative)
        if s.epochs < cap:  # converged inside the chunk
            break
    return sol
