"""Numeric sanitizers and failure recovery (port of
`scso_tpu.utils.debug`): ``sanitize`` and ``solve_with_recovery``."""

from __future__ import annotations

import contextlib

import torch

from scso_tpu_torch.ops import nancheck


@contextlib.contextmanager
def sanitize(nans: bool = True, disable_jit: bool = False):
    """Run solves under the port's numeric sanitizers; both settings are
    restored on exit, also when nested (an inner ``sanitize`` sets its
    own for its extent).

    ``disable_jit=True`` runs every solve in its eager form
    (``iterate(..., _capture=False)``: the captured CUDA graphs' bodies
    op by op, each loop predicate read on the host; `graph.eager`), the
    port's counterpart of running op by op. It gives the captured
    solve's bits.

    ``nans=True`` raises FloatingPointError, naming the operation, at
    the first NaN that a computation produces: a NaN in an op's outputs
    where none of its inputs held one. It checks every ATen op (a
    ``TorchDispatchMode``) and every output of the CUDA kernels K1–K5,
    whose ctypes launches bypass the dispatcher (each wrapper checks its
    outputs). A check reads the card from the host, which a capture
    refuses, so ``nans=True`` runs every solve in the eager form too.

    Where the port departs from the reference: the solve carries
    deliberate NaN sentinels (``bnorm_prev`` and ``pri_res`` of the
    fresh carry, the ``prires`` history's fill, the CG forcing
    reference until it is set). They are made with a NaN fill and
    passed on, never produced, so a healthy solve completes here;
    under the JAX package's ``sanitize(nans=True)`` (jax_debug_nans)
    the same sentinels make a healthy GGN-CG solve raise
    FloatingPointError. A loss that really returns NaN raises in both
    (`ops.nancheck`)."""
    old = dict(nancheck.SETTINGS)
    nancheck.SETTINGS.update(nans=bool(nans), disable_jit=bool(disable_jit))
    try:
        with nancheck.NanCheck() if nans else contextlib.nullcontext():
            yield
    finally:
        nancheck.SETTINGS.update(old)


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
