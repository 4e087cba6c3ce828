"""The numeric sanitizer's state and checks (`utils.debug.sanitize`).

The JAX package's ``sanitize`` switches on ``jax_debug_nans`` (every
jitted computation's outputs are checked, the first NaN raises) and
``jax_disable_jit`` (op by op). The port's counterparts:

  * ``disable_jit``: every solve runs its eager form, as the private
    ``iterate(..., _capture=False)`` does — the captured CUDA graphs'
    bodies run op by op on the card, each loop predicate read on the
    host (`graph.eager`). :func:`uncaptured` tells the solve loops.
  * ``nans``: every ATen op's floating outputs are checked
    (:class:`NanCheck`, a ``TorchDispatchMode``), and so is every
    output of a CUDA kernel wrapper (K1–K5 launch through ctypes, past
    the dispatcher: each wrapper calls :func:`check` after its launch).
    A check reads the card from the host, which a capture refuses, so
    ``nans`` forces the eager form too, and nothing is checked while a
    graph is being captured.

What raises is a NaN that an operation produces: a NaN in its outputs
where none of its inputs (tensors or numbers) held one. A NaN carried in
is not a new one. This is where the port departs from the reference:
the solve's state holds deliberate NaN sentinels (the carry's
``bnorm_prev`` and ``pri_res`` before the first step, the ``prires``
history's fill, the CG forcing reference until it is set), made with a
NaN fill and passed on by the ops that read them, so a healthy solve
completes under ``nans=True``; under the JAX package's jax_debug_nans
the same sentinels raise FloatingPointError in a healthy GGN-CG solve.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: what `utils.debug.sanitize` set: the NaN check, and the eager form of
#: every solve (the JAX package's jax_debug_nans and jax_disable_jit)
SETTINGS = {"nans": False, "disable_jit": False}


def uncaptured() -> bool:
    """True where every solve must run its eager form: under
    ``sanitize(disable_jit=True)``, and under ``nans=True``, whose
    checks read the card from the host."""
    return SETTINGS["nans"] or SETTINGS["disable_jit"]


def _has_nan(value) -> bool:
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point() or value.numel() == 0:
            return False
        # forward-mode autograd (the Hessian's jvp) passes zero tensors
        # that have no storage to read: they hold no NaN
        if value.device.type == "meta" or value._is_zerotensor():
            return False
        return bool(torch.isnan(value).any())
    return isinstance(value, float) and math.isnan(value)


def _any_nan(tree) -> bool:
    return any(_has_nan(t) for t in tree_leaves(tree))


def _checking() -> bool:
    return SETTINGS["nans"] and not (
        torch.cuda.is_available()
        and torch.cuda.is_current_stream_capturing())


def _raise(name: str):
    raise FloatingPointError(f"invalid value (nan) encountered in {name}")


def check(name: str, outputs, inputs=()) -> None:
    """Raise FloatingPointError naming ``name`` where ``outputs`` (a
    tensor or a nest of them) hold a NaN and ``inputs`` held none; a
    no-op unless sanitizing. The kernel wrappers call it after a
    launch (their outputs are new tensors)."""
    if _checking() and _any_nan(outputs) and not _any_nan(inputs):
        _raise(name)


#: ops whose outputs are uninitialized memory (on the card it may hold
#: any bit pattern, NaN included): not computed, so not checked
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided", "resize_"})


class NanCheck(TorchDispatchMode):
    """Checks every ATen op's outputs while ``SETTINGS['nans']`` holds,
    the op's name in the error. An op that writes its inputs (in place,
    ``out=``) has them checked before it runs; an op that allocates
    without writing (`_UNINITIALIZED`) is not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (not _checking()
                or func.overloadpacket.__name__ in _UNINITIALIZED):
            return func(*args, **kwargs)
        mutable = func._schema.is_mutable
        carried = _any_nan((args, kwargs)) if mutable else None
        out = func(*args, **kwargs)
        if _any_nan(out):
            if not mutable:
                carried = _any_nan((args, kwargs))
            if not carried:
                _raise(str(func.overloadpacket.__name__))
        return out
