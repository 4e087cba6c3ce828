"""Checkpoint and resume of the solver state.

Port of `scso_tpu.utils.checkpoint`'s ``.npz`` format. A solve's whole
state is a tree of tensors — ``Solution.state``, the loop's carry
(`algorithms.iterate.Carry`: the iterate, gradient caches, CG warm start,
L-BFGS memory, epoch cache, histories and the generator of the
mini-batch permutations) — and ``iterate(..., resume_state=state)``
continues it bit for bit as the uninterrupted solve would.
:func:`save_state` writes such a tree to one ``.npz`` file, each leaf a
numpy array, with the tree's structure beside them; :func:`load_state`
reads it back, onto a template tree's structure and devices. The JAX
package's orbax functions have no PyTorch counterpart and are not
ported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_SEP = "__leaf__"

#: dtypes numpy cannot hold, stored as their bits
_VIEWS = {torch.bfloat16: torch.int16}


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` (tensors, arrays, numbers) to
    ``leaves`` in order; return the tree's structure as a string."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ",".join(f"{f}={_flatten(getattr(tree, f), leaves)}"
                         for f in tree._fields)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(t, leaves) for t in tree)
        return f"{type(tree).__name__}[{inner}]"
    if isinstance(tree, dict):
        inner = ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                         for k in sorted(tree))
        return f"dict{{{inner}}}"
    leaves.append(tree)
    return "*"


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves taken from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    leaf = leaves.pop(0)
    if isinstance(template, torch.Tensor):
        return leaf.to(template.device)
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf


def _to_numpy(leaf):
    """(array, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype in _VIEWS:
            t = t.view(_VIEWS[t.dtype])
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, "numpy:" + a.dtype.str


def save_state(path: str, tree) -> None:
    """Write a tree of tensors (NamedTuples, tuples, lists, dicts, None
    and leaves) to ``path`` (.npz)."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    arrays, kinds = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"{_SEP}{i}"], kind = _to_numpy(leaf)
        kinds.append(kind)
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    arrays["__kinds__"] = np.frombuffer("\n".join(kinds).encode(),
                                        dtype=np.uint8)
    np.savez(path, **arrays)


def _leaf(array: np.ndarray, kind: str):
    if kind.startswith("numpy:"):
        return array
    dtype = getattr(torch, kind)
    t = torch.from_numpy(np.array(array))
    return t.view(dtype) if dtype in _VIEWS else t.to(dtype)


def load_state(path: str, template: Any = None):
    """Read a tree written by :func:`save_state`.

    With ``template`` (e.g. a ``Solution.state`` of the same solve, or
    one of a solve of the same method and problem shapes) the leaves are
    put into its structure, each tensor on the device of the template's
    leaf; a structure other than the template's raises. Without, returns
    the flat list of leaves (tensors on the CPU)."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith(_SEP))
        kinds = bytes(data["__kinds__"]).decode().split("\n") if n else []
        leaves = [_leaf(data[f"{_SEP}{i}"], kinds[i]) for i in range(n)]
        stored = bytes(data["__treedef__"]).decode()
    if template is None:
        return leaves
    t_leaves: list = []
    structure = _flatten(template, t_leaves)
    if len(t_leaves) != len(leaves):
        raise ValueError(f"the checkpoint has {len(leaves)} leaves, the "
                         f"template {len(t_leaves)}")
    if structure != stored:
        raise ValueError("the checkpoint's structure is not the "
                         f"template's:\n  stored:   {stored}\n"
                         f"  template: {structure}")
    return _unflatten(template, leaves)


def solution_to_state(sol):
    """The resumable state of a Solution (``sol.state``: pass it to
    ``iterate(..., resume_state=...)``), or, for a Solution without one,
    a summary usable as a warm start (``x0=state['x']``)."""
    if getattr(sol, "state", None) is not None:
        return sol.state
    return {"x": np.asarray(sol.x.cpu()), "epochs": np.asarray(sol.epochs),
            "obj": np.asarray(sol.obj), "fval": np.asarray(sol.fval)}
