"""Serving and export of a solver (port of `scso_tpu.utils.deploy`).

``make_serving_fn`` returns the arrays-only solve

    serve(A, y, x0) -> (x, epochs, final_objective)

with the method, regularizer, smoother, options and everything of the
problem but its data baked in from a template problem. On the card the
first call captures the fused solve into a CUDA graph and every later
call of the same shapes only replays it: the closure keeps its own
static A, y and x0 tensors, copies each call's data into them, and the
capture cache keys problem data by identity (`iterate._capture_key`).
What the problem derives from A is derived again from each call's data:
the feature padding, a bfloat16 copy of A (``with_lp_copy``, or AUTO's,
``ProxGGNSCORE.auto_lp``), diag(AᵀA) (``with_col_sumsq``), and the
epoch cache primed at x0 (each solve primes it), so a served solve
gives the bits of ``iterate`` on a problem built from the same data.

``export_solver`` writes the JAX package's counterpart of its
StableHLO artifact: a ``torch.export`` program of the whole fused solve,
``serve(A, y, x0) -> (x, epochs, final_objective)`` for the template's
shapes and dtypes, with the method, regularizer, smoother, options and
every tensor of the problem but its data baked in. The solve's loops are
the program's higher-order ops (``while_loop``, ``cond``:
`ops.cuda.graph`'s export forms of the loops a captured solve runs as
conditional nodes), and what the problem derives from its data (AUTO's
or ``with_lp_copy``'s bfloat16 copy of A, diag(AᵀA), the epoch cache
primed at x0) is derived again inside the program from the call's A, y
and x0. Functions are traced, so a callable the user wrote exports as
the losses of `scso_tpu_torch.models.losses` do, with its derivative
hooks (``grad_fx``, and ``hess_fx`` for a dense Newton step):
``torch.func``'s derivatives of f do not trace under ``torch.export``
(torch 2.11 to 2.13). On the card the
program holds K1–K5 as the custom ops ``torch.ops.scso.*``
(``csrc/ops.cpp``), and the artifact carries their library, built from
this checkout's sources (`ops.cuda.build`), base64-encoded as its extra
file ``scso_ops.so.b64``; a CPU artifact holds ATen ops alone. Data
comes at the template's padded width (``load_solver``'s callable also
pads an unpadded one) and x goes out at ``n_true`` columns.

Loading needs torch alone, not scso_tpu_torch (``load_solver`` does the
same)::

    import base64, io, os, tempfile, zipfile, torch

    blob = open("solver.pt2", "rb").read()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:      # card artifacts:
        lib = [n for n in z.namelist()                # the op library
               if n.endswith("extra/scso_ops.so.b64")]
        if lib:
            path = os.path.join(tempfile.mkdtemp(), "libscso_ops.so")
            with open(path, "wb") as f:
                f.write(base64.b64decode(z.read(lib[0])))
            torch.ops.load_library(path)
    serve = torch.export.load(io.BytesIO(blob)).module()
    x, epochs, obj = serve(A, y, x0)

The loaded program runs each ``while_loop`` and ``cond`` from Python,
reading its predicate on the host (PyTorch runs higher-order ops
eagerly), so it is slower than ``make_serving_fn``'s replay of the
captured solve, the fast path inside a process.

A mini-batch solve's program takes each epoch's permutation of the rows
as data, a ``(max_epoch, m)`` int64 tensor: the loaded callable keeps
the signature ``(A, y, x0)`` and draws them on the host as ``iterate``
does, ``np.random.default_rng(seed).permutation(m)`` once an epoch (the
seed in the metadata, ``iterate``'s default 0; ``np.arange(m)`` every
epoch without shuffling), so a loader needs numpy alone for them.

A sharded problem is served on every rank of its mesh, SPMD: each rank
calls the closure with its own rows (the template's row and column
blocks) and the replicated x0, and gets the replicated x. A problem
row-sharded over its mesh's data axis also exports: the program holds
the sums over the ranks as functional collectives
(``_c10d_functional.all_reduce``, `ops.collective.sum_in_place`), which
name their process group by its ``group_name``, the order in which the
process's groups were made ("0" the default group, then "1", "2", …
for each ``new_group``). The artifact records the world size, the
mesh's shape and axis names and its groups' names and ranks; every rank
of a group of that size loads the same bytes and runs them on its own
rows, and ``load_solver`` raises ValueError where the process's groups
do not match (it never solves one rank's rows alone). A torch-only
process makes matching groups as `parallel.make_mesh` does: the
default group, then for a mesh of several axes one ``new_group`` an
axis line, axis by axis, lines in rank-major order. A column shard
(``shard_problem_features``) is served but not exported (ROADMAP A12):
its gathers place this rank's block at the rank's offset, which the
program would hold as a constant; nor is a mini-batch solve of a row
shard (each rank's rows of a batch are worked out on the host).
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import io
import json
import os
import zipfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.iterate import (
    Options, _auto_lp, _make_batches, _resolve_kernels, solve,
    solve_program)
from scso_tpu_torch.ops.cuda import build, graph, launch
from scso_tpu_torch.ops.dense import is_colshard
from scso_tpu_torch.problems import Problem, with_col_sumsq

#: the artifact's extra files: what it was exported for, and (card
#: artifacts) the op library, base64-encoded
META_FILE = "scso_solver.json"
OPS_FILE = "scso_ops.so.b64"
FORMAT = "scso_tpu_torch.solver"
FORMAT_VERSION = 3


def _block(t):
    """A tensor, or a column shard's block of it."""
    return t.block if is_colshard(t) else t


def _template(prob: Problem) -> Problem:
    """``prob`` on static data tensors of its own (A, y, x0 and what is
    derived from A; a column shard's blocks), which each call of the
    serving function fills. The mesh and the row counts over all ranks
    (``m_total``, ``mtest_total``) stay the problem's."""
    def like(t):
        if t is None:
            return None
        if is_colshard(t):
            return t.with_block(torch.zeros_like(t.block))
        return torch.zeros_like(t)

    return dc_replace(prob, A=like(prob.A), y=like(prob.y),
                      x0=like(prob.x0), A_lp=like(prob.A_lp),
                      col_sumsq=like(prob.col_sumsq))


def _fill(dst, src, n_true: Optional[int], name: str):
    """Copy ``src`` into the static ``dst``: at dst's width, or at the
    unpadded ``n_true`` columns, the padded ones set to 0. A column
    shard takes this rank's block (or a column shard of it) at the
    block's shape."""
    if is_colshard(dst):
        dst, n_true = dst.block, None
    src = torch.as_tensor(_block(src))
    if tuple(src.shape) == tuple(dst.shape):
        dst.copy_(src)
        return
    if (n_true is not None and src.shape[:-1] == dst.shape[:-1]
            and src.shape[-1] == n_true):
        dst[..., :n_true].copy_(src)
        dst[..., n_true:].zero_()
        return
    raise ValueError(f"serve: {name} has shape {tuple(src.shape)}, the "
                     f"served problem's is {tuple(dst.shape)}"
                     + (f" (or {n_true} columns unpadded)"
                        if n_true is not None else ""))


def _serving_fn(method, tpl: Problem, reg_name: str, sm, opts: Options):
    """The serving function on ``tpl``, whose A, y and x0 (and derived
    tensors) it owns and fills at each call."""
    method = _resolve_kernels(method, tpl)
    # AUTO's bfloat16 copy, if it applies, is attached once (a static
    # tensor, refilled from A at each call)
    method, tpl = _auto_lp(method, tpl, reg_name, opts)
    plain = dc_replace(tpl, col_sumsq=None)

    def serve(A, y, x0):
        _fill(tpl.A, A, tpl.n_true, "A")
        _fill(tpl.y, y, None, "y")
        _fill(tpl.x0, x0, tpl.n_true, "x0")
        if tpl.A_lp is not None:
            _block(tpl.A_lp).copy_(_block(tpl.A))
        if tpl.col_sumsq is not None:
            tpl.col_sumsq.copy_(with_col_sumsq(plain).col_sumsq)
        sol = solve(method, tpl, reg_name, sm, opts)
        return sol.x, sol.state.k, sol.obj[-1]

    return serve


def make_serving_fn(method, prob: Problem, reg_name: str, sm,
                    opts: Optional[Options] = None):
    """The arrays-only solve closure ``(A, y, x0) -> (x, epochs, obj)``.

    Everything but the data triplet — the method, λ, bounds, groups,
    smoother, tolerances — is baked in from the template problem; the
    closure solves on its own copies of A, y and x0 (``prob``'s are
    never written). ``A`` and ``x0`` may come at the problem's padded
    width or at ``n_true`` columns (then padded with zeros, as
    ``make_problem(pad_features=True)`` does); numpy arrays and tensors
    on any device are accepted. ``x`` is sliced back to ``n_true`` as
    in ``Solution.x``; ``epochs`` is the solve's epoch count (a 0-d
    int32 tensor, as the JAX package's carry holds it) and ``obj`` the
    final objective.

    A sharded problem (a row shard, a column shard, or both on a mesh of
    two axes) is served SPMD: every rank of its mesh makes the closure
    and calls it together with its own rows (its blocks, at the
    template's shapes) and the replicated x0; each call replays the
    solve captured over NCCL (runs it uncaptured over gloo), as
    ``iterate`` does, and returns the replicated x."""
    if not prob.has_data:
        raise ValueError("export_solver requires a data problem (A, y)")
    return _serving_fn(method, _template(prob), reg_name, sm,
                       opts or Options(verbose=0))


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


class _Program(torch.nn.Module):
    """``serve(A, y, x0)`` of the template problem, as ``torch.export``
    traces it: the data's derived tensors made again from the call's,
    then `iterate.solve_program` (a mini-batch solve also takes each
    epoch's permutation of the rows, ``perms``)."""

    def __init__(self, method, tpl: Problem, reg_name: str, sm,
                 opts: Options):
        super().__init__()
        self.method, self.tpl, self.reg_name = method, tpl, reg_name
        self.sm, self.opts = sm, opts

    def forward(self, A, y, x0, *perms):
        tpl = self.tpl
        prob = dc_replace(
            tpl, A=A, y=y, x0=x0, col_sumsq=None,
            A_lp=None if tpl.A_lp is None else A.to(torch.bfloat16))
        if tpl.col_sumsq is not None:
            prob = with_col_sumsq(prob)
        return solve_program(self.method, prob, self.reg_name, self.sm,
                             self.opts, *perms)


def _export_program(method, prob: Problem, reg_name: str, sm,
                    opts: Optional[Options] = None):
    """The ``torch.export.ExportedProgram`` of the serving function for
    ``prob``'s shapes (what :func:`export_solver` saves)."""
    if not prob.has_data:
        raise ValueError("export_solver requires a data problem (A, y)")
    opts = opts or Options(verbose=0)
    batches = _make_batches(prob, opts) is not None
    if is_colshard(prob.A):
        raise NotImplementedError(
            "exporting a column-sharded problem is not ported "
            "(ROADMAP A12): its gathers place this rank's block at the "
            "rank's offset, which the program would hold; serve it "
            "(make_serving_fn), or export a row shard")
    if batches and prob.mesh is not None:
        raise NotImplementedError(
            "exporting a mini-batch solve of a sharded problem is not "
            "ported (ROADMAP A12): each rank's rows of a batch are worked "
            "out on the host; serve it (make_serving_fn)")
    method = _resolve_kernels(method, prob)
    method, tpl = _auto_lp(method, prob, reg_name, opts)
    program = _Program(method, tpl, reg_name, sm, opts)
    args = (prob.A, prob.y, prob.x0)
    if batches:
        args += (torch.zeros((opts.max_epoch, prob.m_total),
                             dtype=torch.int64, device=prob.device),)
    ops = (launch.via_ops() if prob.device.type == "cuda"
           else contextlib.nullcontext())
    with graph.export_trace(), ops:
        ep = torch.export.export(program, args, strict=False)
    ep.example_inputs = None  # the template's data stays out of the file
    return ep


def _groups_meta(mesh) -> dict:
    """What a loading process's groups must match: the world size, the
    mesh's shape and axis names, and the name and ranks of the mesh's
    group and of each axis group (those the program's collectives
    name)."""
    named = lambda g: {"name": g.group_name,
                       "ranks": dist.get_process_group_ranks(g)}
    return {"world_size": dist.get_world_size(),
            "mesh_shape": list(mesh.sizes),
            "axis_names": list(mesh.axis_names),
            "group": named(mesh.group),
            "axis_groups": [named(g) for g in mesh.groups]}


def _check_groups(want: dict) -> None:
    """Raise ValueError unless this process's groups are those the
    artifact was exported over (`_groups_meta`)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    shape = "×".join(map(str, want["mesh_shape"]))
    if not dist.is_initialized():
        raise ValueError(
            f"load_solver: the artifact solves a problem sharded over a "
            f"{shape} mesh {tuple(want['axis_names'])} of "
            f"{want['world_size']} ranks; this process has no process "
            "group (it would solve one rank's rows alone): join the group "
            "and make the mesh first")
    if dist.get_world_size() != want["world_size"]:
        raise ValueError(
            f"load_solver: the artifact was exported over "
            f"{want['world_size']} ranks; this process's group has "
            f"{dist.get_world_size()}")
    for g in [want["group"]] + want["axis_groups"]:
        try:
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(g["name"]))
        except (RuntimeError, ValueError, KeyError):
            ranks = None
        if ranks != g["ranks"]:
            raise ValueError(
                f"load_solver: the artifact's collectives run over the "
                f"process group named {g['name']!r} of ranks {g['ranks']}; "
                f"in this process that name holds "
                f"{'no group' if ranks is None else ranks}. Make the "
                f"groups in the exporting process's order (the {shape} "
                f"mesh {tuple(want['axis_names'])}, as make_mesh makes "
                "it)")


def export_solver(method, prob: Problem, reg_name: str, sm,
                  opts: Optional[Options] = None) -> bytes:
    """The artifact of the serving function for ``prob``'s shapes (see
    the module's note): bytes to keep wherever artifacts live, to load
    with :func:`load_solver` or with torch alone. Raises ValueError for
    a problem without data, NotImplementedError naming ROADMAP A12 for a
    column shard or a mini-batch solve of a sharded problem. A row
    shard is exported by any rank of its mesh (all ranks make the same
    program)."""
    import scso_tpu_torch

    opts = opts or Options(verbose=0)
    ep = _export_program(method, prob, reg_name, sm, opts)
    n = prob.A.shape[-1]
    meta = {"format": FORMAT, "format_version": FORMAT_VERSION,
            "package_version": scso_tpu_torch.__version__,
            "torch_version": torch.__version__,
            "device": prob.device.type, "exported_on": str(prob.device),
            "n": n, "n_true": n if prob.n_true is None else prob.n_true,
            "sharded": (None if prob.mesh is None
                        else _groups_meta(prob.mesh)),
            "batches": None}
    if _make_batches(prob, opts) is not None:
        meta["batches"] = {"max_epoch": opts.max_epoch, "m": prob.m_total,
                           "shuffle": opts.shuffle_batch, "rng_seed": 0}
    extra = {META_FILE: json.dumps(meta)}
    if prob.device.type == "cuda":
        extra[OPS_FILE] = base64.b64encode(
            build.load_ops().read_bytes()).decode("ascii")
    out = io.BytesIO()
    torch.export.save(ep, out, extra_files=extra)
    return out.getvalue()


def _extra(blob: bytes, name: str) -> Optional[bytes]:
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        found = [f for f in z.namelist() if f.endswith("extra/" + name)]
        return z.read(found[0]) if found else None


def _load_ops(encoded: bytes) -> None:
    """The op library of a card artifact, unless this process has the
    ops already (this checkout's, `build.load_ops`): written under
    ``_build/loaded/``, named by a hash of its bytes, and loaded."""
    if hasattr(torch.ops.scso, "normal_matvec"):
        return
    lib = base64.b64decode(encoded)
    path = (build.BUILD_ROOT / "loaded"
            / f"libscso_ops_{hashlib.sha256(lib).hexdigest()[:16]}.so")
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}")
        tmp.write_bytes(lib)
        os.replace(tmp, path)
    torch.ops.load_library(str(path))


def permutations(batches: dict) -> np.ndarray:
    """Each epoch's permutation of the rows of a mini-batch artifact's
    solve (its metadata's ``batches``), drawn as ``iterate`` draws them:
    one ``permutation(m)`` an epoch from ``np.random.default_rng(seed)``,
    or ``arange(m)`` every epoch without shuffling."""
    m, epochs = batches["m"], batches["max_epoch"]
    if not batches["shuffle"]:
        return np.tile(np.arange(m), (epochs, 1))
    gen = np.random.default_rng(batches["rng_seed"])
    return np.stack([gen.permutation(m) for _ in range(epochs)])


def load_solver(blob: bytes, device=None):
    """Load an :func:`export_solver` artifact into the callable
    ``(A, y, x0) -> (x, epochs, obj)`` on the device it was exported for
    (``device``, if given, must be that one; default the artifact's): the
    op library it carries is loaded first where the program holds the
    ops. Data comes as tensors or arrays, at the padded width or at
    ``n_true`` columns (then padded with zeros). A mini-batch solve's
    permutations are drawn here (:func:`permutations`). A row shard's
    artifact loads on every rank of a group like the exporting one, each
    calling it with its own rows on its own card: the program, exported
    on one card, is moved to this one (``device``, default the current
    CUDA device; `torch.export.passes.move_to_device_pass`). Raises
    ValueError for bytes that are not such an artifact, and for a
    sharded one where this process's groups differ from the exporting
    process's."""
    raw = _extra(blob, META_FILE)
    meta = json.loads(raw) if raw else {}
    if (meta.get("format") != FORMAT
            or meta.get("format_version") != FORMAT_VERSION):
        raise ValueError(
            f"load_solver: not a {FORMAT} artifact of version "
            f"{FORMAT_VERSION} (format {meta.get('format')!r}, version "
            f"{meta.get('format_version')!r})")
    dev = torch.device(meta["device"] if device is None else device)
    if dev.type != meta["device"]:
        raise ValueError(f"load_solver: the artifact was exported for "
                         f"{meta['device']}, not {dev}")
    if meta["sharded"] is not None:
        _check_groups(meta["sharded"])
    if dev.type == "cuda":
        _load_ops(_extra(blob, OPS_FILE))  # before the program names them
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    ep = torch.export.load(io.BytesIO(blob))
    if dev.type == "cuda" and str(dev) != meta["exported_on"]:
        from torch.export.passes import move_to_device_pass

        # the program's own tensors (constants, and the ones it makes)
        # name the exporting card: on another rank's card they move
        ep = move_to_device_pass(ep, {meta["exported_on"]: str(dev)})
    program = ep.module()
    n, n_true = meta["n"], meta["n_true"]
    extra = ()
    if meta["batches"] is not None:
        extra = (torch.from_numpy(permutations(meta["batches"])).to(dev),)

    def serve(A, y, x0):
        A, y, x0 = (torch.as_tensor(t).to(dev) for t in (A, y, x0))
        if n_true != n and A.shape[-1] == n_true:
            pad = lambda t: torch.nn.functional.pad(t, (0, n - n_true))
            A, x0 = pad(A), pad(x0)
        return program(A.contiguous(), y.contiguous(), x0.contiguous(),
                       *extra)

    return serve
