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
captured solve, the fast path inside a process. A sharded problem is
neither served nor exported (ROADMAP A12), nor is a mini-batch solve
exported (its permutations are drawn on the host).
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

import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms.iterate import (
    Options, _auto_lp, _make_batches, _resolve_kernels, solve,
    solve_program)
from scso_tpu_torch.ops.cuda import build, graph, launch
from scso_tpu_torch.problems import Problem, with_col_sumsq

#: the artifact's extra files: what it was exported for, and (card
#: artifacts) the op library, base64-encoded
META_FILE = "scso_solver.json"
OPS_FILE = "scso_ops.so.b64"
FORMAT = "scso_tpu_torch.solver"
FORMAT_VERSION = 2


def _template(prob: Problem) -> Problem:
    """``prob`` on static data tensors of its own (A, y, x0 and what is
    derived from A), which each call of the serving function fills."""
    like = lambda t: None if t is None else torch.zeros_like(t)
    return dc_replace(prob, A=like(prob.A), y=like(prob.y),
                      x0=like(prob.x0), A_lp=like(prob.A_lp),
                      col_sumsq=like(prob.col_sumsq))


def _fill(dst: torch.Tensor, src, n_true: Optional[int], name: str):
    """Copy ``src`` into the static ``dst``: at dst's width, or at the
    unpadded ``n_true`` columns, the padded ones set to 0."""
    src = torch.as_tensor(src)
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
            tpl.A_lp.copy_(tpl.A)
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
    final objective."""
    if not prob.has_data:
        raise ValueError("export_solver requires a data problem (A, y)")
    if prob.mesh is not None:
        raise NotImplementedError(
            "serving a sharded problem is not ported (ROADMAP A12): serve "
            "the unsharded problem")
    return _serving_fn(method, _template(prob), reg_name, sm,
                       opts or Options(verbose=0))


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


class _Program(torch.nn.Module):
    """``serve(A, y, x0)`` of the template problem, as ``torch.export``
    traces it: the data's derived tensors made again from the call's,
    then `iterate.solve_program`."""

    def __init__(self, method, tpl: Problem, reg_name: str, sm,
                 opts: Options):
        super().__init__()
        self.method, self.tpl, self.reg_name = method, tpl, reg_name
        self.sm, self.opts = sm, opts

    def forward(self, A, y, x0):
        tpl = self.tpl
        prob = dc_replace(
            tpl, A=A, y=y, x0=x0, col_sumsq=None,
            A_lp=None if tpl.A_lp is None else A.to(torch.bfloat16))
        if tpl.col_sumsq is not None:
            prob = with_col_sumsq(prob)
        return solve_program(self.method, prob, self.reg_name, self.sm,
                             self.opts)


def _export_program(method, prob: Problem, reg_name: str, sm,
                    opts: Optional[Options] = None):
    """The ``torch.export.ExportedProgram`` of the serving function for
    ``prob``'s shapes (what :func:`export_solver` saves)."""
    if not prob.has_data:
        raise ValueError("export_solver requires a data problem (A, y)")
    if prob.mesh is not None:
        raise NotImplementedError(
            "exporting a sharded problem is not ported (ROADMAP A12): "
            "export the unsharded problem")
    opts = opts or Options(verbose=0)
    if _make_batches(prob, opts) is not None:
        raise ValueError(
            "an exported solve runs full batches: the port draws each "
            "epoch's permutation of the rows on the host")
    method = _resolve_kernels(method, prob)
    method, tpl = _auto_lp(method, prob, reg_name, opts)
    program = _Program(method, tpl, reg_name, sm, opts)
    ops = (launch.via_ops() if prob.device.type == "cuda"
           else contextlib.nullcontext())
    with graph.export_trace(), ops:
        ep = torch.export.export(program, (prob.A, prob.y, prob.x0),
                                 strict=False)
    ep.example_inputs = None  # the template's data stays out of the file
    return ep


def export_solver(method, prob: Problem, reg_name: str, sm,
                  opts: Optional[Options] = None) -> bytes:
    """The artifact of the serving function for ``prob``'s shapes (see
    the module's note): bytes to keep wherever artifacts live, to load
    with :func:`load_solver` or with torch alone. Raises ValueError for
    a problem without data or a mini-batch solve, NotImplementedError for
    a sharded problem."""
    import scso_tpu_torch

    ep = _export_program(method, prob, reg_name, sm, opts)
    n = prob.A.shape[-1]
    meta = {"format": FORMAT, "format_version": FORMAT_VERSION,
            "package_version": scso_tpu_torch.__version__,
            "torch_version": torch.__version__,
            "device": prob.device.type, "n": n,
            "n_true": n if prob.n_true is None else prob.n_true}
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


def load_solver(blob: bytes, device=None):
    """Load an :func:`export_solver` artifact into the callable
    ``(A, y, x0) -> (x, epochs, obj)`` on the device it was exported for
    (``device``, if given, must be that one; default the artifact's): the
    op library it carries is loaded first where the program holds the
    ops. Data comes as tensors or arrays, at the padded width or at
    ``n_true`` columns (then padded with zeros). Raises ValueError for
    bytes that are not such an artifact."""
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
    if dev.type == "cuda":
        _load_ops(_extra(blob, OPS_FILE))
    program = torch.export.load(io.BytesIO(blob)).module()
    n, n_true = meta["n"], meta["n_true"]

    def serve(A, y, x0):
        A, y, x0 = (torch.as_tensor(t).to(dev) for t in (A, y, x0))
        if n_true != n and A.shape[-1] == n_true:
            pad = lambda t: torch.nn.functional.pad(t, (0, n - n_true))
            A, x0 = pad(A), pad(x0)
        return program(A.contiguous(), y.contiguous(), x0.contiguous())

    return serve
