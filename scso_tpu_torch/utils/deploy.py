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

``export_solver`` writes a declarative artifact and ``load_solver``
rebuilds the serving function from it. How this differs from the JAX
package's artifact: that one is StableHLO of the whole solve
(``jax.export``), which runs in any JAX process without scso_tpu and
without retracing. This one needs ``scso_tpu_torch`` at serve time and
captures once after loading: PyTorch has no serialized form for a CUDA
graph with conditional nodes, nor for the port's ctypes kernel launches.
The artifact is an in-memory zip of ``spec.json`` (the format and
package versions; the method's, smoother's and options' classes and
fields; ``reg_name``; the template problem's fields but its data; the
shapes and dtypes of A, y and x0) and ``arrays.npz`` (the template's
tensors: λ, x*, the bounds, the groups, a test set). Functions (f, its
derivative hooks, the GLM spec) are stored by their names in
`scso_tpu_torch.models.losses`, and only names there are accepted: a
user-written callable makes ``export_solver`` raise ValueError naming
the field. Nothing is pickled, so loading an artifact runs no stored
code. A self-contained artifact would need ``torch.export`` of a
functional form of the solve's loops and K1–K5 registered as custom
ops (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import inspect
import io
import json
import zipfile
from typing import Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.algorithms import methods as _methods
from scso_tpu_torch.algorithms.iterate import (
    Options, _auto_lp, _resolve_kernels, solve)
from scso_tpu_torch.models import losses as _losses
from scso_tpu_torch.ops import smoothers as _smoothers
from scso_tpu_torch.ops.groups import Groups
from scso_tpu_torch.problems import (
    GLMSpec, MOGLMSpec, Problem, resolve_device, with_col_sumsq)

FORMAT = "scso_tpu_torch.solver"
FORMAT_VERSION = 1

#: the problem's fields an artifact does not store: the data (its shapes
#: and dtypes are stored), what is derived from it (flags are stored),
#: and what is set per device or per run
_DATA_FIELDS = ("x0", "A", "y", "A_lp", "col_sumsq", "device", "mesh",
                "m_total", "mtest_total", "rows")


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

_CLASSES = {cls.__name__: cls for cls in (
    _methods.ProxNSCORE, _methods.ProxGGNSCORE, _methods.ProxLQNSCORE,
    _smoothers.NoSmooth, _smoothers.PHuberSmootherL1L2,
    _smoothers.OsBaSmootherL1L2, _smoothers.PHuberSmootherIndBox,
    _smoothers.ExponentialSmootherIndBox, _smoothers.LogExpSmootherIndBox,
    _smoothers.PHuberSmootherGL, _smoothers.OsBaSmootherGL, Options,
    Groups)}


def _loss_names() -> dict:
    """{id: name} of the functions defined in `models.losses`."""
    return {id(v): k for k, v in vars(_losses).items()
            if inspect.isfunction(v) and v.__module__ == _losses.__name__}


def _spec_name(spec) -> Optional[str]:
    """The name in `models.losses` of a spec of ``spec``'s class whose
    functions are ``spec``'s, field by field (its other fields may
    differ: n_out)."""
    def same(a, b):
        return all(
            getattr(a, f.name) is getattr(b, f.name)
            for f in dataclasses.fields(a)
            if callable(getattr(a, f.name)) or callable(getattr(b, f.name)))

    for name, v in vars(_losses).items():
        if type(v) is type(spec) and same(v, spec):
            return name
    return None


class _Encoder:
    """JSON of a value, its tensors set aside in ``arrays``."""

    def __init__(self, device: torch.device):
        self.arrays: dict = {}
        self.device = device
        self.fns = _loss_names()

    def __call__(self, value, field: str):
        if value is None or isinstance(value, (bool, int, float, str)):
            return value
        if isinstance(value, torch.Tensor):
            key = f"a{len(self.arrays)}"
            self.arrays[key] = value.detach().cpu().numpy()
            return {"tensor": key,
                    "on_device": value.device.type == self.device.type}
        if isinstance(value, torch.dtype):
            return {"dtype": str(value).removeprefix("torch.")}
        if isinstance(value, (GLMSpec, MOGLMSpec)):
            name = _spec_name(value)
            if name is None:
                raise ValueError(
                    f"export_solver: {field} is a {type(value).__name__} "
                    "whose functions are not a spec of "
                    "scso_tpu_torch.models.losses; only those are stored")
            return {"spec": name, "fields": {
                f.name: self(getattr(value, f.name), f"{field}.{f.name}")
                for f in dataclasses.fields(value)
                if not callable(getattr(value, f.name))}}
        if callable(value):
            name = self.fns.get(id(value))
            if name is None:
                raise ValueError(
                    f"export_solver: {field} is {value!r}, not a function "
                    "of scso_tpu_torch.models.losses; an artifact stores "
                    "functions by those names only")
            return {"fn": name}
        if _CLASSES.get(type(value).__name__) is type(value):
            return self.dataclass(value, field)
        raise ValueError(f"export_solver: {field} is a {type(value)}, "
                         "which an artifact cannot store")

    def dataclass(self, obj, field: str) -> dict:
        return {"class": type(obj).__name__, "fields": {
            f.name: self(getattr(obj, f.name), f"{field}.{f.name}")
            for f in dataclasses.fields(obj)}}


class _Decoder:
    def __init__(self, arrays, device: torch.device):
        self.arrays, self.device = arrays, device

    def __call__(self, value):
        if not isinstance(value, dict):
            return value
        if "tensor" in value:
            t = torch.from_numpy(np.array(self.arrays[value["tensor"]]))
            return t.to(self.device) if value["on_device"] else t
        if "dtype" in value:
            dt = getattr(torch, value["dtype"])
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"load_solver: unknown dtype {value}")
            return dt
        if "spec" in value:
            spec = getattr(_losses, value["spec"], None)
            if not isinstance(spec, (GLMSpec, MOGLMSpec)):
                raise ValueError(f"load_solver: no spec {value['spec']!r} "
                                 "in scso_tpu_torch.models.losses")
            return dc_replace(spec, **{k: self(v) for k, v in
                                       value["fields"].items()})
        if "fn" in value:
            fn = getattr(_losses, value["fn"], None)
            if not (inspect.isfunction(fn)
                    and fn.__module__ == _losses.__name__):
                raise ValueError(f"load_solver: no function {value['fn']!r} "
                                 "in scso_tpu_torch.models.losses")
            return fn
        if "class" in value:
            return self.dataclass(value)
        raise ValueError(f"load_solver: cannot read {value!r}")

    def dataclass(self, value):
        cls = _CLASSES.get(value["class"])
        if cls is None:
            raise ValueError(f"load_solver: unknown class {value['class']!r}")
        return cls(**{k: self(v) for k, v in value["fields"].items()})


def _shape(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix(
        "torch.")}


def export_solver(method, prob: Problem, reg_name: str, sm,
                  opts: Optional[Options] = None) -> bytes:
    """The artifact of the serving function for ``prob``'s shapes (see
    the module docstring): bytes to keep wherever artifacts live, to
    rebuild with :func:`load_solver`. Raises ValueError for a problem
    without data, or for a function that is not one of
    `scso_tpu_torch.models.losses` (naming the field)."""
    import scso_tpu_torch

    if not prob.has_data:
        raise ValueError("export_solver requires a data problem (A, y)")
    if prob.mesh is not None:
        raise NotImplementedError(
            "exporting a sharded problem is not ported (ROADMAP A12)")
    opts = opts or Options(verbose=0)
    enc = _Encoder(prob.device)
    problem = {f.name: enc(getattr(prob, f.name), f"prob.{f.name}")
               for f in dataclasses.fields(prob)
               if f.name not in _DATA_FIELDS}
    spec = {
        "format": FORMAT, "format_version": FORMAT_VERSION,
        "package_version": scso_tpu_torch.__version__,
        "method": enc.dataclass(method, "method"),
        "smoother": enc.dataclass(sm, "sm"),
        "options": enc.dataclass(opts, "opts"),
        "reg_name": reg_name,
        "problem": problem,
        "data": {"A": _shape(prob.A), "y": _shape(prob.y),
                 "x0": _shape(prob.x0),
                 "A_lp": None if prob.A_lp is None else _shape(prob.A_lp),
                 "col_sumsq": prob.col_sumsq is not None},
    }
    arrays = io.BytesIO()
    np.savez(arrays, **enc.arrays)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("spec.json", json.dumps(spec, indent=1))
        z.writestr("arrays.npz", arrays.getvalue())
    return out.getvalue()


def load_solver(blob: bytes, device=None):
    """Rebuild an :func:`export_solver` artifact into a serving function
    ``(A, y, x0) -> (x, epochs, obj)`` on ``device`` (default: the
    card), which captures on its first call. No stored code runs: the
    classes, specs and functions are looked up by name in the port."""
    dev = resolve_device(device)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        spec = json.loads(z.read("spec.json"))
        with np.load(io.BytesIO(z.read("arrays.npz")),
                     allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    if (spec.get("format") != FORMAT
            or spec.get("format_version") != FORMAT_VERSION):
        raise ValueError(
            f"load_solver: not a {FORMAT} artifact of version "
            f"{FORMAT_VERSION} (format {spec.get('format')!r}, version "
            f"{spec.get('format_version')!r})")
    dec = _Decoder(arrays, dev)
    data = spec["data"]

    def zeros(d):
        return torch.zeros(d["shape"], dtype=getattr(torch, d["dtype"]),
                           device=dev)

    fields = {k: dec(v) for k, v in spec["problem"].items()}
    tpl = Problem(
        x0=zeros(data["x0"]), A=zeros(data["A"]), y=zeros(data["y"]),
        A_lp=None if data["A_lp"] is None else zeros(data["A_lp"]),
        col_sumsq=(torch.zeros(data["A"]["shape"][-1],
                               dtype=fields["dtype"], device=dev)
                   if data["col_sumsq"] else None),
        device=dev, **fields)
    return _serving_fn(dec.dataclass(spec["method"]), tpl, spec["reg_name"],
                       dec.dataclass(spec["smoother"]),
                       dec.dataclass(spec["options"]))
