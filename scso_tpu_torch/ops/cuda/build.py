"""Build and load the hand-written CUDA kernels.

All kernels live in ``scso_tpu_torch/csrc/*.cu``. On first use they are
compiled by ``nvcc`` for Hopper (``sm_90a``), one nvcc process for each
source, all started together, and linked into ONE shared library with a
plain C interface, loaded through ``ctypes``: without PyTorch's headers
the build takes seconds, not minutes. The library goes into
``scso_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libscso_kernels.so"
#: compile flags, one source to one object
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_p, _i64, _f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
#: C entry points → argtypes; every function returns cudaGetLastError()
SIGNATURES = {
    # A, w, v, partials, out, m, n, n_blocks, wide, stream
    "scso_normal_matvec": [_p] * 5 + [_i64] * 4 + [_p],
    # A, Z, V (transposed for the two-pass form), qu (two-pass scratch),
    # partials, out, m, p, k, n_blocks, fused, stream
    "scso_mglm_matvec": [_p] * 6 + [_i64] * 5 + [_p],
    # A, y, x_t, x_d, w_t, w_d, rw, b_t, b_d, hd_t, hd_d, loss_t, loss_d,
    # col_partials, loss_partials, m, n, m_norm, row_blocks, chunks,
    # stream
    "scso_glm_prep_pair": [_p] * 15 + [_i64] * 5 + [_p],
    # A, y, x, w, rw, b, hd, col_partials, m, n, m_norm, row_blocks,
    # chunks, stream
    "scso_glm_prep": [_p] * 8 + [_i64] * 5 + [_p],
    # S, Y, g, pos, count, H0, out, m, n, stream
    "scso_two_loop": [_p] * 7 + [_i64] * 2 + [_p],
    # x, d, lgr, hr, lb, ub, lam, ss, Mg, reg, x_new, stats, n, stream
    "scso_score_update": [_p] * 8 + [_f64, _i64, _p, _p, _i64, _p],
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when an up-to-date library was reused
    log: str         # nvcc's output (ptxas register/smem report), also
    #                  kept as build.log beside the library


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source on first use")


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _run_all(cmds) -> list:
    """Start every command at once, then wait for each:
    [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    out = []
    for cmd, p in procs:
        text = p.communicate()[0]
        out.append((cmd, p.returncode, text))
    return out


def build() -> BuildResult:
    """Compile csrc/*.cu into the hash-keyed library (reused if built)."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _source_hash(nvcc)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    objs = [(cu, out_dir / f".{cu.stem}.{tag}.o")
            for cu in sorted(CSRC.glob("*.cu"))]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        runs = _run_all([nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o",
                         str(o), str(cu)] for cu, o in objs)
        ok = all(rc == 0 for _, rc, _ in runs)
        if ok:
            runs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *(str(o) for _, o in objs)]])
            ok = runs[-1][1] == 0
    finally:
        for _, o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build().path))
    for base, argtypes in SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.scso_cuda_error_string.argtypes = [ctypes.c_int]
    lib.scso_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        msg = load().scso_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
