"""Build and load the hand-written CUDA kernels.

All kernels live in ``scso_tpu_torch/csrc/*.cu``. On first use they are
compiled by ``nvcc`` for Hopper (``sm_90a``), one nvcc process for each
source, all started together, and linked into a shared library with a
plain C interface, loaded through ``ctypes`` (:func:`load`): the
solver's launches. The objects stay beside the library. The op library
(:func:`build_ops`, :func:`load_ops`) is built apart, on first use:
``g++`` compiles ``csrc/ops.cpp`` against PyTorch's headers and it is
linked with those objects into K1–K5 as the custom ops
``torch.ops.scso.*`` that an exported program holds (`utils.deploy`),
loadable with ``torch.ops.load_library`` by any process that has
torch. A solve that never exports needs neither g++ nor PyTorch's
headers. Both go into ``scso_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources, flags and PyTorch
version, so an edited source rebuilds and an unchanged one is reused. A
failed build raises with the compilers' output. :func:`build_meta`
compiles the ops' schemas and Meta functions alone (no CUDA needed),
for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libscso_kernels.so"
OPS_LIB_NAME = "libscso_ops.so"
OPS_SOURCE = CSRC / "ops.cpp"
#: g++ flags of the op library's source
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-w")
#: compile flags, one source to one object
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_p, _i64 = ctypes.c_void_p, ctypes.c_int64
#: C entry points → argtypes; every function returns cudaGetLastError()
SIGNATURES = {
    # A, w, v, partials, out, m, n, n_blocks (the most: the rows of
    # partials), wide, row groups, stream; the _bf16 entries take A in
    # bfloat16 and the rest in float32 / float64
    "scso_normal_matvec": [_p] * 5 + [_i64] * 5 + [_p],
    "scso_normal_matvec_bf16": [_p] * 5 + [_i64] * 5 + [_p],
    # A, Z, V (transposed for the two-pass and split forms), qu (their
    # scratch), partials, out, m, p, k, n_blocks, rows_per_block, form (0
    # two-pass, 1 tensor-core, 2 and 3 the split form's passes), stream
    "scso_mglm_matvec": [_p] * 6 + [_i64] * 6 + [_p],
    "scso_mglm_matvec_bf16": [_p] * 6 + [_i64] * 6 + [_p],  # A in bf16
    # A, y, x_t, x_d, w_t, w_d, rw, b_t, b_d, hd_t, hd_d, loss_t, loss_d,
    # partials, loss_partials, m, n, m_norm, the spec's kind, then the
    # PrepGrid (blocks, rows_per_block, smem_bytes, threads,
    # chunks_per_thread, row_blocks, cluster, stages, group_rows), phase
    # (0, or the split form's 1 and 2), stream
    "scso_glm_prep_pair": [_p] * 15 + [_i64] * 14 + [_p],
    # the same in the newton flavour (ProxNSCORE's epoch cache)
    "scso_glm_prep_pair_newton": [_p] * 15 + [_i64] * 14 + [_p],
    # A, y, x, w, rw, b, hd, partials, m, n, m_norm, the kind, the
    # PrepGrid, phase, stream
    "scso_glm_prep": [_p] * 8 + [_i64] * 14 + [_p],
    # the same three with A in bfloat16, the rest in float32 / float64
    "scso_glm_prep_pair_bf16": [_p] * 15 + [_i64] * 14 + [_p],
    "scso_glm_prep_pair_newton_bf16": [_p] * 15 + [_i64] * 14 + [_p],
    "scso_glm_prep_bf16": [_p] * 8 + [_i64] * 14 + [_p],
    # S, Y, g, pos, count, H0, scratch (None: α/ρ in shared memory),
    # out, m, n, then the TwoLoopPlan (blocks, chunk, flags, smem), stream
    "scso_two_loop": [_p] * 8 + [_i64] * 6 + [_p],
    # x, d, lgr, hr, lb, ub, lam, ss, Mg, reg, x_new, stats, partials
    # (grid form), n, then the UpdateForm (blocks, chunk, grid), stream
    "scso_score_update": [_p] * 9 + [_i64, _p, _p, _p] + [_i64] * 4
    + [_p],
    # cluster size, &count: how many such clusters the card holds at once
    "scso_two_loop_cluster_fit": [_i64, _p],
    "scso_score_update_cluster_fit": [_i64, _p],
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when an up-to-date library was reused
    log: str         # nvcc's output (ptxas register/smem report), also
    #                  kept as build.log beside the library


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def torch_flags(linker: str = "nvcc") -> tuple:
    """(compile flags, link flags) of a source that includes PyTorch's
    headers and of a library that ``linker`` ('nvcc' or 'g++') links
    against PyTorch's libraries."""
    import torch

    root = Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    lib = root / "lib"
    return ((f"-D_GLIBCXX_USE_CXX11_ABI={abi}", "-I", str(root / "include"),
             "-I", str(root / "include" / "torch" / "csrc" / "api" /
                       "include")),
            ("-L", str(lib), "-lc10", "-ltorch_cpu")
            + (("-Xlinker", f"-rpath,{lib}") if linker == "nvcc"
               else (f"-Wl,-rpath,{lib}",)))


def find_cxx() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"),
              shutil.which("c++")):
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("g++ not found (set CXX): the op library is built "
                       "from source on first use")


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


def _source_hash(*tools: str) -> str:
    import torch

    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(" ".join(tools + (torch.__version__,)).encode())
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


def _objects(out_dir: Path) -> list:
    """(source, object) of every kernel source; the objects are kept
    beside the kernel library for the op library's link."""
    return [(cu, out_dir / f"{cu.stem}.o") for cu in sorted(CSRC.glob("*.cu"))]


def build() -> BuildResult:
    """Compile csrc/*.cu into the hash-keyed kernel library (reused if
    built)."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _source_hash(nvcc)
    lib = out_dir / LIB_NAME
    objs = _objects(out_dir)
    if lib.is_file() and all(o.is_file() for _, o in objs):
        return BuildResult(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    tmps = [out_dir / f".{cu.stem}.{tag}.o" for cu, _ in objs]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o",
                          str(t), str(cu)] for (cu, _), t in zip(objs, tmps)])
        ok = all(rc == 0 for _, rc, _ in runs)
        if ok:
            runs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, tmps)]])
            ok = runs[-1][1] == 0
        if ok:
            for t, (_, o) in zip(tmps, objs):
                os.replace(t, o)
    finally:
        for t in tmps:
            t.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
    if not ok:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the kernel build failed:\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


_OPS_LOCK = threading.Lock()


def build_ops() -> Path:
    """The op library: csrc/ops.cpp compiled by g++ against PyTorch's
    headers and linked with the kernel objects of :func:`build` into
    ``<build>/ops-<hash>/libscso_ops.so`` (reused if built). Safe to call
    from a thread while the solver runs (one build at a time)."""
    import torch

    with _OPS_LOCK:
        kernels = build().path.parent
        cxx, nvcc = find_cxx(), find_nvcc()
        h = hashlib.sha256(OPS_SOURCE.read_bytes())
        h.update(" ".join(CXX_FLAGS + (cxx, torch.__version__)).encode())
        out_dir = kernels / f"ops-{h.hexdigest()[:16]}"
        lib = out_dir / OPS_LIB_NAME
        if lib.is_file():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = str(os.getpid())
        obj = out_dir / f".ops.{tag}.o"
        tmp = out_dir / f".{OPS_LIB_NAME}.{tag}"
        cflags, lflags = torch_flags()
        try:
            runs = _run_all([[cxx, *CXX_FLAGS, *cflags, "-c", "-o", str(obj),
                              str(OPS_SOURCE)]])
            if runs[-1][1] == 0:
                runs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                                   str(obj), *(str(o) for _, o in
                                               _objects(kernels)),
                                   *lflags]])
        finally:
            obj.unlink(missing_ok=True)
        if runs[-1][1] != 0:
            tmp.unlink(missing_ok=True)
            log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, _, out in runs)
            raise RuntimeError(f"the op library's build failed:\n{log}")
        os.replace(tmp, lib)
        return lib


@functools.lru_cache(maxsize=None)
def load_ops() -> Path:
    """Build if needed and load the op library once a process
    (``torch.ops.scso.*``); returns its path."""
    import torch

    path = build_ops()
    torch.ops.load_library(str(path))
    return path


@functools.lru_cache(maxsize=None)
def build_meta() -> Path:
    """The ops' schemas and Meta functions alone (``-DSCSO_OPS_META_ONLY``:
    no kernel, no CUDA), built with g++ into ``_build/meta-<hash>/`` and
    loaded: what the CPU tests check of the op library."""
    import torch

    cxx = find_cxx()
    h = hashlib.sha256(OPS_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + (cxx, torch.__version__)).encode())
    out_dir = BUILD_ROOT / f"meta-{h.hexdigest()[:16]}"
    lib = out_dir / "libscso_ops_meta.so"
    if not lib.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{lib.name}.{os.getpid()}"
        cflags, lflags = torch_flags("g++")
        cmd = [cxx, *CXX_FLAGS, "-shared", "-DSCSO_OPS_META_ONLY", *cflags,
               "-o", str(tmp), str(OPS_SOURCE), *lflags]
        (_, rc, out), = _run_all([cmd])
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed:\n$ {' '.join(cmd)}\n{out}")
        os.replace(tmp, lib)
    torch.ops.load_library(str(lib))
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build().path))
    for base, argtypes in SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    # blocks, cluster size (0: a plain launch), stream
    lib.scso_empty_kernel.argtypes = [_i64, _i64, _p]
    lib.scso_empty_kernel.restype = ctypes.c_int
    # candidates, group_rows, cluster, threads, smem, &count: K2's
    # cluster form (csrc/glm_prep_bf16.cu)
    lib.scso_glm_prep_cluster_fit.argtypes = [_i64] * 5 + [_p]
    lib.scso_glm_prep_cluster_fit.restype = ctypes.c_int
    # parent stream, &pred (one bool), child stream, WHILE (else IF),
    # &handle: begin a conditional node's body (csrc/graph.cu); child
    # stream, handle, &pred (a WHILE's; else NULL), &nodes: end it;
    # graph, &nodes: a graph's top-level node count
    lib.scso_graph_cond_begin.argtypes = [_p, _p, _p, ctypes.c_int, _p]
    lib.scso_graph_cond_end.argtypes = [_p, ctypes.c_uint64, _p, _p]
    lib.scso_graph_nodes.argtypes = [_p, _p]
    for fn in (lib.scso_graph_cond_begin, lib.scso_graph_cond_end,
               lib.scso_graph_nodes):
        fn.restype = ctypes.c_int
    lib.scso_cuda_error_string.argtypes = [ctypes.c_int]
    lib.scso_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        msg = load().scso_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
