"""Host-side data generation in C++ (the port's copy of
`scso_tpu._native`).

``datagen.cpp`` is compiled on first use (``g++ -O3 -march=native
-fopenmp``, the JAX package's flags: the same code and flags give the
same stream for a seed) into ``scso_tpu_torch/_build/datagen_<hash>/``
(listed in ``.gitignore``, keyed by a hash of the source, the flags and
the host's CPU) and
bound through ctypes. Every entry point returns None where no toolchain
builds it, and `models.synthetic` then falls back to numpy, as the JAX
package does; ``available()`` says whether the native path loaded.
``chip_smoke.py`` times it against numpy on the card's host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "datagen.cpp"
BUILD_ROOT = _DIR.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _host_cpu() -> bytes:
    """What -march=native compiles for: the host's CPU model and flags
    (a library built on another CPU may not run here)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def _library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()
                         + _host_cpu())
    return BUILD_ROOT / f"datagen_{key.hexdigest()[:16]}" / "libdatagen.so"


def _build(lib: Path) -> bool:
    """Compile into a temporary file beside ``lib``, then rename it into
    place: processes that build at once never load a half-written one."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SCSO_NO_NATIVE"):
            return None
        lib_path = _library_path()
        try:
            if not lib_path.exists() and not _build(lib_path):
                return None
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        i64, f32p, dbl = (ctypes.c_int64,
                          np.ctypeslib.ndpointer(np.float32,
                                                 flags="C_CONTIGUOUS"),
                          ctypes.c_double)
        lib.fill_sparse_logreg.argtypes = [f32p, f32p, f32p, f32p, i64,
                                           i64, dbl, i64, i64,
                                           ctypes.c_int]
        lib.fill_sparse_logreg.restype = ctypes.c_int
        lib.fill_randn.argtypes = [f32p, i64, i64, i64]
        lib.fill_randn.restype = ctypes.c_int
        lib.omp_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def threads() -> int:
    """OpenMP's thread count for the fills (0 without the library)."""
    lib = _load()
    return 0 if lib is None else int(lib.omp_threads())


def sparse_logreg(m: int, n: int, density: float, n_active: int,
                  seed: int, label01: bool):
    """Native sparse logistic data; returns (A, y, x0, x_true) as
    float32 numpy arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    A = np.empty((m, n), np.float32)
    y = np.empty((m,), np.float32)
    x0 = np.empty((n,), np.float32)
    x_true = np.empty((n,), np.float32)
    rc = lib.fill_sparse_logreg(A, y, x0, x_true, m, n, float(density),
                                int(n_active), int(seed), int(label01))
    if rc != 0:
        return None
    return A, y, x0, x_true


def randn(m: int, n: int, seed: int):
    """Native (m, n) standard-normal float32 matrix, or None."""
    lib = _load()
    if lib is None:
        return None
    A = np.empty((m, n), np.float32)
    if lib.fill_randn(A, m, n, int(seed)) != 0:
        return None
    return A
