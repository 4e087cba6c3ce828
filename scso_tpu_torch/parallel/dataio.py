"""Sharded on-disk data IO: each rank reads only its own rows.

Port of `scso_tpu.parallel.dataio` for the row-sharded data problem. A
data matrix too large for one host's RAM is written once to ``.npy``
(`save_problem_data`, chunk by chunk) and each rank then reads only its
own row range (`load_problem_rows_sharded`), chunk by chunk, with
``np.fromfile`` at an offset, and moves each chunk to the problem's
device before reading the next: host RSS stays at one chunk, whatever
the size of A. The files are the JAX package's format, so either
package reads what the other wrote, a test split (``Atest.npy``,
``ytest.npy``, ``"has_test": true``) included.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from scso_tpu_torch._src.struct import replace as dc_replace
from scso_tpu_torch.parallel.sharding import Mesh
from scso_tpu_torch.problems import Problem, make_problem, resolve_device

#: host bytes read at a time by default: one chunk, never the shard
DEFAULT_CHUNK_BYTES = 1 << 28


def save_array(path: str, arr, *, chunk_rows: int = 1 << 16) -> None:
    """Write an array to ``.npy`` incrementally (chunk_rows rows at a
    time), so a memmapped or generated source is never resident at once.
    ``arr`` is a numpy array, a memmap, or anything with ``shape``,
    ``dtype`` and row slicing that numpy can convert."""
    shape, dtype = tuple(arr.shape), np.dtype(arr.dtype)
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_2_0(
            fh, dict(descr=np.lib.format.dtype_to_descr(dtype),
                     fortran_order=False, shape=shape))
        if len(shape) == 0:
            fh.write(np.asarray(arr).tobytes())
            return
        for lo in range(0, shape[0], chunk_rows):
            fh.write(np.ascontiguousarray(
                arr[lo:lo + chunk_rows]).tobytes())


def _npy_meta(path: str):
    """(shape, dtype, data_offset) of a ``.npy`` without loading it
    (format 1.0, as `np.save` writes it, or 2.0, as `save_array`)."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        if version not in readers:
            raise ValueError(f"{path}: .npy format {version} not supported")
        shape, fortran, dtype = readers[version](fh)
        if fortran:
            raise ValueError(f"{path}: fortran-order .npy not supported")
        return shape, dtype, fh.tell()


def _read_rows(path: str, offset: int, file_dtype, row_shape, lo: int,
               hi: int) -> np.ndarray:
    """Rows [lo, hi) of a C-order .npy in a FRESH heap buffer:
    ``np.fromfile`` at an offset, not a memmap slice, whose resident
    pages count toward host RSS and are not reliably evicted."""
    row_elems = int(np.prod(row_shape, dtype=np.int64)) if row_shape else 1
    buf = np.fromfile(
        path, dtype=file_dtype, count=(hi - lo) * row_elems,
        offset=offset + lo * row_elems * file_dtype.itemsize)
    return buf.reshape((hi - lo,) + tuple(row_shape))


def load_rows_sharded(path: str, mesh: Mesh, data_axis: str = "data", *,
                      dtype=None, device=None,
                      chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """This rank's rows ``[r·m/S, (r+1)·m/S)`` of a ``.npy``, on
    ``device`` (default: the card) in ``dtype`` (default: the file's).

    The shard is allocated on the device once and filled chunk by chunk
    (``chunk_bytes`` of the file at a time, 256 MiB by default): each
    chunk is a fresh ``np.fromfile`` buffer, copied to the device (a
    blocking copy) and freed before the next read. m must divide the
    axis size, as in `shard_problem`."""
    shape, file_dt, offset = _npy_meta(path)
    size = mesh.shape[data_axis]
    m = shape[0]
    if m % size != 0:
        raise ValueError(
            f"rows m={m} not divisible by {data_axis!r}={size} (zero-row "
            "padding would rescale 1/m losses; pad the file explicitly)")
    lo, hi = mesh.rank * m // size, (mesh.rank + 1) * m // size
    if dtype is None:
        dtype = getattr(torch, file_dt.name)
    out = torch.empty((hi - lo,) + tuple(shape[1:]), dtype=dtype,
                      device=resolve_device(device))
    row_bytes = max(
        1, int(np.prod(shape[1:], dtype=np.int64)) * file_dt.itemsize)
    chunk_rows = max(1, int(chunk_bytes or DEFAULT_CHUNK_BYTES) // row_bytes)
    for clo in range(lo, hi, chunk_rows):
        chi = min(clo + chunk_rows, hi)
        block = _read_rows(path, offset, file_dt, shape[1:], clo, chi)
        out[clo - lo:chi - lo].copy_(torch.from_numpy(block))
        del block  # freed before the next read
    return out


def save_problem_data(dirpath: str, A, y, *, chunk_rows: int = 1 << 16,
                      Atest=None, ytest=None) -> None:
    """Persist a data problem's arrays for sharded loading: ``A.npy``,
    ``y.npy``, with ``Atest``/``ytest`` also ``Atest.npy`` and
    ``ytest.npy``, and a manifest (``has_test``). The arrays are numpy
    arrays, memmaps or CPU tensors."""
    A, y, Atest, ytest = (a.numpy() if isinstance(a, torch.Tensor) else a
                          for a in (A, y, Atest, ytest))
    os.makedirs(dirpath, exist_ok=True)
    save_array(os.path.join(dirpath, "A.npy"), A, chunk_rows=chunk_rows)
    save_array(os.path.join(dirpath, "y.npy"), y, chunk_rows=chunk_rows)
    manifest = dict(m=int(A.shape[0]), n=int(A.shape[-1]),
                    dtype=str(np.dtype(A.dtype)),
                    has_test=Atest is not None)
    if Atest is not None:
        save_array(os.path.join(dirpath, "Atest.npy"), Atest,
                   chunk_rows=chunk_rows)
        save_array(os.path.join(dirpath, "ytest.npy"), ytest,
                   chunk_rows=chunk_rows)
    with open(os.path.join(dirpath, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def load_problem_rows_sharded(dirpath: str, x0, f, lam, mesh: Mesh,
                              data_axis: str = "data", *, dtype=None,
                              device=None, chunk_bytes=None,
                              **problem_kw) -> Problem:
    """A row-sharded :class:`Problem` straight from a
    :func:`save_problem_data` directory: the out-of-host-RAM equivalent
    of ``shard_problem(make_problem(A, y, ...), mesh)``. This rank's
    rows of A and y — and of the test split, where the manifest has one
    (``has_test``) and ``problem_kw`` does not name ``Atest``, which is
    then this rank's rows of a test set as well — go from disk to
    ``device`` (default: the card) chunk by chunk; ``x0`` and
    everything else are built by every rank from the same arguments
    (``problem_kw`` goes to `make_problem`: ``glm``, ``grad_fx``,
    ``sol``, ``pad_features``, ...). The problem records ``mesh``,
    ``data_axis`` and the files' row counts as ``m_total`` and
    ``mtest_total``."""
    with open(os.path.join(dirpath, "manifest.json")) as fh:
        manifest = json.load(fh)
    if dtype is None:
        dtype = getattr(torch, manifest["dtype"])
    device = resolve_device(device)
    load = lambda name: load_rows_sharded(
        os.path.join(dirpath, name), mesh, data_axis, dtype=dtype,
        device=device, chunk_bytes=chunk_bytes)
    kw = dict(problem_kw)
    if manifest.get("has_test") and "Atest" not in kw:
        kw["Atest"], kw["ytest"] = load("Atest.npy"), load("ytest.npy")
    prob = make_problem(load("A.npy"), load("y.npy"), x0, f, lam,
                        dtype=dtype, device=device, **kw)
    mtest = (int(prob.Atest.shape[0]) * mesh.shape[data_axis]
             if prob.has_test else None)
    return dc_replace(prob, mesh=mesh, data_axis=data_axis,
                      m_total=int(manifest["m"]), mtest_total=mtest)
