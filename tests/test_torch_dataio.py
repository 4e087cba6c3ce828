"""A saved test split through the port's sharded IO, against scso_tpu.

`save_problem_data(..., Atest=, ytest=)` writes ``Atest.npy``,
``ytest.npy`` and ``"has_test": true``; `load_problem_rows_sharded`
reads this rank's rows of the split as the JAX package's loader does
(`scso_tpu/parallel/dataio.py`). A directory written by either package
is read by both, on one-rank meshes (gloo in this process; one CPU
device), with Atest/ytest equal in float64, and a 5-epoch ProxGGNSCORE
solve of the loaded problem records the JAX package's ``fvaltest`` to
1e-10 — cached and uncached (f(x) off the cache). Float64, 64×8 with a
32-row split.
"""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import scso_tpu as scso
import scso_tpu_torch as st
from scso_tpu.models import losses as jlosses
from scso_tpu.parallel import load_problem_rows_sharded as jload
from scso_tpu.parallel import make_mesh as jmake_mesh
from scso_tpu.parallel import save_problem_data as jsave
from scso_tpu_torch.models import losses
from scso_tpu_torch.parallel import (
    distributed_init, load_problem_rows_sharded, make_mesh, save_problem_data)

LAM = 1e-2
KW = dict(max_epoch=5, verbose=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    distributed_init("gloo", init_method=f"tcp://localhost:{_free_port()}",
                     world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


def _data():
    rng = np.random.default_rng(16)
    A = rng.standard_normal((96, 8)) * 0.5
    x_true = rng.standard_normal(8)
    y = (rng.random(96) < 1.0 / (1.0 + np.exp(-A @ x_true))).astype(
        np.float64)
    return A[:64], y[:64], A[64:], y[64:], np.zeros(8)


def _write(writer, path):
    A, y, At, yt, _ = _data()
    if writer == "jax":
        jsave(str(path), A, y, Atest=At, ytest=yt)
    else:
        save_problem_data(str(path), torch.tensor(A), y, Atest=At,
                          ytest=torch.tensor(yt))


def _loaded(path, mesh):
    x0 = _data()[-1]
    pj = jload(str(path), x0, jlosses.logistic01_f, LAM,
               jmake_mesh((1,), devices=jax.devices()[:1]),
               grad_fx=jlosses.logistic01_grad, glm=jlosses.LOGISTIC01_GLM,
               dtype=np.float64)
    pt = load_problem_rows_sharded(
        str(path), x0, losses.logistic01_f, LAM, mesh,
        grad_fx=losses.logistic01_grad, glm=losses.LOGISTIC01_GLM,
        device="cpu", chunk_bytes=256)
    return pj, pt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_loaders_read_the_split(one_rank, tmp_path, writer):
    _write(writer, tmp_path)
    with open(tmp_path / "manifest.json") as fh:
        manifest = json.load(fh)
    assert manifest["has_test"] is True and manifest["m"] == 64
    _, _, At, yt, _ = _data()
    pj, pt = _loaded(tmp_path, one_rank)
    assert pt.has_test and pt.mtest_total == 32 and pt.m_total == 64
    assert pt.Atest.dtype == torch.float64
    for got, jax_arr, want in ((pt.Atest, pj.Atest, At),
                               (pt.ytest, pj.ytest, yt)):
        assert np.array_equal(got.numpy(), np.asarray(jax_arr))
        assert np.array_equal(got.numpy(), want)


def test_no_split_saves_none(one_rank, tmp_path):
    A, y, _, _, x0 = _data()
    save_problem_data(str(tmp_path), A, y)
    assert not os.path.exists(tmp_path / "Atest.npy")
    prob = load_problem_rows_sharded(str(tmp_path), x0, losses.logistic01_f,
                                     LAM, one_rank, device="cpu")
    assert not prob.has_test and prob.mtest_total is None


@pytest.mark.parametrize("epoch_cache", [None, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loaded_split_records_jax_fvaltest(one_rank, tmp_path, writer,
                                           epoch_cache):
    """C10: the split used to be dropped without an error. Now the
    sharded solve of the loaded problem records ``fvaltest`` — on the
    cached path and off it (f(x) a record)."""
    _write(writer, tmp_path)
    pj, pt = _loaded(tmp_path, one_rank)
    method = dict(solver="cg", epoch_cache=epoch_cache)
    sj = scso.iterate(scso.ProxGGNSCORE(kernels="xla", **method), pj, "l1",
                      scso.PHuberSmootherL1L2(1.0), **KW)
    s = st.iterate(st.ProxGGNSCORE(**method), pt, "l1",
                   st.PHuberSmootherL1L2(1.0), **KW)
    assert s.epochs == sj.epochs and len(s.fvaltest) == len(sj.fvaltest)
    assert len(s.fvaltest) == s.epochs + 1
    np.testing.assert_allclose(s.fvaltest.numpy(), np.asarray(sj.fvaltest),
                               rtol=1e-10)
    np.testing.assert_allclose(s.obj.numpy(), np.asarray(sj.obj),
                               rtol=1e-10)
