"""Data and arrays carried across: the port's numpy-only generator, its
padded Problem, and the converters in scso_tpu_torch.utils.convert.

The generator must give arrays bit-identical to scso_tpu's for the same
seed; the converters must round-trip exactly; and the package must
import without JAX (the machine with the GPU has none).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import scso_tpu as scso
from scso_tpu.models import losses as jlosses
from scso_tpu.models import synthetic as jsynth
import scso_tpu_torch as st
from scso_tpu_torch.algorithms.steps import GLMCache
from scso_tpu_torch.models import losses, synthetic
from scso_tpu_torch.utils.convert import (
    glm_cache_from_numpy, lbfgs_memory_from_numpy, moglm_cache_from_numpy,
    problem_from_numpy)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [
    dict(m=300, n=50, density=0.05, n_active=8, seed=7, label01=True),
    dict(m=64, n=1000, density=0.2, n_active=None, seed=3, label01=False),
    dict(m=128, n=77, density=0.01, n_active=5, seed=11, label01=True,
         dtype=np.float64),
])
def test_synthetic_is_bit_identical(kw):
    for a, b in zip(jsynth.make_sparse_logreg_data(**kw),
                    synthetic.make_sparse_logreg_data(**kw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_padded_problem_matches_jax():
    A, y, x0, _ = synthetic.make_sparse_logreg_data(
        96, 200, density=0.1, n_active=4, seed=5, dtype=np.float64,
        label01=True)
    sol = np.linspace(-1, 1, 200)
    pj = scso.Problem(A, y, x0, jlosses.logistic01_f, 0.01, sol=sol,
                      glm=jlosses.LOGISTIC01_GLM, dtype=np.float64,
                      pad_features=True)
    pt = st.Problem(A, y, x0, losses.logistic01_f, 0.01, sol=sol,
                    glm=losses.LOGISTIC01_GLM, dtype=torch.float64,
                    pad_features=True, device="cpu")
    assert pt.n_true == pj.n_true == 200
    for f in ("A", "y", "x0", "x_star", "lam"):
        assert np.array_equal(getattr(pt, f).numpy(),
                              np.asarray(getattr(pj, f))), f
    with pytest.raises(ValueError):
        st.Problem(A, y, x0, losses.logistic01_f, 0.01,
                   C_set=[-1.0, 1.0], pad_features=True, device="cpu")


def test_problem_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    A, y = rng.standard_normal((20, 8)), (rng.random(20) > 0.5) * 1.0
    x0, xs = rng.standard_normal(8), rng.standard_normal(8)
    p = problem_from_numpy(A, y, x0, 0.02, x_star=xs, L=2.0, n_true=6,
                           device="cpu")
    for got, want in ((p.A, A), (p.y, y), (p.x0, x0), (p.x_star, xs)):
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want)
    assert float(p.lam) == 0.02 and float(p.L) == 2.0 and p.n_true == 6
    assert p.glm is losses.LOGISTIC01_GLM
    for name, spec in (("lsq", losses.LSQ_GLM),
                       ("poisson", losses.POISSON_GLM)):
        assert problem_from_numpy(A, y, x0, 0.02, glm=name,
                                  device="cpu").glm is spec
    with pytest.raises(ValueError):
        problem_from_numpy(A, y, x0, 0.02, glm="probit", device="cpu")


def test_glm_cache_round_trip():
    rng = np.random.default_rng(1)
    fields = (rng.random(30), rng.standard_normal(9), rng.random(9),
              np.float64(0.6931))
    cache = glm_cache_from_numpy(*fields, device="cpu")
    assert isinstance(cache, GLMCache) and cache.loss.shape == ()
    for got, want in zip(cache, fields):
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want)


_RNG = np.random.default_rng(2)
_A, _Y = _RNG.standard_normal((12, 4)), (_RNG.random(12) > 0.5) * 1.0
_X, _W = _RNG.standard_normal(4), _RNG.random(12)


@pytest.mark.parametrize("build", [
    lambda **kw: st.Problem(_A, _Y, _X, losses.logistic01_f, 0.01,
                            glm=losses.LOGISTIC01_GLM, **kw),
    lambda **kw: problem_from_numpy(_A, _Y, _X, 0.01, **kw),
    lambda **kw: glm_cache_from_numpy(_W, _X, _X, 0.5, **kw),
    lambda **kw: moglm_cache_from_numpy(_A, _X, _X, 0.5, **kw),
    lambda **kw: lbfgs_memory_from_numpy(_A[:2], _A[2:4], 0, 1, 1.0, **kw),
], ids=["Problem", "problem_from_numpy", "glm_cache_from_numpy",
        "moglm_cache_from_numpy", "lbfgs_memory_from_numpy"])
def test_entry_points_default_to_the_card(build):
    # without device= the port goes to the card; with no card it raises
    # and never builds on the CPU by itself
    def tensors(obj):
        vals = obj if isinstance(obj, tuple) else vars(obj).values()
        return [t for t in vals if isinstance(t, torch.Tensor)]

    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tensors(build()))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert all(t.device.type == "cpu" for t in tensors(build(device="cpu")))


def test_package_imports_without_jax():
    # only what the port's own imports bring in counts
    code = ("import sys; before = set(sys.modules); import scso_tpu_torch; "
            "from scso_tpu_torch.algorithms import iterate, steps; "
            "from scso_tpu_torch.ops.cuda import build, glm_prep, matvec, "
            "mglm_matvec, score_update; "
            "from scso_tpu_torch.parallel import dataio, sharding; "
            "from scso_tpu_torch.utils import convert; "
            "bad = [m for m in set(sys.modules) - before if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'scso_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_kernel_sources_are_listed_for_the_build():
    from scso_tpu_torch.ops.cuda import build

    names = {p.name for p in build.sources()}
    assert {"matvec.cu", "glm_prep.cu", "score_update.cu",
            "mglm_matvec.cu", "common.cuh"} <= names
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    text = "".join(p.read_text() for p in build.sources())
    for base in build.SIGNATURES:
        for suffix in ("f32", "f64"):
            assert f"{base}_{suffix}" in text
