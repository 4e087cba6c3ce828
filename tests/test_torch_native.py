"""The port's native data generator (`scso_tpu_torch._native`, the JAX
package's datagen.cpp built by the port) against the JAX package's
`scso_tpu._native`: the same seed gives the same arrays, bit for bit,
where g++ builds both; the numpy path is unchanged."""

import numpy as np
import pytest

from scso_tpu import _native as jnative
from scso_tpu.models import synthetic as jsynth
from scso_tpu_torch import _native
from scso_tpu_torch.models import synthetic

needs_toolchain = pytest.mark.skipif(
    not (_native.available() and jnative.available()),
    reason="no C++ toolchain built the native generator")


@needs_toolchain
@pytest.mark.parametrize("m,n,density,n_active,seed,label01", [
    (512, 64, 0.1, 8, 7, True),
    (300, 37, 0.05, 0, 3, False),
])
def test_native_stream_is_the_jax_packages(m, n, density, n_active, seed,
                                           label01):
    got = synthetic.make_sparse_logreg_data(
        m, n, density, n_active, seed, label01=label01, backend="native")
    want = jnative.sparse_logreg(m, n, density, n_active, seed, label01)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(_native.randn(64, 33, 5), jnative.randn(64, 33, 5))
    f64 = synthetic.make_sparse_logreg_data(
        m, n, density, n_active, seed, dtype=np.float64, label01=label01,
        backend="native")
    assert all(a.dtype == np.float64 and np.array_equal(a, b.astype(
        np.float64)) for a, b in zip(f64, want))
    assert _native.threads() >= 1


def test_numpy_path_unchanged():
    for kw in (dict(label01=True), dict(n_active=5, dtype=np.float64)):
        got = synthetic.make_sparse_logreg_data(96, 24, 0.2, seed=4, **kw)
        want = jsynth.make_sparse_logreg_data(96, 24, 0.2, seed=4, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_falls_back_to_numpy_without_the_library(monkeypatch):
    monkeypatch.setattr(_native, "sparse_logreg", lambda *a: None)
    got = synthetic.make_sparse_logreg_data(64, 16, 0.2, seed=2,
                                            backend="native")
    want = synthetic.make_sparse_logreg_data(64, 16, 0.2, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
