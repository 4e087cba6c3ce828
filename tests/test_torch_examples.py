"""The port's examples (examples/torch/NN_*.py) on the CPU: each
``main(device='cpu')`` with tests/test_examples.py's assertions, and,
where both run in float64, the final objective within 1e-8 relative of
the JAX package's example (examples/NN_*.py) on the same data."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-8  # relative, on the final objective of the float64 examples


def _load(path: Path, prefix: str):
    """The example at ``path`` as a module of its own name (the two
    packages' examples share file names)."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    mod = _load(ROOT / "examples" / "torch" / f"{name}.py", "torch_example")
    return mod.main(device="cpu")


def _jax(name):
    return _load(ROOT / "examples" / f"{name}.py", "jax_example").main()


def _final(sol) -> float:
    return float(np.asarray(sol.obj)[-1])


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _descends(sol):
    assert _final(sol) <= float(np.asarray(sol.obj)[0])


def _rosenbrock(sol):
    np.testing.assert_allclose(_np(sol.x), [1.0, 1.0], atol=1e-3)


def _group_lasso(sol):
    assert float(sol.rel[-1]) < 0.5


def _box_qp(sol):
    assert np.all(np.abs(_np(sol.x)) <= 1 + 1e-9)


def _scaleout(res):
    assert res.batch_size == 8
    assert np.all(np.isfinite(_np(res.obj)))


def _poisson(sol):
    _descends(sol)
    # l1 at this lambda must actually sparsify (192 features, ~30 kept)
    assert int((np.abs(_np(sol.x)) > 1e-4).sum()) < 60


def _finite(sol):
    assert np.all(np.isfinite(_np(sol.x)))


def _finite_descends(sol):
    _finite(sol)
    _descends(sol)


#: example → (tests/test_examples.py's check, how its result is held to
#: the JAX example's: "f64" both run in float64, final objective within
#: RTOL; "f32" float32, not compared; "C12" float64, its final objective
#: differs beyond RTOL — ROADMAP Queue C, C12: the returned solve is
#: L-BFGS, which carries last-ulp differences of the two packages' sums
#: into 1.02e-8 (01), 4.33e-7 (03) and 1.06e-3 (07: 300 epochs, not
#: converged) relative — so only its own check runs)
CASES = {
    "01_rosenbrock_l1": (_rosenbrock, "C12"),
    "02_sparse_logistic": (_descends, "f64"),
    "03_group_lasso": (_group_lasso, "C12"),
    "04_box_qp": (_box_qp, "f64"),
    "05_scaleout": (_scaleout, "f32"),
    "06_checkpoint_profile": (_descends, "f64"),
    "07_poisson": (_poisson, "C12"),
    "08_multinomial": (_descends, "f64"),
    "09_federated": (_finite, "f64"),
    "10_continuation": (_finite_descends, "f64"),
    "11_outofcore_bigrows": (_finite_descends, "f32"),
}


def test_every_jax_example_has_a_port():
    jax_names = sorted(p.stem for p in (ROOT / "examples").glob("[0-9]*.py"))
    port_names = sorted(p.stem for p in
                        (ROOT / "examples" / "torch").glob("[0-9]*.py"))
    assert jax_names == port_names == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example(name):
    check, held = CASES[name]
    got = _port(name)
    check(got)
    if held != "f64":
        return
    ref = _jax(name)
    check(ref)
    assert got.epochs == ref.epochs
    np.testing.assert_allclose(_final(got), _final(ref), rtol=RTOL, atol=0)
