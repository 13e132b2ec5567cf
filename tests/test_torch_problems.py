"""The seven basic numerical problems of the port against
``evox_tpu.problems.numerical.basic``, with and without shift/affine.

Same float32 inputs (numpy, seeded) through both frameworks; tolerance rtol
1e-5 (atol 1e-5 times the output's scale), because the row sums are taken
in another order."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import evox_tpu.problems.numerical.basic as jbasic  # noqa: E402
import evox_tpu_torch.problems.numerical.basic as tbasic  # noqa: E402

NAMES = ["Ackley", "Griewank", "Rastrigin", "Rosenbrock", "Schwefel", "Sphere", "Ellipsoid"]
N, D = 16, 7


def _inputs(seed):
    r = np.random.default_rng(seed)
    pop = r.uniform(-5, 5, (N, D)).astype(np.float32)
    shift = r.uniform(-1, 1, D).astype(np.float32)
    affine = (np.eye(D) + 0.1 * r.standard_normal((D, D))).astype(np.float32)
    return pop, shift, affine


@pytest.mark.parametrize("transform", ["plain", "shift", "affine", "shift+affine"])
@pytest.mark.parametrize("name", NAMES)
def test_problem_matches_jax(name, transform):
    pop, shift, affine = _inputs(NAMES.index(name))
    kw_np = {}
    if "shift" in transform:
        kw_np["shift"] = shift
    if "affine" in transform:
        kw_np["affine"] = affine
    jprob = getattr(jbasic, name)(**{k: jnp.asarray(v) for k, v in kw_np.items()})
    tkw = {k: torch.from_numpy(v) for k, v in kw_np.items()}
    if tkw:
        tkw["device"] = "cpu"
    tprob = getattr(tbasic, name)(**tkw)
    want, _ = jprob.evaluate(jprob.setup(None), jnp.asarray(pop))
    got, st = tprob.evaluate(tprob.setup(None), torch.from_numpy(pop))
    assert got.shape == (N,) and got.dtype == torch.float32
    assert len(st) == 0
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max())
    )


@pytest.mark.parametrize(
    "fn", ["ackley_func", "griewank_func", "rastrigin_func", "rosenbrock_func",
           "schwefel_func", "sphere_func", "ellipsoid_func"]
)
def test_functions_match_jax(fn):
    pop = np.random.default_rng(5).uniform(-3, 3, (N, D)).astype(np.float32)
    args = (20.0, 0.2, 2 * np.pi) if fn == "ackley_func" else ()
    want = np.asarray(getattr(jbasic, fn)(*args, jnp.asarray(pop)))
    got = getattr(tbasic, fn)(*args, torch.from_numpy(pop)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_bad_transforms_raise():
    with pytest.raises(ValueError):
        tbasic.Sphere(affine=np.ones((2, 3)), device="cpu")
    with pytest.raises(ValueError):
        tbasic.Sphere(shift=np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError):
        tbasic.Sphere(shift=np.ones(3), affine=np.eye(2), device="cpu")
