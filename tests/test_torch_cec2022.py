"""The port's CEC2022 suite (``evox_tpu_torch.problems.numerical.cec2022``)
against the float64 oracle ``tests/cec2022_golden.json`` and against the
JAX package's ``CEC2022`` on the same numpy inputs, on the CPU.

Tolerances:
- float64 against the oracle: rtol 1e-8, the JAX package's own limit
  (``tests/test_cec2022.py``).
- float32 against JAX (jitted, as its tests run it), whole functions and
  the basic functions alone: rtol 2e-4 (atol 1e-4 for basic-function
  values that cancel to near zero).  The two frameworks round the
  transcendentals (and ``hypot``) differently in the last place, and the
  port takes the (n, d) x (d, d) rotation in float64 where JAX sums it in
  float32, so a rotated coordinate differs by a few units in the last
  place of values up to ~900; F3 and F5 take sines of arguments up to
  ~400, where one float32 unit is 3e-5, and Zakharov (F1) raises a
  cancelling weighted sum to the fourth power.  Measured on 10,000 seeded
  rows: 6.1e-5 at most (F1, D=20), 3e-6 or less for F2-F4 and F6-F12.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.problems.numerical import CEC2022 as JCEC2022  # noqa: E402
from evox_tpu.problems.numerical import cec2022 as jcec  # noqa: E402
from evox_tpu_torch.problems.numerical import CEC2022  # noqa: E402
from evox_tpu_torch.problems.numerical import cec2022  # noqa: E402

with open(os.path.join(os.path.dirname(__file__), "cec2022_golden.json")) as f:
    _DATA = json.load(f)

CASES = sorted(_DATA["golden"], key=lambda k: tuple(map(int, k.split("_"))))
PAIRS = [tuple(map(int, c.split("_"))) for c in CASES]
F32_RTOL = 2e-4
BASIC = [
    "_zakharov", "_rosenbrock", "_schaffer_f7", "_rastrigin", "_levy", "_bent_cigar", "_hgbat",
    "_katsuura", "_ackley", "_schwefel", "_escaffer6", "_happycat", "_grie_rosen", "_griewank",
    "_discus", "_ellips",
]


def test_every_defined_pair_has_a_golden_case():
    assert len(PAIRS) == 33
    want = {(fn, d) for d in (2, 10, 20) for fn in range(1, 13) if not (fn in (6, 7, 8) and d == 2)}
    assert set(PAIRS) == want


@pytest.mark.parametrize("case", CASES)
def test_float64_matches_the_oracle(case):
    fn, d = map(int, case.split("_"))
    prob = CEC2022(fn, d, dtype=torch.float64, device="cpu")
    x = torch.tensor(_DATA["inputs"][str(d)], dtype=torch.float64)
    fit, state = prob.evaluate(None, x)
    assert fit.dtype == torch.float64 and fit.shape == (x.shape[0],) and state is None
    np.testing.assert_allclose(fit.numpy(), np.asarray(_DATA["golden"][case]), rtol=1e-8)


def _rows(fn, d, jprob, seed):
    """Seeded rows in the box, the origin, and every shift point of the
    function (each composition component's, exactly on it)."""
    r = np.random.default_rng(seed)
    x = r.uniform(-100, 100, (96, d)).astype(np.float32)
    shifts = np.asarray(jprob.shift, dtype=np.float32).reshape(-1, d)
    return np.concatenate([x, np.zeros((1, d), np.float32), shifts])


def _jax_eval(jprob, x):
    return np.asarray(jax.jit(lambda p: jprob.evaluate(JState(), p)[0])(jnp.asarray(x)))


@pytest.mark.parametrize("fn,d", PAIRS)
def test_float32_matches_jax(fn, d):
    jprob = JCEC2022(fn, d)
    prob = CEC2022(fn, d, device="cpu")
    np.testing.assert_array_equal(prob.shift.numpy(), np.asarray(jprob.shift))
    np.testing.assert_array_equal(prob.M.numpy(), np.asarray(jprob.M))
    if jprob.SS is not None:
        np.testing.assert_array_equal(prob.SS.numpy(), np.asarray(jprob.SS)[:d])
    x = _rows(fn, d, jprob, seed=100 * fn + d)
    got, _ = prob.evaluate(None, torch.from_numpy(x))
    want = _jax_eval(jprob, x)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)


@pytest.mark.parametrize("fn", [9, 10, 11, 12])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_composition_exactly_on_a_shift_selects_that_component(fn, dtype):
    """A row exactly on component i's shift gets component i's value
    alone (its bias and the function's), finite, as the JAX package's
    one-hot; a row on two shifts at once would take the first."""
    d = 10
    dt = getattr(torch, dtype)
    prob = CEC2022(fn, d, dtype=dt, device="cpu")
    shifts = prob.shift.reshape(-1, d)
    n_comp = len(cec2022._COMPOSITION[fn][0])
    fit, _ = prob.evaluate(None, shifts[:n_comp])
    assert bool(torch.isfinite(fit).all())
    _, biases, parts, f_bias = cec2022._COMPOSITION[fn]
    for i, (basic, rate, rotate, scale) in enumerate(parts):
        z = prob._sr(shifts[i : i + 1], rate, rotate, shifts[i], prob.M[:, i * d : (i + 1) * d])
        want = basic(z) * scale + biases[i] + f_bias
        torch.testing.assert_close(fit[i : i + 1], want, rtol=0, atol=0)
    if dtype == "float32":
        jprob = JCEC2022(fn, d)
        np.testing.assert_allclose(fit.numpy(), _jax_eval(jprob, shifts[:n_comp].numpy()), rtol=F32_RTOL)
    if fn == 9:
        torch.testing.assert_close(fit[:1], torch.tensor([2300.0], dtype=dt), rtol=0, atol=1e-2)


def _basic_inputs(width, seed):
    r = np.random.default_rng(seed)
    x = r.uniform(-100, 100, (64, width))
    # Schwefel's three regions (z = x + 420.97: above 500, below -500 and
    # between), the origin and large values.
    x = np.concatenate([
        x, r.uniform(100, 2000, (8, width)), r.uniform(-2000, -930, (8, width)),
        r.uniform(-900, 70, (8, width)), np.zeros((1, width)), np.full((1, width), 1e3),
    ])
    return x.astype(np.float32)


# The ellipsoid divides by d - 1, so it has no width-1 case.
@pytest.mark.parametrize(
    "name,width", [(n, w) for n in BASIC for w in (1, 2, 10) if not (n == "_ellips" and w == 1)]
)
def test_basic_functions_match_jax(name, width):
    x = _basic_inputs(width, seed=width * 31 + len(name))
    got = getattr(cec2022, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(getattr(jcec, name))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-4)


def test_schwefel_regions_are_each_reached():
    x = _basic_inputs(10, 0)
    z = x + 420.9687462275036
    assert (z > 500).any() and (z < -500).any() and ((z >= -500) & (z <= 500)).any()


def test_simple_functions_give_their_bias_at_the_shift():
    for fn, (_, _, bias) in cec2022._SIMPLE.items():
        prob = CEC2022(fn, 10, dtype=torch.float64, device="cpu")
        fit, _ = prob.evaluate(None, prob.shift[None, :])
        torch.testing.assert_close(fit, torch.tensor([bias], dtype=torch.float64), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn,d", [(6, 2), (7, 2), (8, 2), (1, 5), (1, 30), (0, 10), (13, 10), (-1, 20)])
def test_undefined_combinations_are_refused(fn, d):
    with pytest.raises(ValueError):
        CEC2022(fn, d, device="cpu")


def test_dimension_mismatch_is_refused():
    prob = CEC2022(1, 10, device="cpu")
    with pytest.raises(ValueError, match="Dimension mismatch"):
        prob.evaluate(None, torch.zeros(3, 20))


def test_bounds_and_placement():
    prob = CEC2022(5, 20, device="cpu")
    assert prob.lb.shape == (20,) and float(prob.lb.min()) == -100.0 and float(prob.ub.max()) == 100.0
    assert prob.lb.dtype == torch.float32 and prob.M.device.type == "cpu"
    assert prob.M.shape == (20, 20) and CEC2022(12, 20, device="cpu").M.shape == JCEC2022(12, 20).M.shape


def test_missing_data_directory_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(cec2022, "_DATA_DIR", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="data directory"):
        CEC2022(1, 10, device="cpu")


def test_rotation_runs_without_tf32_and_restores_the_setting(monkeypatch):
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((a.dtype, b.dtype, torch.backends.cuda.matmul.allow_tf32))
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        out, _ = CEC2022(9, 10, device="cpu").evaluate(None, torch.zeros(4, 10))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    # F9 rotates four of its five components, each as a float64 product
    # (which TF32 never reaches), with the process's setting left alone.
    assert seen == [(torch.float64, torch.float64, True)] * 4
    assert out.dtype == torch.float32


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_rotation_is_the_same_under_every_matmul_precision(precision):
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.uniform(-100, 100, (64, 10)).astype(np.float32))
    problem = CEC2022(9, 10, device="cpu")
    try:
        torch.set_float32_matmul_precision("highest")
        want, _ = problem.evaluate(None, x)
        torch.set_float32_matmul_precision(precision)
        got, _ = problem.evaluate(None, x)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        # torch's default, and what ShiftAffineNumericalProblem sets.
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(got, want)
