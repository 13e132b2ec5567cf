"""The port's DTLZ2, Das-Dennis sampling, metrics and tensor helpers
(``evox_tpu_torch.problems.numerical.dtlz``, ``operators.sampling``,
``metrics``, ``utils.ops``) against the JAX package's, on the CPU, with the
same numpy inputs.

Tolerances: rtol 1e-5 for DTLZ2 and IGD/GD (the two frameworks' float32
sin/cos/sqrt and sums may differ in the last bits); exact for the lattice,
``lexsort`` and the NaN-ignoring reductions (no arithmetic)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.metrics import gd as jgd  # noqa: E402
from evox_tpu.metrics import igd as jigd  # noqa: E402
from evox_tpu.operators.sampling import uniform_sampling as juniform  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.utils import lexsort as jlexsort  # noqa: E402
from evox_tpu.utils import nanmax as jnanmax  # noqa: E402
from evox_tpu.utils import nanmin as jnanmin  # noqa: E402
from evox_tpu_torch.metrics import gd, hv, igd  # noqa: E402
from evox_tpu_torch.operators.sampling import uniform_sampling  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2  # noqa: E402
from evox_tpu_torch.utils import lexsort, nanmax, nanmin, rng  # noqa: E402


@pytest.mark.parametrize("n,m", [(91, 3), (10, 2), (300, 3), (50, 5)])
def test_uniform_sampling_matches_jax_exactly(n, m):
    pts, count = uniform_sampling(n, m)
    jpts, jcount = juniform(n, m)
    assert count == jcount and pts.dtype == torch.float32
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))


@pytest.mark.parametrize("n,d,m", [(64, 12, 3), (17, 7, 2), (40, 10, 4)])
def test_dtlz2_matches_jax(n, d, m):
    x = np.random.default_rng(n + d).uniform(0, 1, (n, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = 1.0
    got, _ = DTLZ2(d=d, m=m, device="cpu").evaluate(None, torch.from_numpy(x))
    want, _ = JDTLZ2(d=d, m=m).evaluate(None, jnp.asarray(x))
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_dtlz2_pf_and_bounds_match_jax():
    p, jp = DTLZ2(d=12, m=3, device="cpu"), JDTLZ2(d=12, m=3)
    np.testing.assert_allclose(p.pf().numpy(), np.asarray(jp.pf()), rtol=1e-6)
    assert p.pf().shape == (2926, 3)
    np.testing.assert_array_equal(p.lb.numpy(), np.asarray(jp.lb))
    np.testing.assert_array_equal(p.ub.numpy(), np.asarray(jp.ub))


@pytest.mark.parametrize("p", [1, 2])
def test_igd_and_gd_match_jax(p):
    r = np.random.default_rng(p)
    objs = r.uniform(0, 1.5, (80, 3)).astype(np.float32)
    pf = r.uniform(0, 1, (200, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(igd(torch.from_numpy(objs), torch.from_numpy(pf), p)),
        float(jigd(jnp.asarray(objs), jnp.asarray(pf), p)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        float(gd(torch.from_numpy(objs), torch.from_numpy(pf))),
        float(jgd(jnp.asarray(objs), jnp.asarray(pf))), rtol=1e-5,
    )


def test_hv_single_point_is_exact_and_estimates_two_points():
    ref = torch.tensor([1.0, 1.0])
    # One point: every sample lies in its box, so the estimate is exact.
    one = hv(rng.key(0), torch.tensor([[0.5, 0.25]]), ref, num_sample=1000)
    assert float(one) == pytest.approx(0.5 * 0.75, rel=1e-6)
    # Two points: true volume 0.5*1 + 1*0.5 - 0.5*0.5 = 0.75, boxed in 1.
    two = hv(rng.key(1), torch.tensor([[0.5, 0.0], [0.0, 0.5]]), ref, num_sample=200_000)
    assert abs(float(two) - 0.75) < 6 * (0.75 * 0.25 / 200_000) ** 0.5


def _keys(seed, shape):
    """Tie-heavy keys with ±inf, NaN and signed zeros."""
    r = np.random.default_rng(seed)
    a = np.round(r.uniform(-2, 2, shape) * 2) / 2
    flat = a.reshape(-1)
    flat[:: 7] = np.nan
    flat[3:: 11] = np.inf
    flat[5:: 13] = -np.inf
    flat[2:: 17] = -0.0
    return a.astype(np.float32)


@pytest.mark.parametrize("shape,dim", [((3, 50), -1), ((2, 40, 3), 0), ((2, 6, 9), 1), ((1, 33), -1)])
def test_lexsort_matches_jnp_lexsort_exactly(shape, dim):
    keys = _keys(sum(shape), shape)
    got = lexsort(torch.from_numpy(keys), dim=dim)
    want = jlexsort(jnp.asarray(keys), dim=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # A list of keys is the same as a stacked tensor.
    got_list = lexsort([torch.from_numpy(k) for k in keys], dim=dim)
    np.testing.assert_array_equal(got_list.numpy(), got.numpy())


def test_lexsort_of_int_keys_and_refusal():
    r = np.random.default_rng(5)
    keys = r.integers(0, 3, (3, 64)).astype(np.int32)
    np.testing.assert_array_equal(
        lexsort(torch.from_numpy(keys)).numpy(), np.asarray(jlexsort(jnp.asarray(keys)))
    )
    with pytest.raises(ValueError):
        lexsort([])


@pytest.mark.parametrize("dim", [None, 0, 1])
def test_nanmin_nanmax_match_jax(dim):
    a = _keys(9, (12, 5))
    a[:, 2] = np.nan  # an all-NaN column gives NaN
    for port, ref in ((nanmin, jnanmin), (nanmax, jnanmax)):
        got = port(torch.from_numpy(a), dim=dim)
        want = np.asarray(ref(jnp.asarray(a), axis=dim))
        np.testing.assert_array_equal(got.numpy(), want)
        kept = port(torch.from_numpy(a), dim=0, keepdim=True)
        assert kept.shape == (1, 5)


# DTLZ1 and DTLZ3-7: rtol 1e-5 for the objectives and fronts (float32
# sin/cos/pow may differ in the last bits), bounds exactly.
from evox_tpu.problems import numerical as jnumerical  # noqa: E402
from evox_tpu_torch.problems import numerical  # noqa: E402

SUITE = ["DTLZ1", "DTLZ3", "DTLZ4", "DTLZ5", "DTLZ6", "DTLZ7"]


@pytest.mark.parametrize("name", SUITE)
@pytest.mark.parametrize("n,d,m", [(64, 12, 3), (33, 8, 2), (40, 10, 4)])
def test_dtlz_suite_matches_jax(name, n, d, m):
    x = np.random.default_rng(n + d + m).uniform(0, 1, (n, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = 1.0
    x[2] = 0.5
    got, _ = getattr(numerical, name)(d=d, m=m, device="cpu").evaluate(None, torch.from_numpy(x))
    want, _ = getattr(jnumerical, name)(d=d, m=m).evaluate(None, jnp.asarray(x))
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SUITE)
@pytest.mark.parametrize("m,ref_num", [(2, 100), (3, 100), (3, 1000)])
def test_dtlz_suite_pf_and_bounds_match_jax(name, m, ref_num):
    p = getattr(numerical, name)(m=m, ref_num=ref_num, device="cpu")
    jp = getattr(jnumerical, name)(m=m, ref_num=ref_num)
    got, want = p.pf(), np.asarray(jp.pf())
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(p.lb.numpy(), np.asarray(jp.lb))
    np.testing.assert_array_equal(p.ub.numpy(), np.asarray(jp.ub))
