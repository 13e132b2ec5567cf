"""The port's grid and Latin-hypercube sampling
(``evox_tpu_torch.operators.sampling``) against the JAX package's, on the
CPU.  The grid is compared exactly (no arithmetic beyond ``linspace``);
LHS, given the same uniforms as JAX draws, exactly as well (a stable
argsort, an add and a divide)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.operators.sampling import grid_sampling as jgrid  # noqa: E402
from evox_tpu.operators.sampling import latin_hypercube_sampling as jlhs  # noqa: E402
from evox_tpu.operators.sampling import latin_hypercube_sampling_standard as jlhs_std  # noqa: E402
from evox_tpu_torch.operators.sampling import (  # noqa: E402
    grid_sampling,
    latin_hypercube_sampling,
    latin_hypercube_sampling_standard,
)
from evox_tpu_torch.utils import rng  # noqa: E402


@pytest.mark.parametrize("n,m", [(3000, 2), (100, 3), (10, 1), (500, 4), (7, 2)])
def test_grid_sampling_matches_jax_exactly(n, m):
    pts, count = grid_sampling(n, m)
    jpts, jcount = jgrid(n, m)
    assert count == jcount and pts.dtype == torch.float32 and pts.shape == (count, m)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))


def _jax_uniforms(key, n, d):
    perm_key, jitter_key = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(perm_key, (n, d)))),
            torch.from_numpy(np.array(jax.random.uniform(jitter_key, (n, d)))))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("n,d", [(10, 3), (64, 5), (1, 2)])
def test_lhs_standard_matches_jax_given_its_uniforms(n, d, smooth):
    key = jax.random.key(n * d)
    want = jlhs_std(key, n, d, smooth)
    got = latin_hypercube_sampling_standard(None, n, d, smooth, draws=_jax_uniforms(key, n, d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lhs_in_a_box_matches_jax_given_its_uniforms():
    lb = np.array([-1.0, 0.0, 2.0], np.float32)
    ub = np.array([1.0, 0.5, 7.0], np.float32)
    key = jax.random.key(4)
    want = jlhs(key, 20, jnp.asarray(lb), jnp.asarray(ub))
    got = latin_hypercube_sampling(None, 20, torch.from_numpy(lb), torch.from_numpy(ub),
                                   draws=_jax_uniforms(key, 20, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_lhs_own_draws_fill_every_stratum_once():
    n, d = 50, 4
    s = latin_hypercube_sampling_standard(rng.key(1), n, d, device="cpu")
    assert s.shape == (n, d) and float(s.min()) >= 0.0 and float(s.max()) < 1.0
    strata = torch.floor(s * n).to(torch.int64)
    for j in range(d):
        assert torch.equal(torch.sort(strata[:, j]).values, torch.arange(n))
    box = latin_hypercube_sampling(rng.key(1), n, torch.zeros(d), torch.full((d,), 2.0))
    assert torch.equal(box, 2.0 * s)
    with pytest.raises(ValueError):
        latin_hypercube_sampling(rng.key(1), n, torch.zeros(d, 1), torch.ones(d, 1))
