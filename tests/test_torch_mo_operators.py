"""The port's NSGA-II operators (``evox_tpu_torch.operators``: SBX,
polynomial mutation, tournaments) against the JAX package's, on the CPU.

The two frameworks' random streams differ, so each operator is handed the
draws JAX makes from its key (the ``draws=`` / ``parents=`` arguments).
Tolerances: rtol 1e-5 for SBX and mutation (float32 ``pow`` may differ in
the last bits between the two), exact for the tournaments (no arithmetic).
The port's own draws are checked for range, balance and the one Philox
evaluation per operator call."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.operators.crossover import simulated_binary as jsbx  # noqa: E402
from evox_tpu.operators.crossover import simulated_binary_half as jsbx_half  # noqa: E402
from evox_tpu.operators.mutation import polynomial_mutation as jpm  # noqa: E402
from evox_tpu.operators.selection import tournament_selection as jtour  # noqa: E402
from evox_tpu.operators.selection import tournament_selection_multifit as jtour_multi  # noqa: E402
from evox_tpu_torch.operators.crossover import simulated_binary, simulated_binary_half  # noqa: E402
from evox_tpu_torch.operators.crossover import sbx as sbx_mod  # noqa: E402
from evox_tpu_torch.operators.mutation import pm_mutation as pm_mod  # noqa: E402
from evox_tpu_torch.operators.mutation import polynomial_mutation  # noqa: E402
from evox_tpu_torch.operators.selection import (  # noqa: E402
    tournament_selection,
    tournament_selection_multifit,
)
from evox_tpu_torch.utils import rng  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def jax_sbx_draws(key, shape, dtype=jnp.float32):
    """The draws JAX's ``_sbx_beta`` makes from ``key``."""
    mu_key, dir_key, p1_key, p2_key = jax.random.split(key, 4)
    return (
        t(jax.random.uniform(mu_key, shape, dtype=dtype)),
        t(jax.random.randint(dir_key, shape, 0, 2)),
        t(jax.random.uniform(p1_key, shape, dtype=dtype)),
        t(jax.random.uniform(p2_key, shape, dtype=dtype)),
    )


def jax_pm_draws(key, shape, dtype=jnp.float32):
    """The draws JAX's ``polynomial_mutation`` makes from ``key``."""
    site_key, mu_key = jax.random.split(key)
    return (
        t(jax.random.uniform(site_key, shape, dtype=dtype)),
        t(jax.random.uniform(mu_key, shape, dtype=dtype)),
    )


@pytest.mark.parametrize("n,d", [(64, 12), (33, 5), (2, 3)])
@pytest.mark.parametrize("pro_c", [1.0, 0.7])
def test_sbx_matches_jax_with_its_draws(n, d, pro_c):
    x = np.random.default_rng(n).uniform(0, 1, (n, d)).astype(np.float32)
    key = jax.random.key(n * 3 + d)
    draws = jax_sbx_draws(key, (n // 2, d))
    got = simulated_binary(None, t(x), pro_c=pro_c, draws=draws)
    want = jsbx(key, jnp.asarray(x), pro_c=pro_c)
    assert got.shape == (2 * (n // 2), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got_h = simulated_binary_half(None, t(x), pro_c=pro_c, draws=draws)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(jsbx_half(key, jnp.asarray(x), pro_c=pro_c)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d", [(64, 12), (20, 3)])
@pytest.mark.parametrize("pro_m", [1.0, 5.0])
def test_polynomial_mutation_matches_jax_with_its_draws(n, d, pro_m):
    x = np.random.default_rng(d).uniform(-0.2, 1.2, (n, d)).astype(np.float32)
    lb, ub = np.zeros(d, np.float32), np.ones(d, np.float32)
    key = jax.random.key(n + d)
    got = polynomial_mutation(None, t(x), t(lb), t(ub), pro_m=pro_m, draws=jax_pm_draws(key, (n, d)))
    want = jpm(key, jnp.asarray(x), jnp.asarray(lb), jnp.asarray(ub), pro_m=pro_m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_round,size", [(50, 2), (20, 3)])
def test_tournaments_match_jax_with_its_candidates(n_round, size):
    r = np.random.default_rng(n_round)
    fit = np.round(r.uniform(0, 1, 40) * 4).astype(np.float32)
    dis = np.round(r.uniform(0, 1, 40) * 4).astype(np.float32)
    dis[::5] = np.inf
    key = jax.random.key(size)
    parents = t(jax.random.randint(key, (n_round, size), 0, 40)).to(torch.int64)
    got = tournament_selection(None, n_round, t(fit), size, parents=parents)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtour(key, n_round, jnp.asarray(fit), size)))
    got = tournament_selection_multifit(None, n_round, [t(-dis), t(fit)], size, parents=parents)
    want = jtour_multi(key, n_round, [jnp.asarray(-dis), jnp.asarray(fit)], size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_range_and_balance():
    v = rng.randint(3, (100_000,), -2, 5, device="cpu")
    assert v.dtype == torch.int64 and int(v.min()) == -2 and int(v.max()) == 4
    counts = torch.bincount(v + 2, minlength=7).double()
    assert float((counts / 100_000 - 1 / 7).abs().max()) < 0.01
    assert torch.equal(v, rng.randint(3, (100_000,), -2, 5, device="cpu"))
    with pytest.raises(ValueError):
        rng.randint(0, (3,), 2, 2, device="cpu")


def test_one_philox_evaluation_per_operator(monkeypatch):
    calls = []
    real = rng.philox_words

    def counting(seed, numel, device):
        calls.append(numel)
        return real(seed, numel, device)

    monkeypatch.setattr(rng, "philox_words", counting)
    x = torch.rand(40, 6)
    k = rng.key(0)
    simulated_binary(k, x)
    assert calls == [20 * 6]
    polynomial_mutation(k, x, torch.zeros(6), torch.ones(6))
    assert calls == [20 * 6, 40 * 6]
    tournament_selection_multifit(k, 40, [x[:, 0], x[:, 1]])
    assert calls == [20 * 6, 40 * 6, 40 * 2]


def test_own_draws_are_in_range_and_keyed():
    mu, direction, p1, p2 = sbx_mod.sbx_draws(rng.key(1), (500, 8), torch.float32, "cpu")
    for u in (mu, p1, p2):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02
    assert set(direction.unique().tolist()) == {0, 1}
    assert not torch.equal(mu, p1)
    site, mu2 = pm_mod.pm_draws(rng.key(1), (500, 8), torch.float32, "cpu")
    assert not torch.equal(site, mu2) and float(mu2.max()) < 1.0
    x = torch.rand(30, 4)
    a = simulated_binary(rng.key(5), x)
    assert torch.equal(a, simulated_binary(rng.key(5), x))
    assert not torch.equal(a, simulated_binary(rng.key(6), x))
