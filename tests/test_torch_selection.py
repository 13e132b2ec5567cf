"""The port's non-dominated sorting and NSGA-II survivor selection
(``evox_tpu_torch.operators.selection.non_dominate``) against the JAX
package's, on the CPU, with the same numpy inputs.

Every comparison is exact: ranks equal, crowding distances equal bit for
bit (NaN at the same places), survivors in the same order — ties, ±inf,
NaN rows and masks included.  JAX's packed route
(``_non_dominate_rank_packed``), which it takes by default above 2048 rows,
is called directly at the small sizes used here."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.operators.selection import crowding_distance as jcrowding  # noqa: E402
from evox_tpu.operators.selection import dominate_relation as jrelation  # noqa: E402
from evox_tpu.operators.selection import nd_environmental_selection as jselect  # noqa: E402
from evox_tpu.operators.selection import non_dominate_rank as jrank  # noqa: E402
from evox_tpu.operators.selection.non_dominate import _non_dominate_rank_packed  # noqa: E402
from evox_tpu_torch.operators.selection import (  # noqa: E402
    crowding_distance,
    dominate_relation,
    nd_environmental_selection,
    non_dominate_rank,
)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.tobytes(), np.where(np.isnan(want), got, want).tobytes())


def _front_like(seed, n, m, specials=False):
    """Evolved-like objectives: noise plus a drift (fronts of realistic
    width), quantized to 1/16 for ties."""
    r = np.random.default_rng(seed)
    f = r.normal(size=(n, m)) + np.linspace(0.0, 3.0, n)[:, None]
    f = (np.round(f * 16) / 16).astype(np.float32)
    if specials:
        f[2, 0] = np.inf
        f[4, 1] = -np.inf
        f[6] = np.nan
    return f


@pytest.mark.parametrize("n,m", [(20, 2), (50, 3)])
def test_dominate_relation_matches_jax(n, m):
    x, y = _front_like(n, n, m, True), _front_like(n + 1, n + 3, m)
    got = dominate_relation(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrelation(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("n,m", [(1, 2), (33, 2), (100, 3), (256, 3)])
@pytest.mark.parametrize("specials", [False, True])
def test_non_dominate_rank_matches_both_jax_routes(n, m, specials):
    f = _front_like(n * 3 + m, n, m, specials and n > 8)
    got = non_dominate_rank(torch.from_numpy(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank(jnp.asarray(f))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_non_dominate_rank_packed(jnp.asarray(f))))


@pytest.mark.parametrize("until", [1, 10, 64, 200])
def test_non_dominate_rank_until_count_matches_jax(until):
    f = _front_like(until, 200, 3)
    got = non_dominate_rank(torch.from_numpy(f), until_count=until)
    want = _non_dominate_rank_packed(jnp.asarray(f), until)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank(jnp.asarray(f), until_count=until)))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 200])
@pytest.mark.parametrize("until", ["none", "one", "half", "all"])
def test_non_dominate_rank_cpu_route_is_the_plain_peel_and_matches_jax(n, until):
    """On a CPU tensor non_dominate_rank is the plain peel over the plain
    words (what the card's two kernels are held to), and equals both JAX
    routes bit for bit; ties, ±inf and NaN rows included."""
    from evox_tpu_torch.ops import dominance

    f = _front_like(n * 7 + 2, n, 3, specials=n > 8)
    u = {"none": None, "one": 1, "half": n // 2, "all": n}[until]
    got = non_dominate_rank(torch.from_numpy(f), until_count=u)
    plain = dominance.peel_fronts_plain(dominance.dominance_packed_plain(torch.from_numpy(f)), u)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(_non_dominate_rank_packed(jnp.asarray(f), u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank(jnp.asarray(f), until_count=u)))


@pytest.mark.parametrize("n,m", [(2, 2), (37, 3), (130, 4), (256, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_crowding_distance_matches_jax(n, m, masked):
    f = _front_like(n + m, n, m, specials=n > 8)
    mask = np.random.default_rng(n).uniform(0, 1, n) > 0.3 if masked else None
    got = crowding_distance(torch.from_numpy(f), None if mask is None else torch.from_numpy(mask))
    want = jcrowding(jnp.asarray(f), None if mask is None else jnp.asarray(mask))
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,m,topk", [(64, 5, 3, 32), (200, 4, 2, 100), (150, 6, 3, 40), (40, 3, 3, 40)])
@pytest.mark.parametrize("specials", [False, True])
def test_nd_environmental_selection_matches_jax_bitwise(n, d, m, topk, specials):
    r = np.random.default_rng(n + topk)
    x = r.uniform(0, 1, (n, d)).astype(np.float32)
    f = _front_like(n * 5 + d, n, m, specials)
    got = nd_environmental_selection(torch.from_numpy(x), torch.from_numpy(f), topk)
    want = jselect(jnp.asarray(x), jnp.asarray(f), topk)
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)
