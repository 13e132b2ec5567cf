"""p-best selection (counterpart of
``evox_tpu/operators/selection/find_pbest.py``): for each individual, a
random member of the best ``percent`` fraction of the population, as used
by JaDE, SHADE and the strategy-coded DE variants."""

from __future__ import annotations

import torch

from ...ops.philox import philox_draws
from ...utils import rng

__all__ = ["select_rand_pbest", "pbest_count"]


def pbest_count(pop_size: int, percent: float) -> int:
    """Size of the p-best pool: ``max(int(pop_size * percent), 1)``."""
    return max(int(pop_size * percent), 1)


def select_rand_pbest(
    seed,
    percent: float,
    population: torch.Tensor,
    fitness: torch.Tensor,
    draws: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(pop_size, dim)`` p-best vectors, one per individual: the pool is
    the first ``pbest_count`` rows of a stable argsort of the fitness (NaN
    last, ties by index, as ``jnp.argsort``).

    :param seed: a :class:`~evox_tpu_torch.utils.rng.Seed` or a key tensor
        (one draw launch).
    :param draws: the (pop_size,) int64 positions in the pool, in
        ``[0, pbest_count)``.
    """
    n = population.shape[0]
    top = pbest_count(n, percent)
    pool = torch.argsort(fitness, stable=True)[:top]
    if draws is None:
        (draws,) = philox_draws(rng.as_seed(seed), n, [(0, top)], population.device)
    return population[pool[draws]]
