"""Tournament selection (counterpart of
``evox_tpu/operators/selection/tournament_selection.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

from ...utils import lexsort, rng

__all__ = ["tournament_selection", "tournament_selection_multifit"]


def _candidates(key, n_round, tournament_size, num_candidates, device, parents):
    if parents is not None:
        return parents
    return rng.randint(rng.child(key), (n_round, tournament_size), 0, num_candidates, device)


def tournament_selection(
    key: torch.Tensor | None,
    n_round: int,
    fitness: torch.Tensor,
    tournament_size: int = 2,
    parents: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-fitness k-tournament: for each of ``n_round`` rounds draw
    ``tournament_size`` random candidates and keep the argmin-fitness one.

    :param parents: (n_round, tournament_size) candidate indices to use
        instead of drawing them from ``key``.
    :return: ``(n_round,)`` indices of the winners.
    """
    parents = _candidates(
        key, n_round, tournament_size, fitness.shape[0], fitness.device, parents
    )
    winners = torch.argmin(fitness[parents], dim=1)
    return torch.take_along_dim(parents, winners[:, None], dim=1).squeeze(1)


def tournament_selection_multifit(
    key: torch.Tensor | None,
    n_round: int,
    fitnesses: Sequence[torch.Tensor],
    tournament_size: int = 2,
    parents: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-fitness k-tournament: winners decided lexicographically over the
    fitness list (last entry most significant, the numpy ``lexsort``
    convention)."""
    fitness_tensor = torch.stack(list(fitnesses), dim=1)  # (n, k)
    parents = _candidates(
        key, n_round, tournament_size, fitness_tensor.shape[0],
        fitness_tensor.device, parents,
    )
    cand = fitness_tensor[parents]  # (n_round, tournament_size, k)
    order = lexsort([cand[..., i] for i in range(cand.shape[-1])])
    return torch.take_along_dim(parents, order[:, :1], dim=1).squeeze(1)
