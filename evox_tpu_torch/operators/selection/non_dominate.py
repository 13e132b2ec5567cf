"""Non-dominated sorting, crowding distance and NSGA-II environmental
selection (counterpart of
``evox_tpu/operators/selection/non_dominate.py``).

On a CUDA tensor every step goes through the port's kernels: the dominance
relation is built as bit-packed words (:func:`~evox_tpu_torch.ops.dominance.
dominance_packed`, which replaces both the JAX package's XLA packed route
and its opt-in dense kernel) and the fronts are peeled with popcounts over
them on the card (:func:`~evox_tpu_torch.ops.dominance.peel_fronts`, the
counterpart of JAX's ``_peel_fronts`` while loop: one cooperative launch,
no host sync); the worst surviving rank comes from
:func:`~evox_tpu_torch.ops.topk.masked_top_k`; the crowding distance from
the neighbour kernel.  On a CPU tensor each step runs its plain version.
The ranks, distances and survivors are the same either way.
"""

from __future__ import annotations

import torch

from ...ops.crowding import crowding_distance_kernel, crowding_distance_plain
from ...ops.dominance import dominance_packed, dominate_relation, peel_fronts
from ...ops.topk import masked_top_k
from ...utils import lexsort

__all__ = [
    "dominate_relation",
    "non_dominate_rank",
    "crowding_distance",
    "nd_environmental_selection",
]


def non_dominate_rank(f: torch.Tensor, until_count: int | None = None) -> torch.Tensor:
    """Non-domination rank (int32) of each row of ``f`` (n, m): rank 0 is
    the Pareto front, rank 1 the front after removing rank 0, and so on.

    :param until_count: when set, peeling stops once at least this many
        rows are ranked (always after a whole front); the rows left get the
        sentinel rank ``n``, larger than any real rank.
    """
    return peel_fronts(dominance_packed(f.contiguous()), until_count)


def crowding_distance(costs: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """NSGA-II crowding distance over the ``mask``-selected rows of
    ``costs`` (n, m); boundary rows get ``inf``, masked-out rows ``-inf``.
    The neighbour kernel on a CUDA tensor, the sort-and-scatter formula on
    a CPU tensor (equal bit for bit)."""
    if costs.device.type == "cpu":
        return crowding_distance_plain(costs, mask)
    return crowding_distance_kernel(costs.contiguous(), mask)


def nd_environmental_selection(
    x: torch.Tensor, f: torch.Tensor, topk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NSGA-II survivor selection: non-domination rank, then crowding
    distance on the boundary front.

    :return: ``(selected_x, selected_f, rank, crowding_distance)``.
    """
    # Ranking may stop once the front crossing ``topk`` is peeled: deeper
    # rows are never selected and their sentinel rank sorts last.
    rank = non_dominate_rank(f, until_count=topk)
    worst_rank = masked_top_k(rank, topk)[0][-1]  # the k-th smallest rank
    mask = rank == worst_rank
    crowding_dis = crowding_distance(f, mask)
    combined_order = lexsort([-crowding_dis, rank])[:topk]
    return (
        x[combined_order],
        f[combined_order],
        rank[combined_order],
        crowding_dis[combined_order],
    )
