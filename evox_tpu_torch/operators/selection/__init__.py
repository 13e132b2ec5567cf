"""Selection operators (counterpart of ``evox_tpu/operators/selection``;
non-dominated sorting and tournaments so far)."""

__all__ = [
    "crowding_distance",
    "dominate_relation",
    "nd_environmental_selection",
    "non_dominate_rank",
    "tournament_selection",
    "tournament_selection_multifit",
]

from .non_dominate import (
    crowding_distance,
    dominate_relation,
    nd_environmental_selection,
    non_dominate_rank,
)
from .tournament_selection import tournament_selection, tournament_selection_multifit
