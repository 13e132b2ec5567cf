"""Selection operators (counterpart of ``evox_tpu/operators/selection``):
non-dominated sorting, crowding distance, RVEA reference-vector selection
and tournaments (the p-best pick is not ported yet)."""

__all__ = [
    "crowding_distance",
    "dominate_relation",
    "nd_environmental_selection",
    "non_dominate_rank",
    "ref_vec_guided",
    "tournament_selection",
    "tournament_selection_multifit",
]

from .non_dominate import (
    crowding_distance,
    dominate_relation,
    nd_environmental_selection,
    non_dominate_rank,
)
from .rvea_selection import ref_vec_guided
from .tournament_selection import tournament_selection, tournament_selection_multifit
