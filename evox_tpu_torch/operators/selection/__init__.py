"""Selection operators (counterpart of ``evox_tpu/operators/selection``):
non-dominated sorting, crowding distance, RVEA reference-vector selection,
tournaments and the p-best pick."""

__all__ = [
    "crowding_distance",
    "dominate_relation",
    "nd_environmental_selection",
    "non_dominate_rank",
    "ref_vec_guided",
    "select_rand_pbest",
    "tournament_selection",
    "tournament_selection_multifit",
]

from .non_dominate import (
    crowding_distance,
    dominate_relation,
    nd_environmental_selection,
    non_dominate_rank,
)
from .find_pbest import select_rand_pbest
from .rvea_selection import ref_vec_guided
from .tournament_selection import tournament_selection, tournament_selection_multifit
