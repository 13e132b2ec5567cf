"""Operator layer (counterpart of ``evox_tpu/operators``): tensor-to-tensor
functions over whole populations, with explicit keys."""

__all__ = ["crossover", "mutation", "sampling", "selection", "crowding_distance", "non_dominate_rank"]

from . import crossover, mutation, sampling, selection
from .selection import crowding_distance, non_dominate_rank
