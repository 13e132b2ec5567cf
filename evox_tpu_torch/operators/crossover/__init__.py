"""Crossover operators (counterpart of ``evox_tpu/operators/crossover``;
SBX and the differential-evolution family so far)."""

__all__ = [
    "simulated_binary",
    "simulated_binary_half",
    "DE_differential_sum",
    "DE_binary_crossover",
    "DE_exponential_crossover",
    "DE_arithmetic_recombination",
]

from .differential_evolution import (
    DE_arithmetic_recombination,
    DE_binary_crossover,
    DE_differential_sum,
    DE_exponential_crossover,
)
from .sbx import simulated_binary, simulated_binary_half
