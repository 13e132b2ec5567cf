"""Algorithm library (counterpart of ``evox_tpu/algorithms``; PSO and the
multi-objective family so far)."""

__all__ = ["PSO", "PallasPSO", "NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE"]

from .mo import MOEAD, NSGA2, NSGA3, RVEA, RVEAa, HypE
from .so.pso_variants import PSO, PallasPSO
