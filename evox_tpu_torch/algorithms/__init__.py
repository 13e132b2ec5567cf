"""Algorithm library (counterpart of ``evox_tpu/algorithms``; PSO, the DE
family and the multi-objective family so far)."""

__all__ = [
    "PSO", "PallasPSO", "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE",
    "NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE",
]

from .mo import MOEAD, NSGA2, NSGA3, RVEA, RVEAa, HypE
from .so import DE, ODE, SHADE, CoDE, JaDE, PSO, PallasPSO, SaDE
