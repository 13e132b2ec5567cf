"""Algorithm library (counterpart of ``evox_tpu/algorithms``; PSO and
NSGA-II so far)."""

__all__ = ["NSGA2", "PSO", "PallasPSO"]

from .mo import NSGA2
from .so.pso_variants import PSO, PallasPSO
