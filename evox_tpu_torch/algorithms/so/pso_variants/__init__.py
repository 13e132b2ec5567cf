__all__ = ["PSO", "PallasPSO"]

from .pso import PSO, PallasPSO
