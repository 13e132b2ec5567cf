"""Single-objective algorithms (PSO only so far)."""

__all__ = ["PSO", "PallasPSO"]

from .pso_variants import PSO, PallasPSO
