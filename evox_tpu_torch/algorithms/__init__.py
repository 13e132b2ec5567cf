"""Algorithm library (counterpart of ``evox_tpu/algorithms``; PSO only so
far)."""

__all__ = ["PSO", "PallasPSO"]

from .so.pso_variants import PSO, PallasPSO
