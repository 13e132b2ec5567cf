"""Algorithm library (counterpart of ``evox_tpu/algorithms``; PSO, the DE
family, the ES family and the multi-objective family so far)."""

__all__ = [
    "PSO", "PallasPSO", "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE",
    "CMAES", "OpenES", "XNES", "SeparableNES", "SNES", "DES", "ARS", "ASEBO",
    "GuidedES", "PersistentES", "NoiseReuseES", "ESMC",
    "NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE",
]

from .mo import MOEAD, NSGA2, NSGA3, RVEA, RVEAa, HypE
from .so import (
    ARS,
    ASEBO,
    CMAES,
    DES,
    ESMC,
    PSO,
    SNES,
    XNES,
    CoDE,
    DE,
    GuidedES,
    JaDE,
    NoiseReuseES,
    ODE,
    OpenES,
    PallasPSO,
    PersistentES,
    SaDE,
    SeparableNES,
    SHADE,
)
