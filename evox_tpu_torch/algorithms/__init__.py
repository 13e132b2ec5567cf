"""Algorithm library (counterpart of ``evox_tpu/algorithms``; the PSO, DE
and ES families and the multi-objective family)."""

__all__ = [
    "PSO", "PallasPSO", "CLPSO", "CSO", "DMSPSOEL", "FSPSO", "SLPSOGS", "SLPSOUS",
    "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE",
    "CMAES", "OpenES", "XNES", "SeparableNES", "SNES", "DES", "ARS", "ASEBO",
    "GuidedES", "PersistentES", "NoiseReuseES", "ESMC",
    "NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE",
]

from .mo import MOEAD, NSGA2, NSGA3, RVEA, RVEAa, HypE
from .so import (
    CLPSO,
    CSO,
    DMSPSOEL,
    FSPSO,
    SLPSOGS,
    SLPSOUS,
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
