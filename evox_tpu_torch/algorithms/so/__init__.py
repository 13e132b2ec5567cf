"""Single-objective algorithms (the PSO, DE and ES families)."""

__all__ = [
    "PSO", "PallasPSO", "CLPSO", "CSO", "DMSPSOEL", "FSPSO", "SLPSOGS", "SLPSOUS",
    "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE",
    "CMAES", "OpenES", "XNES", "SeparableNES", "SNES", "DES", "ARS", "ASEBO",
    "GuidedES", "PersistentES", "NoiseReuseES", "ESMC",
]

from .de_variants import DE, ODE, SHADE, CoDE, JaDE, SaDE
from .es_variants import (
    ARS,
    ASEBO,
    CMAES,
    DES,
    ESMC,
    SNES,
    XNES,
    GuidedES,
    NoiseReuseES,
    OpenES,
    PersistentES,
    SeparableNES,
)
from .pso_variants import CLPSO, CSO, DMSPSOEL, FSPSO, PSO, SLPSOGS, SLPSOUS, PallasPSO
