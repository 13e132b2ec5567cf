"""Single-objective algorithms (PSO, the DE family and the ES family so
far)."""

__all__ = [
    "PSO", "PallasPSO", "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE",
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
from .pso_variants import PSO, PallasPSO
