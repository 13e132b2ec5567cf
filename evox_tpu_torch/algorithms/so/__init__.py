"""Single-objective algorithms (PSO and the DE family so far)."""

__all__ = ["PSO", "PallasPSO", "DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE"]

from .de_variants import DE, ODE, SHADE, CoDE, JaDE, SaDE
from .pso_variants import PSO, PallasPSO
