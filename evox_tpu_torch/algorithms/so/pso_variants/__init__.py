__all__ = ["CLPSO", "CSO", "DMSPSOEL", "FSPSO", "PSO", "PallasPSO", "SLPSOGS", "SLPSOUS"]

from .clpso import CLPSO
from .cso import CSO
from .dms_pso_el import DMSPSOEL
from .fs_pso import FSPSO
from .pso import PSO, PallasPSO
from .sl_pso import SLPSOGS, SLPSOUS
