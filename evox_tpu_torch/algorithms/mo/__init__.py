"""Multi-objective algorithms (counterpart of ``evox_tpu/algorithms/mo``)."""

__all__ = ["NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE"]

from .hype import HypE
from .moead import MOEAD
from .nsga2 import NSGA2
from .nsga3 import NSGA3
from .rvea import RVEA
from .rveaa import RVEAa
