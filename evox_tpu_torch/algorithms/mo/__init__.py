"""Multi-objective algorithms (NSGA-II only so far)."""

__all__ = ["NSGA2"]

from .nsga2 import NSGA2
