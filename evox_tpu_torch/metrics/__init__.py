"""Multi-objective quality metrics (counterpart of ``evox_tpu/metrics``)."""

__all__ = ["gd", "hv", "igd"]

from .gd import gd
from .hv import hv
from .igd import igd
