"""Differential-evolution family (counterpart of
``evox_tpu/algorithms/so/de_variants``)."""

__all__ = ["DE", "ODE", "JaDE", "SaDE", "SHADE", "CoDE"]

from .code import CoDE
from .de import DE
from .jade import JaDE
from .ode import ODE
from .sade import SaDE
from .shade import SHADE
