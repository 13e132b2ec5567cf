"""Problem library (counterpart of ``evox_tpu/problems``)."""

__all__ = [
    "HPOFitnessMonitor",
    "HPOMonitor",
    "HPOProblemWrapper",
    "hpo_wrapper",
    "neuroevolution",
    "numerical",
]

from . import hpo_wrapper, neuroevolution, numerical
from .hpo_wrapper import HPOFitnessMonitor, HPOMonitor, HPOProblemWrapper
