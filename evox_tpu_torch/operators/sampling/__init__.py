"""Sampling operators (counterpart of ``evox_tpu/operators/sampling``)."""

__all__ = [
    "grid_sampling",
    "latin_hypercube_sampling",
    "latin_hypercube_sampling_standard",
    "uniform_sampling",
]

from .grid import grid_sampling
from .latin_hypercube import latin_hypercube_sampling, latin_hypercube_sampling_standard
from .uniform import uniform_sampling
