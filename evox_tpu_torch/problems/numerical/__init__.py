"""Numerical benchmark problems (counterpart of
``evox_tpu/problems/numerical``; the basic suite, CEC2022 and DTLZ1-7
so far)."""

__all__ = [
    "CEC2022",
    "DTLZ",
    "DTLZ1",
    "DTLZ2",
    "DTLZ3",
    "DTLZ4",
    "DTLZ5",
    "DTLZ6",
    "DTLZ7",
    "ShiftAffineNumericalProblem",
    "Ackley",
    "Griewank",
    "Rastrigin",
    "Rosenbrock",
    "Schwefel",
    "Sphere",
    "Ellipsoid",
    "ackley_func",
    "griewank_func",
    "rastrigin_func",
    "rosenbrock_func",
    "schwefel_func",
    "sphere_func",
    "ellipsoid_func",
]

from .basic import (
    Ackley,
    Ellipsoid,
    Griewank,
    Rastrigin,
    Rosenbrock,
    Schwefel,
    ShiftAffineNumericalProblem,
    Sphere,
    ackley_func,
    ellipsoid_func,
    griewank_func,
    rastrigin_func,
    rosenbrock_func,
    schwefel_func,
    sphere_func,
)
from .cec2022 import CEC2022
from .dtlz import DTLZ, DTLZ1, DTLZ2, DTLZ3, DTLZ4, DTLZ5, DTLZ6, DTLZ7
