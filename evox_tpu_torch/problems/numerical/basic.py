"""Basic numerical benchmark problems (counterpart of
``evox_tpu/problems/numerical/basic.py``): Ackley, Griewank, Rastrigin,
Rosenbrock, Schwefel, Sphere and Ellipsoid behind a shift+affine
pre-transform base.  All are whole-population ``(N, D) -> (N,)`` tensor
expressions evaluated eagerly, one PyTorch operator at a time.
"""

from __future__ import annotations

import math

import torch

from ... import resolve_device
from ...core import Problem, State

__all__ = [
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


def ackley_func(a: float, b: float, c: float, x: torch.Tensor) -> torch.Tensor:
    """Ackley function value per row of ``x``."""
    d = x.shape[1]
    return (
        -a * torch.exp(-b * torch.sqrt(torch.sum(x**2, dim=1) / d))
        - torch.exp(torch.sum(torch.cos(c * x), dim=1) / d)
        + a
        + math.e
    )


def griewank_func(x: torch.Tensor) -> torch.Tensor:
    """Griewank function value per row of ``x``."""
    d = x.shape[1]
    i = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
    return (
        torch.sum(x**2, dim=1) / 4000.0
        - torch.prod(torch.cos(x / torch.sqrt(i)), dim=1)
        + 1.0
    )


def rastrigin_func(x: torch.Tensor) -> torch.Tensor:
    """Rastrigin function value per row of ``x``."""
    d = x.shape[1]
    return 10.0 * d + torch.sum(x**2 - 10.0 * torch.cos(2.0 * math.pi * x), dim=1)


def rosenbrock_func(x: torch.Tensor) -> torch.Tensor:
    """Rosenbrock function value per row of ``x``."""
    return torch.sum(
        100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (x[:, :-1] - 1.0) ** 2, dim=1
    )


def schwefel_func(x: torch.Tensor) -> torch.Tensor:
    """Schwefel function value per row of ``x``."""
    d = x.shape[1]
    return 418.9828872724338 * d - torch.sum(
        x * torch.sin(torch.sqrt(torch.abs(x))), dim=1
    )


def sphere_func(x: torch.Tensor) -> torch.Tensor:
    """Sphere (sum of squares) value per row of ``x``.  Eager PyTorch
    materialises ``x**2`` (one extra (N, D) write and read)."""
    return torch.sum(x**2, dim=1)


def ellipsoid_func(x: torch.Tensor) -> torch.Tensor:
    """Ellipsoid function value per row of ``x``."""
    d = x.shape[1]
    i = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
    return torch.sum(i * x**2, dim=1)


class ShiftAffineNumericalProblem(Problem):
    """Numerical problem with optional shift vector and affine matrix applied
    to the population before evaluation.

    :param device: where ``shift``/``affine`` are held when given (``None``
        means the CUDA card); unused without them.
    """

    def __init__(self, shift=None, affine=None, device=None):
        if shift is not None or affine is not None:
            device = resolve_device(device)
        if affine is not None:
            affine = torch.as_tensor(affine, device=device)
            if affine.ndim != 2 or affine.shape[0] != affine.shape[1]:
                raise ValueError(
                    f"affine must be a square matrix, got shape {tuple(affine.shape)}"
                )
            # The affine product goes to torch.matmul (the JAX package
            # leaves it to XLA).  Full float32, never TF32: the reference
            # computes it in float32, and this is PyTorch's default too.
            torch.backends.cuda.matmul.allow_tf32 = False
        if shift is not None:
            shift = torch.as_tensor(shift, device=device)
            if shift.ndim != 1:
                raise ValueError(f"shift must be 1-D, got shape {tuple(shift.shape)}")
            if affine is not None and affine.shape[0] != shift.shape[0]:
                raise ValueError(
                    f"shift of length {shift.shape[0]} does not match affine "
                    f"of shape {tuple(affine.shape)}"
                )
        self.shift = shift
        self.affine = affine

    def _true_evaluate(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def evaluate(
        self, state: State, pop: torch.Tensor
    ) -> tuple[torch.Tensor, State]:
        if self.shift is not None:
            pop = pop + self.shift[None, :]
        if self.affine is not None:
            pop = pop @ self.affine
        return self._true_evaluate(pop), state


class Ackley(ShiftAffineNumericalProblem):
    """Ackley function; minimum at x = 0."""

    def __init__(
        self, a: float = 20.0, b: float = 0.2, c: float = 2 * math.pi, **kwargs
    ):
        super().__init__(**kwargs)
        self.a, self.b, self.c = a, b, c

    def _true_evaluate(self, x):
        return ackley_func(self.a, self.b, self.c, x)


class Griewank(ShiftAffineNumericalProblem):
    """Griewank function; minimum at x = 0."""

    def _true_evaluate(self, x):
        return griewank_func(x)


class Rastrigin(ShiftAffineNumericalProblem):
    """Rastrigin function; minimum at x = 0."""

    def _true_evaluate(self, x):
        return rastrigin_func(x)


class Rosenbrock(ShiftAffineNumericalProblem):
    """Rosenbrock function; minimum at x = 1."""

    def _true_evaluate(self, x):
        return rosenbrock_func(x)


class Schwefel(ShiftAffineNumericalProblem):
    """Schwefel function; minimum at x = 420.9687."""

    def _true_evaluate(self, x):
        return schwefel_func(x)


class Sphere(ShiftAffineNumericalProblem):
    """Sphere function; minimum at x = 0."""

    def _true_evaluate(self, x):
        return sphere_func(x)


class Ellipsoid(ShiftAffineNumericalProblem):
    """Ellipsoid function; minimum at x = 0."""

    def _true_evaluate(self, x):
        return ellipsoid_func(x)
