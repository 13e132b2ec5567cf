"""DTLZ test problems (counterpart of
``evox_tpu/problems/numerical/dtlz.py``; the base class and DTLZ2 so far).

Objectives are whole-population ``(n, d) -> (n, m)`` tensor expressions
evaluated eagerly; the analytic Pareto front (``pf()``) is built on the
host from the Das-Dennis lattice, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ... import resolve_device
from ...core import Problem, State
from ...operators.sampling import uniform_sampling

__all__ = ["DTLZ", "DTLZ2"]


def _angle_objectives(g: torch.Tensor, x_front: torch.Tensor) -> torch.Tensor:
    """The spherical objective construction shared by DTLZ2-6:
    ``(1+g) * flip(cumprod([1, cos(x π/2)])) * [1, sin(flip(x) π/2)]``."""
    n = x_front.shape[0]
    ones = torch.ones((n, 1), dtype=x_front.dtype, device=x_front.device)
    zero = torch.zeros((), dtype=x_front.dtype, device=x_front.device)
    cos_part = torch.flip(
        torch.cumprod(
            torch.cat(
                [ones, torch.maximum(torch.cos(x_front * math.pi / 2), zero)], dim=1
            ),
            dim=1,
        ),
        dims=(1,),
    )
    sin_part = torch.cat(
        [ones, torch.sin(torch.flip(x_front, dims=(1,)) * math.pi / 2)], dim=1
    )
    return (1 + g) * cos_part * sin_part


class DTLZ(Problem):
    """Base class of the DTLZ suite: decision space ``[0, 1]^d``, objective
    count ``m``, analytic ``pf()`` sampled at about ``ref_num * m`` points.

    :param device: where ``lb``, ``ub`` and ``pf()`` are made (``None``
        means the CUDA card); ``evaluate`` runs wherever the population is.
    """

    def __init__(
        self,
        d: int,
        m: int,
        ref_num: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        self.d = d
        self.m = m
        self.ref_num = ref_num
        self.dtype = dtype
        self.device = resolve_device(device)
        self._sample = None

    @property
    def sample(self) -> torch.Tensor:
        """Das-Dennis reference directions the analytic front is built
        from (enumerated on the host at first use)."""
        if self._sample is None:
            self._sample = self._make_sample()
        return self._sample

    def _make_sample(self) -> torch.Tensor:
        points, _ = uniform_sampling(self.ref_num * self.m, self.m)
        return points.to(dtype=self.dtype, device=self.device)

    @property
    def lb(self) -> torch.Tensor:
        """Decision-space lower bound (zeros)."""
        return torch.zeros((self.d,), dtype=self.dtype, device=self.device)

    @property
    def ub(self) -> torch.Tensor:
        """Decision-space upper bound (ones)."""
        return torch.ones((self.d,), dtype=self.dtype, device=self.device)

    def evaluate(self, state: State, pop: torch.Tensor) -> tuple[torch.Tensor, State]:
        return self._eval(pop), state

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pf(self) -> torch.Tensor:
        """Analytic Pareto-front sample."""
        return self.sample / 2


class DTLZ2(DTLZ):
    """Spherical Pareto front, unimodal distance function."""

    def __init__(
        self,
        d: int = 12,
        m: int = 3,
        ref_num: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__(d, m, ref_num, dtype, device)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        g = torch.sum((x[:, m - 1 :] - 0.5) ** 2, dim=1, keepdim=True)
        return _angle_objectives(g, x[:, : m - 1])

    def pf(self) -> torch.Tensor:
        f = self.sample
        return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)
