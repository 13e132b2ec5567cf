"""DTLZ test problems DTLZ1-7 (counterpart of
``evox_tpu/problems/numerical/dtlz.py``).

Objectives are whole-population ``(n, d) -> (n, m)`` tensor expressions
evaluated eagerly; the analytic Pareto front (``pf()``) is built from the
Das-Dennis lattice (the grid lattice for DTLZ7, the degenerate curve for
DTLZ5/6), as in the JAX package.

References:
    [1] K. Deb et al., "Scalable test problems for evolutionary
        multiobjective optimization," in Evolutionary Multiobjective
        Optimization, Springer, 2005, pp. 105-145.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import resolve_device
from ...core import Problem, State
from ...operators.sampling import grid_sampling, uniform_sampling

__all__ = ["DTLZ", "DTLZ1", "DTLZ2", "DTLZ3", "DTLZ4", "DTLZ5", "DTLZ6", "DTLZ7"]


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


def _rastrigin_g(x_rear: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """The multimodal distance function of DTLZ1/DTLZ3."""
    return 100.0 * (
        d
        - m
        + 1
        + torch.sum(
            (x_rear - 0.5) ** 2 - torch.cos(20.0 * math.pi * (x_rear - 0.5)),
            dim=1,
            keepdim=True,
        )
    )


def _sphere_g(x_rear: torch.Tensor) -> torch.Tensor:
    """The unimodal distance function of DTLZ2/4/5."""
    return torch.sum((x_rear - 0.5) ** 2, dim=1, keepdim=True)


def _bent(g: torch.Tensor, x_front: torch.Tensor) -> torch.Tensor:
    """DTLZ5/6's position variables, bent towards the degenerate curve."""
    bent = (1 + 2 * g * x_front[:, 1:]) / (2 + 2 * g)
    return torch.cat([x_front[:, :1], bent], dim=1)


def _degenerate_pf(n: int, m: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Analytic degenerate-curve Pareto front of DTLZ5/DTLZ6, ``n`` points
    (the two lattices made by numpy's float32 ``arange``, as the JAX
    package makes them)."""
    a = np.concatenate([np.arange(0.0, 1.0, 1.0 / (n - 1), dtype=np.float32), [1.0]])
    b = np.concatenate([np.arange(1.0, 0.0, -1.0 / (n - 1), dtype=np.float32), [0.0]])
    f = torch.from_numpy(np.stack([a, b], axis=1).astype(np.float32)).to(dtype=dtype, device=device)
    f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    for _ in range(m - 2):
        f = torch.cat([f[:, :1], f], dim=1)
    powers = torch.tensor([m - 2] + list(range(m - 2, -1, -1)), dtype=dtype, device=device)
    return f / torch.sqrt(torch.tensor(2.0, dtype=dtype, device=device)) ** powers[None, :]


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


class DTLZ1(DTLZ):
    """Linear Pareto front with a highly multimodal distance function."""

    def __init__(
        self,
        d: int = 7,
        m: int = 3,
        ref_num: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__(d, m, ref_num, dtype, device)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        n, d = x.shape
        m = self.m
        g = _rastrigin_g(x[:, m - 1 :], d, m)
        ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
        flip_cumprod = torch.flip(
            torch.cumprod(torch.cat([ones, x[:, : m - 1]], dim=1), dim=1), dims=(1,)
        )
        rest = torch.cat([ones, 1 - torch.flip(x[:, : m - 1], dims=(1,))], dim=1)
        return 0.5 * (1 + g) * flip_cumprod * rest


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
        return _angle_objectives(_sphere_g(x[:, m - 1 :]), x[:, : m - 1])

    def pf(self) -> torch.Tensor:
        f = self.sample
        return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)


class DTLZ3(DTLZ2):
    """DTLZ2 front with the DTLZ1 multimodal distance function."""

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        g = _rastrigin_g(x[:, m - 1 :], x.shape[1], m)
        return _angle_objectives(g, x[:, : m - 1])


class DTLZ4(DTLZ2):
    """DTLZ2 with a strong density bias (``x^100`` mapping) on the front."""

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        return _angle_objectives(_sphere_g(x[:, m - 1 :]), x[:, : m - 1] ** 100)


class DTLZ5(DTLZ):
    """Degenerate-curve Pareto front."""

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
        g = _sphere_g(x[:, m - 1 :])
        return _angle_objectives(g, _bent(g, x[:, : m - 1]))

    def pf(self) -> torch.Tensor:
        return _degenerate_pf(self.ref_num * self.m, self.m, self.dtype, self.device)


class DTLZ6(DTLZ5):
    """DTLZ5 with a biased ``x^0.1`` distance function."""

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        g = torch.sum(x[:, m - 1 :] ** 0.1, dim=1, keepdim=True)
        return _angle_objectives(g, _bent(g, x[:, : m - 1]))


class DTLZ7(DTLZ):
    """Disconnected Pareto front."""

    def __init__(
        self,
        d: int = 21,
        m: int = 3,
        ref_num: int = 1000,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        super().__init__(d, m, ref_num, dtype, device)

    def _make_sample(self) -> torch.Tensor:
        points, _ = grid_sampling(self.ref_num * self.m, self.m - 1)
        return points.to(dtype=self.dtype, device=self.device)

    def _eval(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        g = 1 + 9 * torch.mean(x[:, m - 1 :], dim=1, keepdim=True)
        term = torch.sum(
            x[:, : m - 1] / (1 + g) * (1 + torch.sin(3 * math.pi * x[:, : m - 1])),
            dim=1,
            keepdim=True,
        )
        return torch.cat([x[:, : m - 1], (1 + g) * (m - term)], dim=1)

    def pf(self) -> torch.Tensor:
        # Piecewise remap of the grid into the disconnected regions.
        interval = torch.tensor([0.0, 0.251412, 0.631627, 0.859401], dtype=self.dtype, device=self.device)
        median = (interval[1] - interval[0]) / (
            interval[3] - interval[2] + interval[1] - interval[0]
        )
        x = self.sample
        x = torch.where(x <= median, x * (interval[1] - interval[0]) / median + interval[0], x)
        x = torch.where(
            x > median, (x - median) * (interval[3] - interval[2]) / (1 - median) + interval[2], x
        )
        last = 2 * (
            self.m - torch.sum(x / 2 * (1 + torch.sin(3 * math.pi * x)), dim=1, keepdim=True)
        )
        return torch.cat([x, last], dim=1)
