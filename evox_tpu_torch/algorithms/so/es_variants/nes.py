"""Exponential and Separable Natural Evolution Strategies (counterpart of
``evox_tpu/algorithms/so/es_variants/nes.py``).  XNES's matrix exponential
is :func:`evox_tpu_torch.ops.linalg.expm`, the port's copy of JAX's
scaling-and-squaring algorithm, with no host sync."""

from __future__ import annotations

import math

import torch

from ....core import EvalFn, State
from ....ops import linalg
from .base import ESAlgorithm

__all__ = ["XNES", "SeparableNES"]


def _default_recombination_weights(pop_size: int, dtype, device) -> torch.Tensor:
    ranks = torch.arange(1, pop_size + 1, dtype=dtype, device=device)
    w = torch.clamp(math.log(pop_size / 2 + 1) - torch.log(ranks), min=0)
    return w / torch.sum(w) - 1 / pop_size


def _default_pop_size(dim: int, pop_size: int | None) -> int:
    if pop_size is None:
        pop_size = 4 + math.floor(3 * math.log(dim))
    if pop_size <= 0:
        raise ValueError(f"pop_size must be positive, got {pop_size}")
    return pop_size


class XNES(ESAlgorithm):
    """xNES (Glasmachers et al., 2010): multiplicative natural-gradient
    updates of a full covariance factor through ``expm``."""

    def __init__(
        self,
        init_mean,
        init_covar,
        pop_size: int | None = None,
        recombination_weights=None,
        learning_rate_mean: float | None = None,
        learning_rate_var: float | None = None,
        learning_rate_B: float | None = None,
        covar_as_cholesky: bool = False,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param init_covar: the initial covariance, or its Cholesky factor
            with ``covar_as_cholesky`` (factorised once here, on the
            algorithm's device).
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self._place(dtype, device)
        self.init_mean = self._tensor(init_mean)
        dim = self.dim = self.init_mean.shape[0]
        self.pop_size = _default_pop_size(dim, pop_size)
        self.learning_rate_mean = learning_rate_mean or 1.0
        self.learning_rate_var = (
            learning_rate_var if learning_rate_var is not None else (9 + 3 * math.log(dim)) / 5 / math.pow(dim, 1.5)
        )
        self.learning_rate_B = learning_rate_B if learning_rate_B is not None else self.learning_rate_var

        init_covar = self._tensor(init_covar)
        if not covar_as_cholesky:
            init_covar = torch.linalg.cholesky(init_covar)
        self.init_covar = init_covar

        if recombination_weights is None:
            recombination_weights = _default_recombination_weights(self.pop_size, dtype, self.device)
        else:
            recombination_weights = self._tensor(recombination_weights)
            if not bool(torch.all(recombination_weights[1:] <= recombination_weights[:-1])):
                raise ValueError("recombination_weights must be descending")
        self.weights = recombination_weights

    def setup(self, key: torch.Tensor) -> State:
        sigma = torch.prod(torch.diag(self.init_covar)) ** (1 / self.dim)
        return State(
            key=key.to(self.device),
            learning_rate_mean=self._param(self.learning_rate_mean),
            learning_rate_var=self._param(self.learning_rate_var),
            learning_rate_B=self._param(self.learning_rate_B),
            mean=self.init_mean.clone(),
            sigma=sigma,
            B=self.init_covar / sigma,
            fit=self._empty_fit(),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, (noise,) = self._normals(state, [(self.pop_size, self.dim)])
        pop = state.mean + state.sigma * (noise @ state.B.T)

        fit = evaluate(pop)
        order = torch.argsort(fit, stable=True)
        noise = noise[order]
        w = self.weights

        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        grad_delta = torch.sum(w[:, None] * noise, dim=0)
        grad_M = (w * noise.T) @ noise - torch.sum(w) * eye
        grad_sigma = torch.trace(grad_M) / self.dim
        grad_B = grad_M - grad_sigma * eye

        mean = state.mean + state.learning_rate_mean * state.sigma * state.B @ grad_delta
        sigma = state.sigma * torch.exp(state.learning_rate_var / 2 * grad_sigma)
        B = state.B @ linalg.expm(state.learning_rate_B / 2 * grad_B)

        return state.replace(key=key, mean=mean, sigma=sigma, B=B, fit=fit[order])

    def record_step(self, state: State) -> dict:
        return {"mean": state.mean, "sigma": state.sigma, "B": state.B}


class SeparableNES(ESAlgorithm):
    """Separable NES (Wierstra et al., 2014): diagonal-covariance natural
    gradient."""

    def __init__(
        self,
        init_mean,
        init_std,
        pop_size: int | None = None,
        recombination_weights=None,
        learning_rate_mean: float | None = None,
        learning_rate_var: float | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        self._place(dtype, device)
        self.init_mean = self._tensor(init_mean)
        self.init_std = self._tensor(init_std)
        dim = self.dim = self.init_mean.shape[0]
        if tuple(self.init_std.shape) != (dim,):
            raise ValueError(
                f"init_std must have shape ({dim},) matching init_mean, got {tuple(self.init_std.shape)}"
            )
        self.pop_size = _default_pop_size(dim, pop_size)
        self.learning_rate_mean = learning_rate_mean or 1.0
        self.learning_rate_var = (
            learning_rate_var if learning_rate_var is not None else (3 + math.log(dim)) / 5 / math.sqrt(dim)
        )
        if recombination_weights is None:
            recombination_weights = _default_recombination_weights(self.pop_size, dtype, self.device)
        else:
            recombination_weights = self._tensor(recombination_weights)
            if tuple(recombination_weights.shape) != (self.pop_size,):
                raise ValueError(
                    f"recombination_weights must have shape ({self.pop_size},), "
                    f"got {tuple(recombination_weights.shape)}"
                )
        self.weights = recombination_weights

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            learning_rate_mean=self._param(self.learning_rate_mean),
            learning_rate_var=self._param(self.learning_rate_var),
            mean=self.init_mean.clone(),
            sigma=self.init_std.clone(),
            fit=self._empty_fit(),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, (z,) = self._normals(state, [(self.pop_size, self.dim)])
        pop = state.mean + z * state.sigma

        fit = evaluate(pop)
        order = torch.argsort(fit, stable=True)
        z = z[order]

        w = self.weights[:, None]
        grad_mu = torch.sum(w * z, dim=0)
        grad_sigma = torch.sum(w * (z * z - 1), dim=0)

        mean = state.mean + state.learning_rate_mean * state.sigma * grad_mu
        sigma = state.sigma * torch.exp(state.learning_rate_var / 2 * grad_sigma)
        return state.replace(key=key, mean=mean, sigma=sigma, fit=fit[order])

    def record_step(self, state: State) -> dict:
        return {"mean": state.mean, "sigma": state.sigma}
