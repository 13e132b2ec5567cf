"""DES, "Discovering Evolution Strategies", a learned-heuristic ES
(counterpart of ``evox_tpu/algorithms/so/es_variants/des.py``)."""

from __future__ import annotations

import torch

from ....core import EvalFn, State
from .base import ESAlgorithm

__all__ = ["DES"]


class DES(ESAlgorithm):
    def __init__(
        self,
        pop_size: int,
        center_init,
        temperature: float = 12.5,
        sigma_init: float = 0.1,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if pop_size <= 1:
            raise ValueError(f"pop_size must be > 1, got {pop_size}")
        self._place(dtype, device)
        self.center_init = self._tensor(center_init)
        self.dim = self.center_init.shape[0]
        self.pop_size = pop_size
        self.temperature = temperature
        self.sigma_init = sigma_init
        self.ranks = torch.arange(pop_size, dtype=dtype, device=self.device) / (pop_size - 1) - 0.5

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            temperature=self._param(self.temperature),
            lrate_mean=self._param(1.0),
            lrate_sigma=self._param(0.1),
            center=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.sigma_init, dtype=self.dtype, device=self.device),
            fit=self._empty_fit(),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, (noise,) = self._normals(state, [(self.pop_size, self.dim)])
        pop = state.center + noise * state.sigma

        fit = evaluate(pop)
        order = torch.argsort(fit, stable=True)
        sorted_pop = pop[order]

        weight = torch.softmax(-20 * torch.sigmoid(state.temperature * self.ranks), dim=0)[:, None]
        weight_mean = torch.sum(weight * sorted_pop, dim=0)
        weight_sigma = torch.sqrt(torch.sum(weight * (sorted_pop - state.center) ** 2, dim=0) + 1e-6)

        center = state.center + state.lrate_mean * (weight_mean - state.center)
        sigma = state.sigma + state.lrate_sigma * (weight_sigma - state.sigma)
        return state.replace(key=key, center=center, sigma=sigma, fit=fit[order])

    def record_step(self, state: State) -> dict:
        return {"center": state.center, "sigma": state.sigma}
