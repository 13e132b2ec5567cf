"""ARS, Augmented Random Search (counterpart of
``evox_tpu/algorithms/so/es_variants/ars.py``): mirrored directions, the
top-k elite directions by best-of-pair fitness, a finite-difference
gradient normalised by the elite fitness's standard deviation."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from .base import CenterES

__all__ = ["ARS"]


class ARS(CenterES):
    def __init__(
        self,
        pop_size: int,
        center_init,
        elite_ratio: float = 0.1,
        lr: float = 0.05,
        sigma: float = 0.03,
        optimizer: Literal["adam"] | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if pop_size <= 1 or pop_size % 2 != 0:
            raise ValueError(f"pop_size must be an even number > 1 (mirrored sampling), got {pop_size}")
        if not 0 <= elite_ratio <= 1:
            raise ValueError(f"elite_ratio must be in [0, 1], got {elite_ratio}")
        self.pop_size = pop_size
        self._init_center(center_init, dtype, device)
        self.sigma = sigma
        self.elite_pop_size = max(1, int(pop_size / 2 * elite_ratio))
        self._init_optimizer(optimizer, lr)

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            sigma=self._param(self.sigma),
            center=self.center_init.clone(),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = self.pop_size // 2
        key, (z_plus,) = self._normals(state, [(half, self.dim)])
        noise = torch.cat([z_plus, -z_plus], dim=0)
        pop = state.center + state.sigma * noise

        fit = evaluate(pop)
        fit_1, fit_2 = fit[:half], fit[half:]
        elite_idx = torch.argsort(torch.minimum(fit_1, fit_2), stable=True)[: self.elite_pop_size]

        fit_elite = torch.cat([fit_1[elite_idx], fit_2[elite_idx]])
        # jnp.std is the population standard deviation (ddof 0).
        sigma_fitness = torch.std(fit_elite, correction=0) + 1e-5
        fit_diff = fit_1[elite_idx] - fit_2[elite_idx]
        grad = z_plus[elite_idx].T @ fit_diff / (self.elite_pop_size * sigma_fitness)

        return state.replace(key=key, fit=fit, **self._opt_update(state, grad))
