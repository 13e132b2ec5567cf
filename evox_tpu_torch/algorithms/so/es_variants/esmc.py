"""ESMC, ES with a zero-perturbation baseline member (counterpart of
``evox_tpu/algorithms/so/es_variants/esmc.py``)."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from .base import CenterES

__all__ = ["ESMC"]


class ESMC(CenterES):
    def __init__(
        self,
        pop_size: int,
        center_init,
        optimizer: Literal["adam"] | None = None,
        sigma_decay: float = 1.0,
        sigma_limit: float = 0.01,
        lr: float = 0.05,
        sigma: float = 0.03,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if pop_size <= 1 or pop_size % 2 != 1:
            raise ValueError(
                f"ESMC uses a baseline member plus mirrored pairs; pop_size must be an odd number > 1, "
                f"got {pop_size}"
            )
        self.pop_size = pop_size
        self._init_center(center_init, dtype, device)
        self.sigma_init = sigma
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self._init_optimizer(optimizer, lr)

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            sigma_decay=self._param(self.sigma_decay),
            sigma_limit=self._param(self.sigma_limit),
            center=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.sigma_init, dtype=self.dtype, device=self.device),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = (self.pop_size - 1) // 2
        key, (z_plus,) = self._normals(state, [(half, self.dim)])
        zero = torch.zeros((1, self.dim), dtype=self.dtype, device=self.device)
        z = torch.cat([zero, z_plus, -z_plus], dim=0)
        pop = state.center + z * state.sigma

        fit = evaluate(pop)
        baseline = fit[0]
        fit_1, fit_2 = fit[1 : half + 1], fit[half + 1 :]
        fit_diff = torch.minimum(fit_1, baseline) - torch.minimum(fit_2, baseline)
        grad = z_plus.T @ fit_diff / half

        sigma = torch.maximum(state.sigma * state.sigma_decay, state.sigma_limit)
        return state.replace(key=key, fit=fit, sigma=sigma, **self._opt_update(state, grad))
