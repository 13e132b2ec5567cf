"""Noise-Reuse ES, an online ES that reuses perturbations across an unroll
(Li et al. 2023; counterpart of ``evox_tpu/algorithms/so/es_variants/
noise_reuse_es.py``): fresh mirrored noise is taken only at unroll
boundaries, chosen by a ``torch.where`` on the device counter (the draw
itself is made every generation, as in the JAX package)."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from .base import CenterES

__all__ = ["NoiseReuseES"]


class NoiseReuseES(CenterES):
    def __init__(
        self,
        pop_size: int,
        center_init,
        optimizer: Literal["adam"] | None = None,
        lr: float = 0.05,
        sigma: float = 0.03,
        T: int = 100,
        K: int = 10,
        sigma_decay: float = 1.0,
        sigma_limit: float = 0.01,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if pop_size <= 1 or pop_size % 2 != 0:
            raise ValueError(f"pop_size must be an even number > 1 (mirrored sampling), got {pop_size}")
        self.pop_size = pop_size
        self._init_center(center_init, dtype, device)
        self.sigma_init = sigma
        self.T = T
        self.K = K
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self._init_optimizer(optimizer, lr)

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            T=self._param(self.T),
            K=self._param(self.K),
            sigma_decay=self._param(self.sigma_decay),
            sigma_limit=self._param(self.sigma_limit),
            center=self.center_init.clone(),
            sigma=self._scalar(self.sigma_init),
            inner_step_counter=self._scalar(0.0),
            unroll_pert=torch.zeros((self.pop_size, self.dim), dtype=self.dtype, device=self.device),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = self.pop_size // 2
        key, (z,) = self._normals(state, [(half, self.dim)])
        pos = z * state.sigma
        perts = torch.cat([pos, -pos], dim=0)
        unroll_pert = torch.where(state.inner_step_counter == 0, perts, state.unroll_pert)

        pop = state.center + unroll_pert
        fit = evaluate(pop)
        grad = torch.mean(unroll_pert * fit[:, None] / (state.sigma**2), dim=0)

        advanced = state.inner_step_counter + state.K
        counter = torch.where(advanced >= state.T, 0.0, advanced)
        sigma = torch.maximum(state.sigma_decay * state.sigma, state.sigma_limit)
        return state.replace(
            key=key,
            fit=fit,
            sigma=sigma,
            inner_step_counter=counter,
            unroll_pert=unroll_pert,
            **self._opt_update(state, grad),
        )

    def record_step(self, state: State) -> dict:
        return {"center": state.center, "sigma": state.sigma}
