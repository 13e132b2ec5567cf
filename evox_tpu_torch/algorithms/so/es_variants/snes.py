"""SNES, separable NES with rank-shaped weights (counterpart of
``evox_tpu/algorithms/so/es_variants/snes.py``)."""

from __future__ import annotations

import math
from typing import Literal

import torch

from ....core import EvalFn, State
from .base import ESAlgorithm

__all__ = ["SNES"]


class SNES(ESAlgorithm):
    def __init__(
        self,
        pop_size: int,
        center_init,
        sigma: float = 1.0,
        lrate_mean: float = 1.0,
        temperature: float = 12.5,
        weight_type: Literal["recomb", "temp"] = "temp",
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if pop_size <= 1:
            raise ValueError(f"pop_size must be > 1, got {pop_size}")
        self._place(dtype, device)
        self.center_init = self._tensor(center_init)
        dim = self.dim = self.center_init.shape[0]
        self.pop_size = pop_size
        self.lrate_mean = lrate_mean
        self.lrate_sigma = (3 + math.log(dim)) / (5 * math.sqrt(dim))
        self.temperature = temperature
        self.sigma_init = sigma

        if weight_type == "temp":
            ranks = torch.arange(pop_size, dtype=dtype, device=self.device) / (pop_size - 1) - 0.5
            weights = torch.softmax(-20 * torch.sigmoid(temperature * ranks), dim=0)
        elif weight_type == "recomb":
            ranks = torch.arange(1, pop_size + 1, dtype=dtype, device=self.device)
            weights = torch.clamp(math.log(pop_size / 2 + 1) - torch.log(ranks), min=0)
            weights = weights / torch.sum(weights) - 1 / pop_size
        else:
            raise ValueError(f"unknown weight_type {weight_type!r}")
        self.weights = weights

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            lrate_mean=self._param(self.lrate_mean),
            lrate_sigma=self._param(self.lrate_sigma),
            center=self.center_init.clone(),
            sigma=torch.full((self.dim,), self.sigma_init, dtype=self.dtype, device=self.device),
            fit=self._empty_fit(),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, (noise,) = self._normals(state, [(self.pop_size, self.dim)])
        pop = state.center + noise * state.sigma

        fit = evaluate(pop)
        order = torch.argsort(fit, stable=True)
        z = noise[order]
        w = self.weights[:, None]

        grad_mean = torch.sum(w * z, dim=0)
        grad_sigma = torch.sum(w * (z**2 - 1), dim=0)

        center = state.center + state.lrate_mean * state.sigma * grad_mean
        sigma = state.sigma * torch.exp(state.lrate_sigma / 2 * grad_sigma)
        return state.replace(key=key, center=center, sigma=sigma, fit=fit[order])

    def record_step(self, state: State) -> dict:
        return {"center": state.center, "sigma": state.sigma}
