"""Guided ES, surrogate-gradient-guided subspace sampling (counterpart of
``evox_tpu/algorithms/so/es_variants/guided_es.py``): perturbations blend
isotropic noise with noise in the orthonormalised span of recent gradient
estimates (:func:`evox_tpu_torch.ops.linalg.qr`)."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from ....ops import linalg
from ....utils import rng
from .base import CenterES

__all__ = ["GuidedES"]


class GuidedES(CenterES):
    def __init__(
        self,
        pop_size: int,
        center_init,
        subspace_dims: int | None = None,
        optimizer: Literal["adam"] | None = None,
        sigma: float = 0.03,
        lr: float = 60,
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
        self.sigma_decay = sigma_decay
        self.sigma_limit = sigma_limit
        self.subspace_dims = subspace_dims if subspace_dims is not None else self.dim
        self._init_optimizer(optimizer, lr)

    def setup(self, key: torch.Tensor) -> State:
        key, (gs_seed,) = rng.split(key.to(self.device))
        return State(
            key=key,
            beta=self._param(1.0),
            sigma_decay=self._param(self.sigma_decay),
            sigma_limit=self._param(self.sigma_limit),
            center=self.center_init.clone(),
            alpha=self._scalar(0.5),
            sigma=self._scalar(self.sigma_init),
            grad_subspace=rng.normal(gs_seed, (self.subspace_dims, self.dim), self.dtype, self.device),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = self.pop_size // 2
        key, (eps_full, eps_subspace) = self._normals(state, [(self.dim, half), (self.subspace_dims, half)])

        a = state.sigma * torch.sqrt(state.alpha / self.dim)
        c = state.sigma * torch.sqrt((1.0 - state.alpha) / self.subspace_dims)
        # Orthonormal basis of the recent-gradient span (rows of
        # grad_subspace live in R^dim, so factorise the transpose).
        Q = linalg.qr(state.grad_subspace.T)

        z_plus = (a * eps_full + c * (Q @ eps_subspace)).T
        z = torch.cat([z_plus, -z_plus], dim=0)
        pop = state.center + z

        fit = evaluate(pop)
        fit_1, fit_2 = fit[:half], fit[half:]
        noise_1 = (z / state.sigma)[:half]
        grad = (state.beta / self.pop_size) * (noise_1.T @ (fit_1 - fit_2))

        grad_subspace = torch.cat([state.grad_subspace[1:], grad[None, :]], dim=0)
        sigma = torch.maximum(state.sigma_decay * state.sigma, state.sigma_limit)
        return state.replace(
            key=key,
            fit=fit,
            sigma=sigma,
            grad_subspace=grad_subspace,
            **self._opt_update(state, grad),
        )

    def record_step(self, state: State) -> dict:
        return {"center": state.center, "sigma": state.sigma}
