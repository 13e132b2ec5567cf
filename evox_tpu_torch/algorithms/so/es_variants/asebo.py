"""ASEBO, Adaptive ES with Active Subspaces (counterpart of
``evox_tpu/algorithms/so/es_variants/asebo.py``): the principal directions
of a rolling gradient history (:func:`evox_tpu_torch.ops.linalg.svd_vh`)
define an active subspace; the sampling covariance blends its projector
with isotropic noise (:func:`evox_tpu_torch.ops.linalg.cholesky`), and the
blend weight adapts from the gradient's split between the subspace and
its complement.  The warm-up branches on ``gen_counter`` are
``torch.where`` selections, as in the JAX package."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from ....ops import linalg
from .base import CenterES

__all__ = ["ASEBO"]


class ASEBO(CenterES):
    def __init__(
        self,
        pop_size: int,
        center_init,
        optimizer: Literal["adam"] | None = None,
        lr: float = 0.05,
        lr_decay: float = 1.0,
        lr_limit: float = 0.001,
        sigma: float = 0.03,
        sigma_decay: float = 1.0,
        sigma_limit: float = 0.01,
        subspace_dims: int | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """``lr_decay`` and ``lr_limit`` are accepted for the JAX signature
        and, as there, unused."""
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
        def square():
            return torch.zeros((self.dim, self.dim), dtype=self.dtype, device=self.device)

        return State(
            key=key.to(self.device),
            sigma_decay=self._param(self.sigma_decay),
            sigma_limit=self._param(self.sigma_limit),
            center=self.center_init.clone(),
            grad_subspace=torch.zeros((self.subspace_dims, self.dim), dtype=self.dtype, device=self.device),
            UUT=square(),
            UUT_ort=square(),
            sigma=self._scalar(self.sigma_init),
            alpha=self._scalar(0.1),
            gen_counter=self._scalar(0.0),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = self.pop_size // 2
        key, (noise,) = self._normals(state, [(self.dim, half)])
        warm = state.gen_counter > self.subspace_dims

        X = state.grad_subspace
        X = X - torch.mean(X, dim=0)
        # Principal directions of the gradient history.  Only the
        # projectors U.T @ U are consumed, and those do not depend on the
        # sign of each direction.
        Vt = linalg.svd_vh(X)
        U_mat = Vt[:half]
        UUT = U_mat.T @ U_mat
        U_ort = Vt[half:]
        UUT_ort = U_ort.T @ U_ort
        UUT = torch.where(warm, UUT, 0.0)

        eye = torch.eye(self.dim, dtype=self.dtype, device=self.device)
        cov = state.sigma * (state.alpha / self.dim) * eye + ((1 - state.alpha) / half) * UUT
        # The covariance is PSD but may be rank-deficient before the
        # history fills; the jitter keeps the Cholesky factor finite.
        chol = linalg.cholesky(cov + 1e-10 * eye)
        z_plus = (chol @ noise).T
        z_plus = z_plus / torch.linalg.vector_norm(z_plus, dim=-1, keepdim=True)
        z = torch.cat([z_plus, -z_plus], dim=0)
        pop = state.center + z

        fit = evaluate(pop)
        fit_1, fit_2 = fit[:half], fit[half:]
        noise_1 = (z / state.sigma)[:half]
        grad = noise_1.T @ (fit_1 - fit_2) / 2.0

        alpha = torch.linalg.vector_norm(grad @ UUT_ort) / (torch.linalg.vector_norm(grad @ state.UUT) + 1e-12)
        alpha = torch.where(warm, alpha, 1.0)

        grad_subspace = torch.cat([state.grad_subspace[1:], grad[None, :]], dim=0)
        grad = grad / (torch.linalg.vector_norm(grad) / self.dim + 1e-8)

        sigma = torch.maximum(state.sigma * state.sigma_decay, state.sigma_limit)
        return state.replace(
            key=key,
            fit=fit,
            sigma=sigma,
            alpha=alpha,
            UUT=UUT,
            UUT_ort=UUT_ort,
            grad_subspace=grad_subspace,
            gen_counter=state.gen_counter + 1,
            **self._opt_update(state, grad),
        )

    def record_step(self, state: State) -> dict:
        return {"center": state.center, "sigma": state.sigma, "alpha": state.alpha}
