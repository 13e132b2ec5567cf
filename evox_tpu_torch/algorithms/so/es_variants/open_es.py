"""OpenES (Salimans et al., 2017; counterpart of
``evox_tpu/algorithms/so/es_variants/open_es.py``): mirrored Gaussian
sampling around a center, the fitness-weighted noise average as the
gradient estimate, plain SGD or Adam on the center.  A generation is one
draw and elementwise operations.

The gradient ``noise.T @ fit`` is summed over the population in a fixed
pairwise order (:func:`_pairwise_row_sum`), not by a matrix product: a
product under ``torch.func.vmap`` is a batched one (``bmm``), which adds
the terms in another order than the solo matrix-vector product, whereas
elementwise additions round each element alike however many instances
are stacked.  So a vmapped instance (a candidate of an HPO nest) equals
its solo run bit for bit.  Against JAX's product it agrees within a
reduction's rounding."""

from __future__ import annotations

from typing import Literal

import torch

from ....core import EvalFn, State
from .base import CenterES

__all__ = ["OpenES"]


def _pairwise_row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the rows of ``x`` (N, D), halving the rows by pairwise
    additions (an odd row is carried to the next level), so that the
    order of the additions depends on N alone."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        head = x[:half] + x[half : 2 * half]
        x = torch.cat([head, x[2 * half :]]) if x.shape[0] % 2 else head
    return x[0]


class OpenES(CenterES):
    # The population-sized buffer (the JAX package's precision map).
    storage_leaves = ("fit",)

    def __init__(
        self,
        pop_size: int,
        center_init,
        learning_rate: float,
        noise_stdev: float,
        optimizer: Literal["adam"] | None = None,
        mirrored_sampling: bool = True,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if noise_stdev <= 0 or learning_rate <= 0 or pop_size <= 0:
            raise ValueError(
                f"noise_stdev, learning_rate and pop_size must all be "
                f"positive, got {noise_stdev}, {learning_rate}, {pop_size}"
            )
        if mirrored_sampling and pop_size % 2 != 0:
            raise ValueError(f"mirrored sampling requires an even pop_size, got {pop_size}")
        self.pop_size = pop_size
        self._init_center(center_init, dtype, device)
        self.noise_stdev = noise_stdev
        self.mirrored_sampling = mirrored_sampling
        self._init_optimizer(optimizer, learning_rate)

    def setup(self, key: torch.Tensor) -> State:
        return State(
            key=key.to(self.device),
            noise_stdev=self._param(self.noise_stdev),
            center=self.center_init.clone(),
            fit=self._empty_fit(),
            **self._opt_state(self.center_init),
        )

    def step(self, state: State, evaluate: EvalFn) -> State:
        if self.mirrored_sampling:
            key, (half,) = self._normals(state, [(self.pop_size // 2, self.dim)])
            noise = torch.cat([half, -half], dim=0)
        else:
            key, (noise,) = self._normals(state, [(self.pop_size, self.dim)])
        pop = state.center + state.noise_stdev * noise
        fit = evaluate(pop)
        grad = _pairwise_row_sum(noise * fit[:, None]) / self.pop_size / state.noise_stdev
        return state.replace(key=key, fit=fit, **self._opt_update(state, grad))
