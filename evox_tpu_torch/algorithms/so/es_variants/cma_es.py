"""CMA-ES (counterpart of ``evox_tpu/algorithms/so/es_variants/cma_es.py``,
the tutorial variant of arXiv:1604.00772).

The covariance is decomposed every ``decomp_per_iter`` generations, as in
the JAX package; between decompositions sampling reuses the cached
transform ``A = B diag(sqrt(eigvals))`` and ``C^{-1/2}``.  The JAX package
branches with ``lax.cond`` on the device counter ``iteration``.  Here
``decomp_per_iter`` is a Python int: when it is 1 (the ``cmaes_cec``
configuration) the step decomposes unconditionally; when it is larger the
step hands the device predicate ``iteration % decomp_per_iter == 0`` to
:func:`evox_tpu_torch.ops.linalg.eigh` as ``due`` and keeps the new factors
or the cached ones with ``torch.where`` on it, so no host reads the
counter and a captured CUDA graph replays either side.  On the card above
d = 32 the Jacobi kernel reads ``due`` itself and skips its sweeps on the
other generations, as ``lax.cond`` does; the CPU and the n <= 32 route
compute every generation and the ``where`` discards the result.

:func:`~evox_tpu_torch.ops.linalg.eigh` makes no host sync on the card at
any d, so eager steps and a replayed graph use the same routine and give
the same bits.
"""

from __future__ import annotations

import math

import torch

from ....core import EvalFn, State
from ....ops import linalg
from .base import ESAlgorithm
from .opt import sort_by_key

__all__ = ["CMAES"]


class CMAES(ESAlgorithm):
    # The population-sized buffer (the JAX package's precision map, read
    # by the precision plane, evox_tpu_torch/precision/).
    storage_leaves = ("fit",)

    def __init__(
        self,
        mean_init,
        sigma: float,
        pop_size: int | None = None,
        weights=None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param mean_init: initial distribution mean, 1-D.
        :param sigma: initial step size.
        :param pop_size: λ; defaults to ``4 + floor(3 ln d)``.
        :param weights: recombination weights (μ of them); default log-rank.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if sigma <= 0:
            raise ValueError(f"sigma must be positive, got {sigma}")
        self._place(dtype, device)
        self.mean_init = self._tensor(mean_init)
        self.dim = dim = self.mean_init.shape[0]
        self.pop_size = pop_size or 4 + math.floor(3 * math.log(dim))
        if self.pop_size <= 0:
            raise ValueError(f"pop_size must be positive, got {self.pop_size}")
        self.mu = self.pop_size // 2
        self.sigma_init = sigma

        if weights is None:
            ranks = torch.arange(1, self.mu + 1, dtype=dtype, device=self.device)
            w = math.log((self.pop_size + 1) / 2) - torch.log(ranks)
            weights = w / torch.sum(w)
        self.weights = self._tensor(weights)
        mu_eff = float(torch.sum(self.weights) ** 2 / torch.sum(self.weights**2))
        self.mu_eff = mu_eff
        self.chi_n = math.sqrt(dim) * (1 - 1 / (4 * dim) + 1 / (21 * dim**2))

        c_sigma = (mu_eff + 2) / (dim + mu_eff + 5)
        self.c_sigma = c_sigma
        self.d_sigma = 1 + 2 * max(math.sqrt((mu_eff - 1) / (dim + 1)) - 1, 0) + c_sigma
        self.c_c = (mu_eff + 2) / (dim + 4 + 2 * mu_eff / dim)
        self.c_1 = c_1 = 2 / ((dim + 1.3) ** 2 + mu_eff)
        self.c_mu = c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((dim + 2) ** 2 + mu_eff))
        self.decomp_per_iter = max(int(1 / (c_1 + c_mu) / dim / 10), 1)

    def setup(self, key: torch.Tensor) -> State:
        def eye():
            return torch.eye(self.dim, dtype=self.dtype, device=self.device)

        return State(
            key=key.to(self.device),
            c_sigma=self._param(self.c_sigma),
            d_sigma=self._param(self.d_sigma),
            c_c=self._param(self.c_c),
            c_1=self._param(self.c_1),
            c_mu=self._param(self.c_mu),
            mean=self.mean_init.clone(),
            sigma=self._scalar(self.sigma_init),
            iteration=self._scalar(0),
            C=eye(),
            A=eye(),  # sampling transform B diag(sqrt(D))
            C_invsqrt=eye(),
            p_sigma=torch.zeros((self.dim,), dtype=self.dtype, device=self.device),
            p_c=torch.zeros((self.dim,), dtype=self.dtype, device=self.device),
            fit=self._empty_fit(),
        )

    @staticmethod
    def decompose(C: torch.Tensor, due: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``(A, C^{-1/2})`` of the symmetrised ``C``: ``A = B
        diag(sqrt(eigvals))`` with the eigenvalues clipped at 1e-8, as the
        JAX package computes them.  ``due``: :func:`linalg.eigh`'s
        predicate; where it is false the result is not the decomposition
        and the caller discards it."""
        C = (C + C.T) / 2
        eigvals, B = linalg.eigh(C, due=due)
        eigvals = torch.clamp(eigvals, min=1e-8)
        inv_sqrt = (B * (1.0 / torch.sqrt(eigvals))) @ B.T
        A = B * torch.sqrt(eigvals)
        return A, inv_sqrt

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, (noise,) = self._normals(state, [(self.pop_size, self.dim)])
        iteration = state.iteration + 1

        y = noise @ state.A.T  # y ~ N(0, C)
        pop = state.mean + state.sigma * y

        fit = evaluate(pop)
        fit_sorted, pop_sorted = sort_by_key(fit, pop)
        selected = pop_sorted[: self.mu]

        new_mean = state.mean + self.weights @ (selected - state.mean)
        delta_mean = new_mean - state.mean

        p_sigma = (1 - state.c_sigma) * state.p_sigma + torch.sqrt(
            state.c_sigma * (2 - state.c_sigma) * self.mu_eff
        ) * (state.C_invsqrt @ delta_mean) / state.sigma
        h_sigma = (
            torch.linalg.vector_norm(p_sigma) / torch.sqrt(1 - (1 - state.c_sigma) ** (2 * iteration))
            < (1.4 + 2 / (self.dim + 1)) * self.chi_n
        ).to(pop.dtype)

        p_c = (1 - state.c_c) * state.p_c + h_sigma * torch.sqrt(
            state.c_c * (2 - state.c_c) * self.mu_eff
        ) * delta_mean / state.sigma

        y_sel = (selected - state.mean) / state.sigma
        C = (
            (1 - state.c_1 - state.c_mu) * state.C
            + state.c_1 * (torch.outer(p_c, p_c) + (1 - h_sigma) * state.c_c * (2 - state.c_c) * state.C)
            + state.c_mu * (y_sel.T * self.weights) @ y_sel
        )
        sigma = state.sigma * torch.exp(
            state.c_sigma / state.d_sigma * (torch.linalg.vector_norm(p_sigma) / self.chi_n - 1)
        )

        if self.decomp_per_iter > 1:
            # One side kept by the device predicate: no host reads the
            # counter, and the Jacobi kernel skips its sweeps when not due.
            due = iteration % self.decomp_per_iter == 0
            A, C_invsqrt = self.decompose(C, due)
            A = torch.where(due, A, state.A)
            C_invsqrt = torch.where(due, C_invsqrt, state.C_invsqrt)
        else:
            A, C_invsqrt = self.decompose(C)

        return state.replace(
            key=key,
            mean=new_mean,
            sigma=sigma,
            iteration=iteration,
            C=C,
            A=A,
            C_invsqrt=C_invsqrt,
            p_sigma=p_sigma,
            p_c=p_c,
            fit=fit_sorted,
        )

    def record_step(self, state: State) -> dict:
        return {"mean": state.mean, "sigma": state.sigma}
