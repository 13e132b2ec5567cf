"""Shared base of the ES family (counterpart of
``evox_tpu/algorithms/so/es_variants/base.py``): the standard-normal draws
of a generation with their ``_draws`` seam, and :class:`CenterES`, the ES
variants that move a center by an estimated gradient, optionally through
Adam.

Every draw of a generation is a standard normal: an algorithm that draws
``k`` arrays takes the seeds ``s .. s+k-1`` of one ``rng.split`` and
launches the draw kernel once for each (one ``rng.normal`` a draw).
"""

from __future__ import annotations

from typing import Literal, Sequence

import torch

from .... import resolve_device
from ....core import Algorithm, Parameter, State
from ....utils import rng
from .opt import adam_single_tensor

__all__ = ["ESAlgorithm", "CenterES"]


class ESAlgorithm(Algorithm):
    """An ES algorithm on one device and dtype, with the generation's
    normal draws behind a ``_draws`` seam."""

    dtype: torch.dtype
    device: torch.device

    def _place(self, dtype: torch.dtype, device) -> None:
        self.dtype = dtype
        self.device = resolve_device(device)

    def _tensor(self, x) -> torch.Tensor:
        """``x`` as a tensor of the algorithm's dtype on its device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _dtype_of(self, x) -> torch.dtype:
        """The dtype the JAX package gives a Python scalar: int32 for an
        int, the algorithm's float dtype otherwise."""
        return torch.int32 if isinstance(x, int) and not isinstance(x, bool) else self.dtype

    def _param(self, x) -> Parameter:
        return Parameter(x, dtype=self._dtype_of(x), device=self.device)

    def _scalar(self, x) -> torch.Tensor:
        return torch.tensor(x, dtype=self._dtype_of(x), device=self.device)

    def _empty_fit(self) -> torch.Tensor:
        return torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device)

    def _draws(self, state: State):
        """The generation's normal draws: ``(state, None)`` draws them from
        the state's key.  A subclass may return ``(state, [z, ...])`` to
        supply them, one standard-normal tensor for each shape the step
        asks for; the parity tests inject the JAX package's draws this
        way."""
        return state, None

    def _normals(self, state: State, shapes: Sequence[tuple]) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The advanced key and one standard-normal draw of each shape,
        drawn from seeds ``0 .. len(shapes) - 1`` of one split of the
        state's key (one draw-kernel launch each), or supplied through
        :meth:`_draws`."""
        key, seeds = rng.split(state.key, len(shapes))
        _, draws = self._draws(state)
        if draws is None:
            draws = [rng.normal(s, shape, self.dtype, state.key.device) for s, shape in zip(seeds, shapes)]
        return key, list(draws)


class CenterES(ESAlgorithm):
    """Base for ES variants that keep a center vector moved by an estimated
    gradient, optionally through Adam.  Subclasses call ``_opt_state()``
    inside ``setup`` and ``_opt_update(state, grad)`` inside ``step``."""

    optimizer: Literal["adam"] | None

    def _init_center(self, center_init, dtype: torch.dtype, device) -> None:
        self._place(dtype, device)
        self.center_init = self._tensor(center_init)
        self.dim = self.center_init.shape[0]

    def _init_optimizer(self, optimizer: Literal["adam"] | None, lr: float) -> None:
        if optimizer not in (None, "adam"):
            raise ValueError(f"optimizer must be None or 'adam', got {optimizer!r}")
        self.optimizer = optimizer
        self.lr = lr

    def _opt_state(self, center: torch.Tensor) -> dict:
        opt = {"lr": self._param(self.lr)}
        if self.optimizer == "adam":
            opt.update(
                exp_avg=torch.zeros_like(center),
                exp_avg_sq=torch.zeros_like(center),
                beta1=self._param(0.9),
                beta2=self._param(0.999),
            )
        return opt

    def _opt_update(self, state: State, grad: torch.Tensor) -> dict:
        """Descend the estimated gradient; returns State updates."""
        if self.optimizer is None:
            return {"center": state.center - state.lr * grad}
        center, exp_avg, exp_avg_sq = adam_single_tensor(
            state.center, grad, state.exp_avg, state.exp_avg_sq, state.beta1, state.beta2, state.lr
        )
        return {"center": center, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}

    def record_step(self, state: State) -> dict:
        return {"center": state.center}
