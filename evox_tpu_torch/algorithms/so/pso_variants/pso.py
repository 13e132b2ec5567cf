"""Particle Swarm Optimization (counterpart of
``evox_tpu/algorithms/so/pso_variants/pso.py``).

The move — personal-best fold, draws, velocity/position update, clamps —
goes through :func:`evox_tpu_torch.ops.pso_step.fused_pso_move` on every
device: the hand-written CUDA kernel on the card, its plain PyTorch version
on the CPU.  The global-best fold stays outside the kernel (it reads only
the (N,) fitness and one row of the population).
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....ops.pso_step import fused_pso_move
from ....utils import rng
from ...validation import bounds
from .utils import init_swarm, min_by

__all__ = ["PSO", "PallasPSO"]


class PSO(Algorithm):
    """Canonical inertia/cognitive/social PSO."""

    # The population-sized buffers that may be carried in a narrow storage
    # dtype between generations (the map a PrecisionPolicy applies).
    storage_leaves = (
        "pop",
        "velocity",
        "local_best_location",
        "local_best_fit",
        "fit",
    )
    # The compute dtypes each CUDA kernel of a step takes (StdWorkflow
    # refuses any other at setup, on the card, before a launch).
    kernel_dtypes = {"fused_pso_move": (torch.float32, torch.bfloat16)}

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        w: float = 0.6,
        phi_p: float = 2.5,
        phi_g: float = 0.8,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size.
        :param lb: 1-D lower bounds of the search space.
        :param ub: 1-D upper bounds of the search space.
        :param w: inertia weight.
        :param phi_p: cognitive (personal-best) weight.
        :param phi_g: social (global-best) weight.
        :param dtype: float32 or bfloat16 on the card (any float on the CPU).
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.w = w
        self.phi_p = phi_p
        self.phi_g = phi_g
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        # The key lives on the device of the state (no host reads it).
        key, pop, velocity = init_swarm(key, self.pop_size, self.lb, self.ub)

        def inf():
            return torch.full(
                (self.pop_size,), float("inf"), dtype=self.dtype, device=self.device
            )

        def param(v):
            return Parameter(v, dtype=self.dtype, device=self.device)

        return State(
            key=key,
            w=param(self.w),
            phi_p=param(self.phi_p),
            phi_g=param(self.phi_g),
            pop=pop,
            velocity=velocity,
            fit=inf(),
            local_best_location=pop.clone(),
            local_best_fit=inf(),
            global_best_location=pop[0].clone(),
            global_best_fit=torch.tensor(
                float("inf"), dtype=self.dtype, device=self.device
            ),
        )

    def _draws(self, state: State):
        """The move's random draws: ``(state, None)`` lets the kernel draw
        them itself (``rand="hw"``).  A subclass may return ``(state, (rp,
        rg))`` to supply them (``rand="input"``), with the state's key
        advanced past what it drew — the parity tests inject the JAX
        package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        # Fold the previous generation's fitness into the global best, then
        # move the swarm (personal-best fold inside the kernel) and
        # evaluate at the new positions.
        global_best_location, global_best_fit = min_by(
            [state.global_best_location[None, :], state.pop],
            [state.global_best_fit[None], state.fit],
        )
        state, draws = self._draws(state)
        key, (seed,) = rng.split(state.key)
        pop, velocity, local_best_location, local_best_fit = fused_pso_move(
            state.pop,
            state.velocity,
            state.local_best_location,
            state.fit,
            state.local_best_fit,
            global_best_location,
            self.lb,
            self.ub,
            state.w,
            state.phi_p,
            state.phi_g,
            seed=seed,
            rand_draws=draws,
            rand="hw" if draws is None else "input",
        )
        fit = evaluate(pop)
        return state.replace(
            key=key,
            pop=pop,
            velocity=velocity,
            fit=fit,
            local_best_location=local_best_location,
            local_best_fit=local_best_fit,
            global_best_location=global_best_location,
            global_best_fit=global_best_fit,
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        # First generation: evaluate the random swarm only, and set the
        # global-best location too (so a fitness tie in the next step cannot
        # resolve to a stale position).
        fit = evaluate(state.pop)
        best = torch.argmin(fit).reshape(1)
        return state.replace(
            fit=fit,
            local_best_fit=fit,
            global_best_fit=fit.index_select(0, best)[0],
            global_best_location=state.pop.index_select(0, best)[0],
        )


class PallasPSO(PSO):
    """PSO with the reference's choice of where the move's draws are made
    (counterpart of ``evox_tpu/algorithms/so/pso_variants/pallas_pso.py``).

    :class:`PSO` already runs the fused move kernel on every step, so this
    class adds only ``rand``: ``"hw"`` (default) draws inside the kernel,
    the same states as :class:`PSO`; ``"input"`` makes two
    :func:`~evox_tpu_torch.utils.rng.uniform` draws of the population's
    shape and dtype outside it, from the state's key, and hands them to the
    kernel (two more (N, D) arrays to read).  The JAX class's lane padding
    is a constraint of the TPU compiler and has no counterpart here."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        w: float = 0.6,
        phi_p: float = 2.5,
        phi_g: float = 0.8,
        dtype: torch.dtype = torch.float32,
        rand: str = "hw",
        device: str | torch.device | None = None,
    ):
        super().__init__(pop_size, lb, ub, w, phi_p, phi_g, dtype=dtype, device=device)
        if rand not in ("hw", "input"):
            raise ValueError(f"rand must be 'hw' or 'input', got {rand!r}")
        self.rand = rand

    def _draws(self, state: State):
        if self.rand == "hw":
            return state, None
        key, (rp_seed, rg_seed) = rng.split(state.key, 2)
        shape, dtype, device = state.pop.shape, state.pop.dtype, state.pop.device
        draws = (rng.uniform(rp_seed, shape, dtype, device), rng.uniform(rg_seed, shape, dtype, device))
        return state.replace(key=key), draws
