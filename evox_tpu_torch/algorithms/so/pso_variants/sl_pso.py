"""Social-Learning PSO with Gaussian- and uniform-sampled demonstrators
(counterpart of ``evox_tpu/algorithms/so/pso_variants/sl_pso.py``): each
particle imitates a demonstrator drawn from the better-ranked part of the
swarm — by a folded-Gaussian index (GS) or a uniform range whose lower end
rises with the particle's own rank (US) — and is pulled toward the swarm
mean.

A generation makes two draw launches (the (pop,) demonstrator draw, then
the three (pop, dim) uniforms) and reads nothing on the host.  The ranking
is a stable sort of ``-fit`` (``jnp.argsort``'s order: ties by index, -0.0
equal to +0.0, NaN last).
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....ops.philox import philox_draws
from ....utils import rng
from ...validation import bounds
from .utils import init_swarm, min_by

__all__ = ["SLPSOGS", "SLPSOUS"]


class _SLPSOBase(Algorithm):
    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        social_influence_factor: float = 0.2,
        demonstrator_choice_factor: float = 0.7,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size.
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param social_influence_factor: ``epsilon``, pull toward the mean.
        :param demonstrator_choice_factor: ``theta``, demonstrator spread.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.epsilon = social_influence_factor
        self.theta = demonstrator_choice_factor
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, pop, velocity = init_swarm(key, self.pop_size, self.lb, self.ub)
        return State(
            key=key,
            social_influence_factor=Parameter(self.epsilon, dtype=self.dtype, device=self.device),
            demonstrator_choice_factor=Parameter(self.theta, dtype=self.dtype, device=self.device),
            pop=pop,
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
            velocity=velocity,
            global_best_location=pop[0].clone(),
            global_best_fit=torch.tensor(float("inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, global_best_fit=torch.min(fit))

    def _demonstrator_draw(self, seed) -> torch.Tensor:
        """The (pop,) draw the demonstrator index is made from."""
        raise NotImplementedError

    def _demonstrator_index(self, draw: torch.Tensor, state: State) -> torch.Tensor:
        raise NotImplementedError

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (demo, (r1,
        r2, r3)))`` to supply them — the (pop,) demonstrator draw (standard
        normals for GS, uniforms for US) and three (pop, dim) uniforms; the
        parity tests inject the JAX package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        n, d = self.pop_size, self.dim
        key, (demo_seed, r_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state)
        if draws is None:
            demo = self._demonstrator_draw(demo_seed)
            r1, r2, r3 = (r.reshape(n, d) for r in philox_draws(r_seed, n * d, [self.dtype] * 3, self.device))
        else:
            demo, (r1, r2, r3) = draws
        global_best_location, global_best_fit = min_by(
            [state.global_best_location[None, :], state.pop],
            [state.global_best_fit[None], state.fit],
        )
        # Worst-to-best ranking; demonstrators are drawn near the best end.
        ranked_population = state.pop[torch.argsort(-state.fit, stable=True)]
        x_k = ranked_population[self._demonstrator_index(demo, state)]
        x_avg = torch.mean(state.pop, dim=0)
        velocity = (
            r1 * state.velocity
            + r2 * (x_k - state.pop)
            + r3 * state.social_influence_factor * (x_avg - state.pop)
        )
        pop = torch.clamp(state.pop + velocity, self.lb, self.ub)
        velocity = torch.clamp(velocity, self.lb, self.ub)
        fit = evaluate(pop)
        return state.replace(
            key=key,
            pop=pop,
            fit=fit,
            velocity=velocity,
            global_best_location=global_best_location,
            global_best_fit=global_best_fit,
        )

    def _ranks(self) -> torch.Tensor:
        """``arange(n) + 1`` in the working dtype."""
        return torch.arange(self.pop_size, dtype=self.dtype, device=self.device) + 1


class SLPSOGS(_SLPSOBase):
    """Social-learning PSO with Gaussian-sampled demonstrator choice."""

    def _demonstrator_draw(self, seed) -> torch.Tensor:
        return rng.normal(seed, (self.pop_size,), self.dtype, self.device)

    def _demonstrator_index(self, draw: torch.Tensor, state: State) -> torch.Tensor:
        n = self.pop_size
        sigma = state.demonstrator_choice_factor * (n - self._ranks())
        normal = sigma * (-torch.abs(draw)) + n
        return torch.clamp(normal, 1, n).to(torch.int32) - 1


class SLPSOUS(_SLPSOBase):
    """Social-learning PSO with uniform-sampled demonstrator choice."""

    def _demonstrator_draw(self, seed) -> torch.Tensor:
        return rng.uniform(seed, (self.pop_size,), self.dtype, self.device)

    def _demonstrator_index(self, draw: torch.Tensor, state: State) -> torch.Tensor:
        n = self.pop_size
        q = torch.clamp(n - torch.ceil(state.demonstrator_choice_factor * (n - self._ranks() - 1)), 1, n)
        uniform = draw * (n + 1 - q) + q
        return torch.clamp(torch.floor(uniform).to(torch.int32) - 1, 0, n - 1)
