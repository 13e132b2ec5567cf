"""Comprehensive Learning PSO (counterpart of
``evox_tpu/algorithms/so/pso_variants/clpso.py``): each particle learns,
with the learning probability ``P_c``, from the personal best of the winner
of a random two-particle tournament instead of its own.

A generation makes two draw launches (the (pop, dim) coefficients, then the
two tournament indices and the learning draw) and reads nothing on the
host.
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....ops.philox import philox_draws
from ....utils import rng
from ...validation import bounds
from .utils import init_swarm, min_by

__all__ = ["CLPSO"]


class CLPSO(Algorithm):
    """Comprehensive-learning PSO."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        inertia_weight: float = 0.5,
        const_coefficient: float = 1.5,
        learning_probability: float = 0.05,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size.
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param inertia_weight: inertia weight ``w``.
        :param const_coefficient: acceleration coefficient ``c``.
        :param learning_probability: comprehensive-learning probability ``P_c``.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.dtype = dtype
        self.w = inertia_weight
        self.c = const_coefficient
        self.P_c = learning_probability

    def setup(self, key: torch.Tensor) -> State:
        key, pop, velocity = init_swarm(key, self.pop_size, self.lb, self.ub)

        def param(v):
            return Parameter(v, dtype=self.dtype, device=self.device)

        def inf(shape=(self.pop_size,)):
            return torch.full(shape, float("inf"), dtype=self.dtype, device=self.device)

        return State(
            key=key,
            w=param(self.w),
            c=param(self.c),
            P_c=param(self.P_c),
            pop=pop,
            fit=inf(),
            velocity=velocity,
            personal_best_location=pop.clone(),
            personal_best_fit=inf(),
            global_best_location=pop[0].clone(),
            global_best_fit=inf(()),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, personal_best_fit=fit, global_best_fit=torch.min(fit))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state,
        (random_coefficient, rand1, rand2, rand_possibility))`` to supply
        them — (pop, dim) uniforms, two (pop,) int64 indices and (pop,)
        uniforms; the parity tests inject the JAX package's draws this
        way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        n, d = self.pop_size, self.dim
        key, (coeff_seed, pick_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state)
        if draws is None:
            (random_coefficient,) = philox_draws(coeff_seed, n * d, [self.dtype], self.device)
            random_coefficient = random_coefficient.reshape(n, d)
            rand1, rand2, rand_possibility = philox_draws(pick_seed, n, [(0, n), (0, n), self.dtype], self.device)
        else:
            random_coefficient, rand1, rand2, rand_possibility = draws
        pbf = state.personal_best_fit
        learning_index = torch.where(pbf[rand1] < pbf[rand2], rand1, rand2)
        compare = pbf > state.fit
        personal_best_location = torch.where(compare[:, None], state.pop, state.personal_best_location)
        personal_best_fit = torch.where(compare, state.fit, pbf)
        global_best_location, global_best_fit = min_by(
            [state.global_best_location[None, :], state.pop],
            [state.global_best_fit[None], state.fit],
        )
        personal_best = torch.where(
            (rand_possibility < state.P_c)[:, None],
            personal_best_location[learning_index],
            personal_best_location,
        )
        velocity = state.w * state.velocity + state.c * random_coefficient * (personal_best - state.pop)
        velocity = torch.clamp(velocity, self.lb, self.ub)
        pop = torch.clamp(state.pop + velocity, self.lb, self.ub)
        fit = evaluate(pop)
        return state.replace(
            key=key,
            pop=pop,
            fit=fit,
            velocity=velocity,
            personal_best_location=personal_best_location,
            personal_best_fit=personal_best_fit,
            global_best_location=global_best_location,
            global_best_fit=global_best_fit,
        )
