"""Feature-Selection PSO (counterpart of
``evox_tpu/algorithms/so/pso_variants/fs_pso.py``): each generation moves
the elite half by the standard PSO update and refills the other half with
tournament-selected elites, mutated gene by gene.

A generation makes two draw launches (four (pop / 2, dim) uniforms: the
two velocity draws, the mutation offset and the mutation mask; then the two
tournament indices) and reads nothing on the host.  The elite half is the
first half of a stable sort of ``fit`` (``jnp.argsort``'s order: ties by
index, -0.0 equal to +0.0, NaN last).
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....ops.philox import philox_draws
from ....utils import rng
from ...validation import bounds
from .utils import init_swarm, min_by

__all__ = ["FSPSO"]


class FSPSO(Algorithm):
    """Feature-selection PSO with elite enhancement + mutation extension."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        inertia_weight: float = 0.6,
        cognitive_coefficient: float = 2.5,
        social_coefficient: float = 0.8,
        mean=None,
        stdev=None,
        mutate_rate: float = 0.01,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size (must be even: elite/offspring split).
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param mutate_rate: per-gene mutation probability of the offspring half.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if pop_size % 2 != 0:
            raise ValueError(f"FSPSO needs an even population, got pop_size={pop_size}")
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.w = inertia_weight
        self.phi_p = cognitive_coefficient
        self.phi_g = social_coefficient
        self.mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=self.device)
        self.stdev = None if stdev is None else torch.as_tensor(stdev, dtype=dtype, device=self.device)
        self.mutate_rate = mutate_rate
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, pop, velocity = init_swarm(
            key, self.pop_size, self.lb, self.ub, self.mean, self.stdev, normal_velocity=True
        )

        def param(v):
            return Parameter(v, dtype=self.dtype, device=self.device)

        def inf(shape=(self.pop_size,)):
            return torch.full(shape, float("inf"), dtype=self.dtype, device=self.device)

        return State(
            key=key,
            w=param(self.w),
            phi_p=param(self.phi_p),
            phi_g=param(self.phi_g),
            mutate_rate=param(self.mutate_rate),
            pop=pop,
            fit=inf(),
            velocity=velocity,
            local_best_location=pop.clone(),
            local_best_fit=inf(),
            global_best_location=pop[0].clone(),
            global_best_fit=inf(()),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, local_best_fit=fit, global_best_fit=torch.min(fit))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (rg, rp, t1,
        t2, offset_u, mask_u))`` to supply them — (pop / 2, dim) uniforms
        for the velocity update, two (pop / 2,) int64 tournament indices,
        and the (pop / 2, dim) uniforms of the mutation offset and mask;
        the parity tests inject the JAX package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        half, d = self.pop_size // 2, self.dim
        key, (u_seed, t_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state)
        if draws is None:
            rg, rp, offset_u, mask_u = (
                u.reshape(half, d) for u in philox_draws(u_seed, half * d, [self.dtype] * 4, self.device)
            )
            t1, t2 = philox_draws(t_seed, half, [(0, half), (0, half)], self.device)
        else:
            rg, rp, t1, t2, offset_u, mask_u = draws
        # Elite enhancement: standard PSO update of the best half.
        elite_index = torch.argsort(state.fit, stable=True)[:half]
        elite_pop = state.pop[elite_index]
        elite_velocity = state.velocity[elite_index]
        elite_fit = state.fit[elite_index]
        elite_lb_loc = state.local_best_location[elite_index]
        elite_lb_fit = state.local_best_fit[elite_index]

        compare = elite_lb_fit > elite_fit
        local_best_location = torch.where(compare[:, None], elite_pop, elite_lb_loc)
        local_best_fit = torch.where(compare, elite_fit, elite_lb_fit)
        global_best_location, global_best_fit = min_by(
            [state.global_best_location[None, :], elite_pop],
            [state.global_best_fit[None], elite_fit],
        )
        updated_velocity = (
            state.w * elite_velocity
            + state.phi_p * rp * (elite_lb_loc - elite_pop)
            + state.phi_g * rg * (global_best_location - elite_pop)
        )
        updated_pop = torch.clamp(elite_pop + updated_velocity, self.lb, self.ub)
        updated_velocity = torch.clamp(updated_velocity, self.lb, self.ub)

        # Extension: mutated tournament winners refill the other half.
        mutating_pool = torch.where(elite_fit[t1] < elite_fit[t2], t1, t2)
        original = elite_pop[mutating_pool]
        offspring_velocity = elite_velocity[mutating_pool]
        offset = (2 * offset_u - 1) * (self.ub - self.lb)
        mask = mask_u < state.mutate_rate
        offspring = torch.clamp(original + torch.where(mask, offset, 0), self.lb, self.ub)

        pop = torch.cat([updated_pop, offspring])
        fit = evaluate(pop)
        return state.replace(
            key=key,
            pop=pop,
            fit=fit,
            velocity=torch.cat([updated_velocity, offspring_velocity]),
            local_best_location=torch.cat([local_best_location, offspring]),
            local_best_fit=torch.cat(
                [local_best_fit, torch.full((half,), float("inf"), dtype=self.dtype, device=self.device)]
            ),
            global_best_location=global_best_location,
            global_best_fit=global_best_fit,
        )
