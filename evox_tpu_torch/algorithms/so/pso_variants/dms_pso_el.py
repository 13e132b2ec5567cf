"""Dynamic Multi-Swarm PSO with Elite Learning (counterpart of
``evox_tpu/algorithms/so/pso_variants/dms_pso_el.py``): small dynamic
sub-swarms and one following sub-swarm, a random regroup every
``regrouped_iteration_num`` iterations, and a switch to a global-best
strategy in the last 10 % of ``max_iteration``.

The JAX package branches with two ``lax.cond``s.  Here both are selects on
the device, so a step reads nothing on the host and a CUDA graph holds it:

* the regroup is a gather by an index that is the regroup's permutation
  when the regroup fires and the identity otherwise (the same bits as
  gathering or not);
* both strategies' velocities are computed every generation and
  ``torch.where`` keeps the one of the phase; the personal-best fold they
  share is computed once, and the local best (strategy 1) and the global
  best (strategy 2) keep their old values in the other phase.

Both strategies draw from one launch of two (pop, dim) uniforms: strategy 1
takes its personal-best draw from the first and its local- and regional-
best draws from the first ``dyn`` and last ``following`` rows of the
second; strategy 2 takes both of its draws whole.  The regroup's
permutation is a second launch.  As in the JAX package, ``fit`` is
permuted with the rest when regrouping.
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....ops.philox import philox_draws
from ....utils import rng
from ...validation import bounds
from .utils import init_swarm

__all__ = ["DMSPSOEL"]


class DMSPSOEL(Algorithm):
    """Dynamic multi-swarm PSO with elite learning."""

    def __init__(
        self,
        lb,
        ub,
        dynamic_sub_swarm_size: int = 10,
        dynamic_sub_swarms_num: int = 5,
        following_sub_swarm_size: int = 10,
        regrouped_iteration_num: int = 50,
        max_iteration: int = 100,
        inertia_weight: float = 0.7,
        pbest_coefficient: float = 1.5,
        lbest_coefficient: float = 1.5,
        rbest_coefficient: float = 1.0,
        gbest_coefficient: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param dynamic_sub_swarm_size: particles per dynamic sub-swarm.
        :param dynamic_sub_swarms_num: number of dynamic sub-swarms.
        :param following_sub_swarm_size: particles in the following swarm.
        :param regrouped_iteration_num: regroup every this many iterations.
        :param max_iteration: total iterations (drives the strategy switch).
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.dim = self.lb.shape[0]
        self.pop_size = dynamic_sub_swarm_size * dynamic_sub_swarms_num + following_sub_swarm_size
        self.swarm_size = dynamic_sub_swarm_size
        self.swarms_num = dynamic_sub_swarms_num
        self.following_size = following_sub_swarm_size
        self.regrouped_iteration_num = regrouped_iteration_num
        self.max_iteration = max_iteration
        self.dtype = dtype
        self.hyper = dict(
            w=inertia_weight,
            c_pbest=pbest_coefficient,
            c_lbest=lbest_coefficient,
            c_rbest=rbest_coefficient,
            c_gbest=gbest_coefficient,
        )

    @property
    def _dyn(self) -> int:
        return self.swarm_size * self.swarms_num

    def setup(self, key: torch.Tensor) -> State:
        key, pop, velocity = init_swarm(key, self.pop_size, self.lb, self.ub)

        def inf(shape):
            return torch.full(shape, float("inf"), dtype=self.dtype, device=self.device)

        def int32(v):
            return Parameter(v, dtype=torch.int32, device=self.device)

        hyper = {k: Parameter(v, dtype=self.dtype, device=self.device) for k, v in self.hyper.items()}
        return State(
            key=key,
            regrouped_iteration_num=int32(self.regrouped_iteration_num),
            max_iteration=int32(self.max_iteration),
            **hyper,
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
            pop=pop,
            velocity=velocity,
            fit=inf((self.pop_size,)),
            personal_best_location=pop.clone(),
            personal_best_fit=inf((self.pop_size,)),
            local_best_location=pop[: self._dyn].reshape(self.swarms_num, self.swarm_size, self.dim)[:, 0, :].clone(),
            local_best_fit=inf((self.swarms_num,)),
            regional_best_index=torch.zeros((self.following_size,), dtype=torch.int32, device=self.device),
            global_best_location=torch.zeros((self.dim,), dtype=self.dtype, device=self.device),
            global_best_fit=inf(()),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, iteration=state.iteration + 1)

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (perm, u0,
        u1))`` to supply them — the regroup's permutation of the ``dyn``
        dynamic particles and the two (pop, dim) uniforms described in the
        module docstring; the parity tests inject the JAX package's draws
        this way."""
        return state, None

    # -- periodic regroup ----------------------------------------------------
    def _regroup(self, state: State, perm: torch.Tensor, fire: torch.Tensor) -> State:
        """The regroup where ``fire`` holds (a 0-dim bool), the state as it
        is otherwise: the dynamic part shuffled by ``perm``, the following
        part the worst-ranked particles (``dms_pso_el.py:178-191`` of the
        reference library), the regional best indices the ``following``
        best of the dynamic part."""
        dyn, n = self._dyn, self.pop_size
        sort_index = torch.argsort(state.fit, stable=True)
        regroup_index = torch.cat([perm, sort_index[dyn:]])
        index = torch.where(fire, regroup_index, torch.arange(n, dtype=regroup_index.dtype, device=self.device))
        regional_best_index = torch.argsort(state.fit[:dyn], stable=True)[: self.following_size].to(torch.int32)
        return state.replace(
            pop=state.pop[index],
            velocity=state.velocity[index],
            fit=state.fit[index],
            personal_best_location=state.personal_best_location[index],
            personal_best_fit=state.personal_best_fit[index],
            regional_best_index=torch.where(fire, regional_best_index, state.regional_best_index),
        )

    # -- phase 1: multi-swarm search ----------------------------------------
    def _velocity_1(self, state: State, pbest_loc: torch.Tensor, u0: torch.Tensor, u1: torch.Tensor):
        """Strategy 1's velocity (unclipped), local best location and
        fitness."""
        dyn, d = self._dyn, self.dim
        swarm_shape = (self.swarms_num, self.swarm_size)
        dyn_loc = state.pop[:dyn].reshape(*swarm_shape, d)
        dyn_fit = state.fit[:dyn].reshape(*swarm_shape)
        dyn_vel = state.velocity[:dyn].reshape(*swarm_shape, d)
        dyn_pbest = pbest_loc[:dyn].reshape(*swarm_shape, d)
        fol_loc = state.pop[dyn:]
        fol_vel = state.velocity[dyn:]
        fol_pbest = pbest_loc[dyn:]

        local_best_fit = torch.amin(dyn_fit, dim=1)
        local_best_idx = torch.argmin(dyn_fit, dim=1)
        local_best_location = torch.take_along_dim(dyn_loc, local_best_idx[:, None, None], dim=1).squeeze(1)
        regional_best_location = state.pop[state.regional_best_index]

        rand_lbest = u1[:dyn].reshape(*swarm_shape, d)
        rand_rbest = u1[dyn:]
        dyn_vel = (
            state.w * dyn_vel
            + state.c_pbest * u0[:dyn].reshape(*swarm_shape, d) * (dyn_pbest - dyn_loc)
            + state.c_lbest * rand_lbest * (local_best_location[:, None, :] - dyn_loc)
        )
        fol_vel = (
            state.w * fol_vel
            + state.c_pbest * u0[dyn:] * (fol_pbest - fol_loc)
            + state.c_rbest * rand_rbest * (regional_best_location - fol_loc)
        )
        velocity = torch.cat([dyn_vel.reshape(dyn, d), fol_vel])
        return velocity, local_best_location, local_best_fit

    # -- phase 2: global convergence ----------------------------------------
    def _velocity_2(self, state: State, pbest_loc: torch.Tensor, pbest_fit: torch.Tensor,
                    u0: torch.Tensor, u1: torch.Tensor):
        """Strategy 2's velocity (unclipped), global best location and
        fitness."""
        gbest_idx = torch.argmin(pbest_fit).reshape(1)
        gbest_loc = pbest_loc.index_select(0, gbest_idx)[0]
        gbest_fit = pbest_fit.index_select(0, gbest_idx)[0]
        velocity = (
            state.w * state.velocity
            + state.c_pbest * u0 * (pbest_loc - state.pop)
            + state.c_gbest * u1 * (gbest_loc - state.pop)
        )
        return velocity, gbest_loc, gbest_fit

    def step(self, state: State, evaluate: EvalFn) -> State:
        n, d = self.pop_size, self.dim
        key, (regroup_seed, rand_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state.replace(key=key))
        if draws is None:
            perm = rng.permutation(regroup_seed, self._dyn, self.device)
            u0, u1 = (u.reshape(n, d) for u in philox_draws(rand_seed, n * d, [self.dtype] * 2, self.device))
        else:
            perm, u0, u1 = draws

        phase1 = state.iteration < (0.9 * state.max_iteration).to(torch.int32)
        state = self._regroup(state, perm, phase1 & (state.iteration % state.regrouped_iteration_num == 0))
        compare = state.personal_best_fit > state.fit
        pbest_loc = torch.where(compare[:, None], state.pop, state.personal_best_location)
        pbest_fit = torch.where(compare, state.fit, state.personal_best_fit)
        v1, local_best_location, local_best_fit = self._velocity_1(state, pbest_loc, u0, u1)
        v2, gbest_loc, gbest_fit = self._velocity_2(state, pbest_loc, pbest_fit, u0, u1)
        velocity = torch.where(phase1, v1, v2)
        pop = torch.clamp(state.pop + velocity, self.lb, self.ub)
        state = state.replace(
            pop=pop,
            velocity=torch.clamp(velocity, self.lb, self.ub),
            personal_best_location=pbest_loc,
            personal_best_fit=pbest_fit,
            local_best_location=torch.where(phase1, local_best_location, state.local_best_location),
            local_best_fit=torch.where(phase1, local_best_fit, state.local_best_fit),
            global_best_location=torch.where(phase1, state.global_best_location, gbest_loc),
            global_best_fit=torch.where(phase1, state.global_best_fit, gbest_fit),
        )
        fit = evaluate(pop)
        return state.replace(fit=fit, iteration=state.iteration + 1)
