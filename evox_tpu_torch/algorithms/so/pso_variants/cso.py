"""Competitive Swarm Optimizer (counterpart of
``evox_tpu/algorithms/so/pso_variants/cso.py``): random pairwise contests;
each loser learns from its winner and, weighted by ``phi``, from the
swarm's center.  Only the losing half is evaluated each generation.

A generation makes two draw launches (the pairing permutation and the three
uniforms of the losers' update) and reads nothing on the host.
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....utils import rng
from ....ops.philox import philox_draws
from ...validation import bounds
from .utils import init_swarm

__all__ = ["CSO"]


class CSO(Algorithm):
    """Competitive swarm optimizer."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        phi: float = 0.0,
        mean=None,
        stdev=None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size (must be even: pairwise contests).
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param phi: social factor toward the swarm center.
        :param mean: optional Gaussian init mean (with ``stdev``).
        :param stdev: optional Gaussian init stdev.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if pop_size % 2 != 0:
            raise ValueError(f"CSO needs an even population for pairing, got pop_size={pop_size}")
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.phi = phi
        self.mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=self.device)
        self.stdev = None if stdev is None else torch.as_tensor(stdev, dtype=dtype, device=self.device)
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, pop, velocity = init_swarm(key, self.pop_size, self.lb, self.ub, self.mean, self.stdev)
        return State(
            key=key,
            phi=Parameter(self.phi, dtype=self.dtype, device=self.device),
            pop=pop,
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
            velocity=velocity,
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        return state.replace(fit=evaluate(state.pop))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (perm,
        (lambda1, lambda2, lambda3)))`` to supply them — a permutation of
        the population and three (pop_size / 2, dim) uniforms; the parity
        tests inject the JAX package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        half = self.pop_size // 2
        key, (pair_seed, lam_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state)
        if draws is None:
            perm = rng.permutation(pair_seed, self.pop_size, self.device)
            lams = philox_draws(lam_seed, half * self.dim, [self.dtype] * 3, self.device)
            lambda1, lambda2, lambda3 = (u.reshape(half, self.dim) for u in lams)
        else:
            perm, (lambda1, lambda2, lambda3) = draws
        left, right = perm.reshape(2, half)
        winner_is_left = state.fit[left] < state.fit[right]
        teachers = torch.where(winner_is_left, left, right)
        students = torch.where(winner_is_left, right, left)
        center = torch.mean(state.pop, dim=0)

        student_pop = state.pop[students]
        student_velocity = (
            lambda1 * state.velocity[students]
            + lambda2 * (state.pop[teachers] - student_pop)
            + state.phi * lambda3 * (center - student_pop)
        )
        vel_range = self.ub - self.lb
        student_velocity = torch.clamp(student_velocity, -vel_range, vel_range)
        candidates = torch.clamp(student_pop + student_velocity, self.lb, self.ub)
        candidates_fit = evaluate(candidates)
        return state.replace(
            key=key,
            pop=state.pop.index_copy(0, students, candidates),
            velocity=state.velocity.index_copy(0, students, student_velocity),
            fit=state.fit.index_copy(0, students, candidates_fit),
        )
