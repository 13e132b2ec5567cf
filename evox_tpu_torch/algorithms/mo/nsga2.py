"""NSGA-II (counterpart of ``evox_tpu/algorithms/mo/nsga2.py``):
tournament selection on (rank, -crowding distance), SBX crossover,
polynomial mutation, then ``nd_environmental_selection`` over the merged
2N population — which runs the port's dominance, rank and crowding kernels
on the card.

References:
    [1] K. Deb et al., "A fast and elitist multiobjective genetic algorithm:
        NSGA-II," IEEE TEVC 6(2), 2002.
"""

from __future__ import annotations

from typing import Callable

import torch

from ... import resolve_device
from ...core import Algorithm, EvalFn, State
from ...operators.crossover import simulated_binary
from ...operators.mutation import polynomial_mutation
from ...operators.selection import (
    crowding_distance,
    nd_environmental_selection,
    non_dominate_rank,
    tournament_selection_multifit,
)
from ...utils import rng
from ..validation import validate_bounds

__all__ = ["NSGA2"]


class NSGA2(Algorithm):
    """Tensorized NSGA-II for multi-objective optimization."""

    storage_leaves = ("pop", "fit", "dis")
    # The compute dtypes each CUDA kernel of a step takes (StdWorkflow
    # refuses any other at setup, on the card, before a launch): the
    # crowding distance's neighbours of the objectives, the tournament's
    # rank of (-distance, rank).
    kernel_dtypes = {"crowding_neighbors": (torch.float32,), "lex_rank": (torch.float32,)}

    def __init__(
        self,
        pop_size: int,
        n_objs: int,
        lb,
        ub,
        selection_op: Callable | None = None,
        mutation_op: Callable | None = None,
        crossover_op: Callable | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: population size.
        :param n_objs: number of objectives.
        :param lb: 1-D lower bounds of the decision variables.
        :param ub: 1-D upper bounds of the decision variables.
        :param selection_op: mating selection ``(key, n_round, fitnesses) ->
            indices``; defaults to the multi-fitness tournament on (rank,
            -crowding distance).
        :param mutation_op: ``(key, x, lb, ub) -> x``; defaults to
            :func:`polynomial_mutation`.
        :param crossover_op: ``(key, x) -> x``; defaults to
            :func:`simulated_binary`.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        lb = torch.as_tensor(lb, dtype=dtype, device=self.device)
        ub = torch.as_tensor(ub, dtype=dtype, device=self.device)
        validate_bounds(lb, ub)
        self.pop_size = pop_size
        self.n_objs = n_objs
        self.dim = lb.shape[0]
        self.lb = lb
        self.ub = ub
        self.dtype = dtype
        self.selection = selection_op or tournament_selection_multifit
        self.mutation = mutation_op or polynomial_mutation
        self.crossover = crossover_op or simulated_binary

    def setup(self, key: torch.Tensor) -> State:
        # The key lives on the device of the state (no host reads it).
        key, (init_seed,) = rng.split(key.to(self.device))
        shape = (self.pop_size, self.dim)
        pop = rng.uniform(init_seed, shape, self.dtype, self.device) * (self.ub - self.lb) + self.lb
        return State(
            key=key,
            pop=pop,
            fit=torch.full(
                (self.pop_size, self.n_objs), float("inf"), dtype=self.dtype, device=self.device
            ),
            rank=torch.zeros((self.pop_size,), dtype=torch.int32, device=self.device),
            dis=torch.full((self.pop_size,), float("-inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        # Rank and crowding stay aligned with the population's row order.
        fit = evaluate(state.pop)
        rank = non_dominate_rank(fit)
        dis = crowding_distance(fit)
        return state.replace(fit=fit, rank=rank, dis=dis)

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` makes them
        from the state's key.  A subclass may return ``(state, (mating_pool,
        sbx_draws, pm_draws))`` to supply them — the mating-pool indices
        (N,), SBX's ``(mu, direction, p1, p2)`` of shape (N//2, D) and the
        mutation's ``(site, mu)`` of shape (N, D); the parity tests inject
        the JAX package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, sel_key, x_key, mut_key = rng.split_keys(state.key, 4)
        state, draws = self._draws(state)
        fitnesses = [-state.dis, state.rank.to(state.dis.dtype)]
        if draws is None:
            mating_pool = self.selection(sel_key, self.pop_size, fitnesses)
            crossovered = self.crossover(x_key, state.pop[mating_pool])
            offspring = self.mutation(mut_key, crossovered, self.lb, self.ub)
        else:
            mating_pool, sbx, pm = draws
            crossovered = self.crossover(None, state.pop[mating_pool], draws=sbx)
            offspring = self.mutation(None, crossovered, self.lb, self.ub, draws=pm)
        offspring = torch.clamp(offspring, self.lb, self.ub)
        off_fit = evaluate(offspring)
        merge_pop = torch.cat([state.pop, offspring], dim=0)
        merge_fit = torch.cat([state.fit, off_fit], dim=0)
        pop, fit, rank, dis = nd_environmental_selection(merge_pop, merge_fit, self.pop_size)
        return state.replace(key=key, pop=pop, fit=fit, rank=rank, dis=dis)
