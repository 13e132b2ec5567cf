"""MOEA/D: decomposition-based multi-objective optimization (counterpart of
``evox_tpu/algorithms/mo/moead.py``).

The tensorized MOEA/D of the JAX package: every subproblem makes one
offspring from two random neighbours in parallel, the offspring are
evaluated in one batch, and each member of a neighbourhood is replaced by
the best improving offspring whose neighbourhood contains it (two
scatter-mins, which do not depend on the order of the scatter).  The
neighbour table is built once, at construction, on the host.

References:
    [1] Q. Zhang and H. Li, "MOEA/D: A Multiobjective Evolutionary Algorithm
        Based on Decomposition," IEEE TEVC 11(6), 2007.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ... import resolve_device
from ...core import Algorithm, EvalFn, State
from ...operators.crossover import simulated_binary_half
from ...operators.mutation import polynomial_mutation
from ...operators.sampling import uniform_sampling
from ...utils import rng
from ..validation import validate_bounds

__all__ = ["MOEAD", "pbi"]


def pbi(f: torch.Tensor, w: torch.Tensor, z: torch.Tensor, theta: float = 5.0) -> torch.Tensor:
    """Penalty-based boundary intersection aggregation: the projection
    distance along the weight direction plus ``theta`` times the
    perpendicular deviation."""
    norm_w = torch.linalg.vector_norm(w, dim=-1)
    f = f - z
    d1 = torch.sum(f * w, dim=-1) / norm_w
    d2 = torch.linalg.vector_norm(f - d1[..., None] * w / norm_w[..., None], dim=-1)
    return d1 + theta * d2


class MOEAD(Algorithm):
    """Tensorized MOEA/D with PBI aggregation and parallel neighbourhood
    replacement."""

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
        :param pop_size: requested population size; rounded to the
            Das-Dennis weight-vector count.
        :param n_objs: number of objectives.
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param selection_op: accepted and unused, as in the JAX package.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        self.device = resolve_device(device)
        lb = torch.as_tensor(lb, dtype=dtype, device=self.device)
        ub = torch.as_tensor(ub, dtype=dtype, device=self.device)
        validate_bounds(lb, ub)
        self.n_objs = n_objs
        self.dim = lb.shape[0]
        self.lb = lb
        self.ub = ub
        self.dtype = dtype
        self.mutation = mutation_op or polynomial_mutation
        self.crossover = crossover_op or simulated_binary_half
        del selection_op

        w, n_vec = uniform_sampling(pop_size, n_objs)
        w = w.to(dtype)
        self.pop_size = n_vec
        self.n_neighbor = int(math.ceil(self.pop_size / 10))
        # Neighbourhoods: each subproblem's n_neighbor closest weight
        # vectors, by a stable sort of the distances (the lattice has many
        # equal distances; ties go to the lower index).
        dist = torch.linalg.vector_norm(w[:, None, :] - w[None, :, :], dim=-1)
        neighbors = torch.argsort(dist, dim=1, stable=True)[:, : self.n_neighbor]
        self.w = w.to(self.device)
        self.neighbors = neighbors.to(self.device)

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))
        shape = (self.pop_size, self.dim)
        pop = rng.uniform(init_seed, shape, self.dtype, self.device) * (self.ub - self.lb) + self.lb
        return State(
            key=key,
            pop=pop,
            fit=torch.full(
                (self.pop_size, self.n_objs), float("inf"), dtype=self.dtype, device=self.device
            ),
            z=torch.zeros((self.n_objs,), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, z=torch.amin(fit, dim=0))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` makes them
        from the state's key.  A subclass may return ``(state, (parents,
        sbx_draws, pm_draws))`` to supply them — the (P, 2) positions of
        each subproblem's two parents in its neighbourhood, SBX's ``(mu,
        direction, p1, p2)`` of shape (P, D) and the mutation's ``(site,
        mu)`` of shape (P, D); the parity tests inject the JAX package's
        draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        P, T = self.pop_size, self.n_neighbor
        key, parent_key, x_key, mut_key = rng.split_keys(state.key, 4)
        state, draws = self._draws(state)
        if draws is None:
            # Each subproblem draws two distinct random neighbours.
            pick = rng.permutation(rng.child(parent_key), (P, T), state.pop.device)[:, :2]
        else:
            pick, sbx, pm = draws
        parents = torch.take_along_dim(self.neighbors, pick, dim=1)  # (P, 2)
        # One SBX-half offspring per subproblem: pair layout (p1; p2).
        pairs = torch.cat([state.pop[parents[:, 0]], state.pop[parents[:, 1]]], dim=0)
        if draws is None:
            offspring = self.crossover(x_key, pairs)
            offspring = self.mutation(mut_key, offspring, self.lb, self.ub)
        else:
            offspring = self.crossover(None, pairs, draws=sbx)
            offspring = self.mutation(None, offspring, self.lb, self.ub, draws=pm)
        offspring = torch.clamp(offspring, self.lb, self.ub)
        off_fit = evaluate(offspring)

        z = torch.minimum(state.z, torch.amin(off_fit, dim=0))

        # Offspring i may replace any member of its neighbourhood whose
        # subproblem it improves; each member takes the best improving
        # claimant, ties to the lowest offspring.
        nb_w = self.w[self.neighbors]  # (P, T, m)
        g_old = pbi(state.fit[self.neighbors], nb_w, z)
        g_new = pbi(off_fit[:, None, :], nb_w, z)
        inf = torch.full((), float("inf"), dtype=g_new.dtype, device=g_new.device)
        flat_target = self.neighbors.reshape(-1)
        flat_gnew = torch.where(g_new <= g_old, g_new, inf).reshape(-1)
        best_g = torch.full((P,), float("inf"), dtype=g_new.dtype, device=g_new.device)
        best_g = best_g.scatter_reduce(0, flat_target, flat_gnew, "amin")
        off_idx = torch.arange(P, device=g_new.device)[:, None].expand(P, T).reshape(-1)
        is_best = (flat_gnew == best_g[flat_target]) & torch.isfinite(flat_gnew)
        claimant = torch.full((P,), P, dtype=off_idx.dtype, device=g_new.device)
        claimant = claimant.scatter_reduce(0, flat_target, torch.where(is_best, off_idx, P), "amin")
        replaced = (claimant < P)[:, None]
        safe = torch.clamp(claimant, max=P - 1)
        pop = torch.where(replaced, offspring[safe], state.pop)
        fit = torch.where(replaced, off_fit[safe], state.fit)
        return state.replace(key=key, pop=pop, fit=fit, z=z)
