"""RVEA: reference-vector guided evolutionary algorithm (counterpart of
``evox_tpu/algorithms/mo/rvea.py``).

APD-based survivor selection against a Das-Dennis reference-vector set,
with periodic reference-vector adaptation.  The population keeps the fixed
reference-vector count, NaN rows marking empty slots.  Nothing in a
generation reads a device value on the host: the mating pool's bound (the
count of valid rows) stays on the device (:func:`~evox_tpu_torch.utils.
rng.randint_below`), and the adaptation is a ``torch.where`` over both
branches (the JAX package's ``lax.cond``), so a generation can be captured
in a CUDA graph.

References:
    [1] R. Cheng et al., "A reference vector guided evolutionary algorithm
        for many-objective optimization," IEEE TEVC 20(5), 2016.
"""

from __future__ import annotations

from typing import Callable

import torch

from ... import resolve_device
from ...core import Algorithm, EvalFn, Parameter, State
from ...operators.crossover import simulated_binary
from ...operators.mutation import polynomial_mutation
from ...operators.sampling import uniform_sampling
from ...operators.selection import ref_vec_guided
from ...utils import nanmax, nanmin, rng
from ..validation import validate_bounds

__all__ = ["RVEA"]


def _valid_mating_pool(
    key: torch.Tensor | None, pop: torch.Tensor, n: int, mating: torch.Tensor | None = None
) -> torch.Tensor:
    """``n`` rows drawn uniformly among the non-NaN rows of ``pop`` (NaN
    rows are empty slots).

    :param mating: (n,) indices into the valid rows in order, to use
        instead of drawing them from ``key``."""
    valid = ~torch.isnan(pop).all(dim=1)
    if mating is None:
        num_valid = torch.clamp(valid.sum(), min=1)
        mating = rng.randint_below(rng.child(key), (n,), num_valid, pop.device)
    # The valid rows first, in order (a stable sort: no boolean indexing).
    compact = torch.argsort((~valid).to(torch.int32), stable=True)
    return pop[compact[mating]]


def _adapt_every(fr: torch.Tensor) -> torch.Tensor:
    """Generations between reference-vector adaptations, ``max(round(1 /
    fr), 1)``, as a 0-dim int32 tensor."""
    return torch.clamp(torch.round(1.0 / fr), min=1.0).to(torch.int32)


def _adapted(init_v: torch.Tensor, fit: torch.Tensor) -> torch.Tensor:
    """The initial vectors scaled to the objective ranges of ``fit``."""
    return init_v * (nanmax(fit, dim=0) - nanmin(fit, dim=0))


class RVEA(Algorithm):
    """Tensorized RVEA with angle-penalized-distance selection."""

    def __init__(
        self,
        pop_size: int,
        n_objs: int,
        lb,
        ub,
        alpha: float = 2.0,
        fr: float = 0.1,
        max_gen: int = 100,
        selection_op: Callable | None = None,
        mutation_op: Callable | None = None,
        crossover_op: Callable | None = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param pop_size: requested population size; rounded to the
            Das-Dennis reference-vector count.
        :param n_objs: number of objectives.
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
        :param alpha: APD penalty rate-of-change parameter.
        :param fr: reference-vector adaptation frequency.
        :param max_gen: expected number of generations (drives the APD
            ramp).
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
        self.alpha = alpha
        self.fr = fr
        self.max_gen = max_gen
        self.selection = selection_op or ref_vec_guided
        self.mutation = mutation_op or polynomial_mutation
        self.crossover = crossover_op or simulated_binary
        v, n_vec = uniform_sampling(pop_size, n_objs)
        self.init_v = v.to(dtype=dtype, device=self.device)
        self.pop_size = n_vec

    def _params(self) -> dict:
        return {
            name: Parameter(value, dtype=self.dtype, device=self.device)
            for name, value in (("alpha", self.alpha), ("fr", self.fr), ("max_gen", self.max_gen))
        }

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))
        shape = (self.pop_size, self.dim)
        pop = rng.uniform(init_seed, shape, self.dtype, self.device) * (self.ub - self.lb) + self.lb
        return State(
            key=key,
            **self._params(),
            pop=pop,
            fit=torch.full(
                (self.pop_size, self.n_objs), float("inf"), dtype=self.dtype, device=self.device
            ),
            reference_vector=self.init_v,
            gen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        return state.replace(fit=evaluate(state.pop))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` makes them
        from the state's key.  A subclass may return ``(state, (mating,
        sbx_draws, pm_draws))`` to supply them — the (N,) indices into the
        valid rows, SBX's ``(mu, direction, p1, p2)`` of shape (N//2, D)
        and the mutation's ``(site, mu)`` of shape (N, D); the parity tests
        inject the JAX package's draws this way."""
        return state, None

    def _offspring(self, state: State, keys, draws) -> torch.Tensor:
        """Mating pool among the valid rows, SBX, mutation and clipping."""
        mate_key, x_key, mut_key = keys
        if draws is None:
            pop = _valid_mating_pool(mate_key, state.pop, self.pop_size)
            crossovered = self.crossover(x_key, pop)
            offspring = self.mutation(mut_key, crossovered, self.lb, self.ub)
        else:
            mating, sbx, pm = draws[:3]
            pop = _valid_mating_pool(None, state.pop, self.pop_size, mating)
            crossovered = self.crossover(None, pop, draws=sbx)
            offspring = self.mutation(None, crossovered, self.lb, self.ub, draws=pm)
        return torch.clamp(offspring, self.lb, self.ub)

    def _theta(self, state: State, gen: torch.Tensor) -> torch.Tensor:
        return (gen.to(self.dtype) / state.max_gen) ** state.alpha

    def step(self, state: State, evaluate: EvalFn) -> State:
        gen = state.gen + 1
        key, mate_key, x_key, mut_key = rng.split_keys(state.key, 4)
        state, draws = self._draws(state)
        offspring = self._offspring(state, (mate_key, x_key, mut_key), draws)
        off_fit = evaluate(offspring)
        merge_pop = torch.cat([state.pop, offspring], dim=0)
        merge_fit = torch.cat([state.fit, off_fit], dim=0)
        survivor, survivor_fit = self.selection(
            merge_pop, merge_fit, state.reference_vector, self._theta(state, gen)
        )
        # Adapt the vectors every round(1/fr) generations: both branches
        # are computed (r x m, negligible) and one is kept on the device.
        adapt = gen % _adapt_every(state.fr) == 0
        reference_vector = torch.where(
            adapt, _adapted(self.init_v, survivor_fit), state.reference_vector
        )
        return state.replace(
            key=key,
            gen=gen,
            pop=survivor,
            fit=survivor_fit,
            reference_vector=reference_vector,
        )
