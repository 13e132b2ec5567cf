"""RVEAa: RVEA with the reference-vector regeneration strategy (counterpart
of ``evox_tpu/algorithms/mo/rveaa.py``).

Doubles the reference-vector set with a randomly regenerated half that
re-targets sparse objective regions each generation, and truncates the
most angularly crowded half of the population at the final generation.
Both of the JAX package's ``lax.cond`` branches (the adaptation and the
truncation) are computed every generation and one result is kept with
``torch.where``, so no host reads a device predicate and a generation can
be captured in a CUDA graph.  The truncation's crowding key needs no (r, r)
sort: the first entry of each row of ``sort(-cosine)`` is ``-nanmax`` of
the row (NaN sorts last), and ``-inf`` for a row that is all NaN.

References:
    [1] R. Cheng et al., "A reference vector guided evolutionary algorithm
        for many-objective optimization," IEEE TEVC 20(5), 2016.
"""

from __future__ import annotations

import torch

from ...core import EvalFn, State
from ...operators.selection import non_dominate_rank
from ...operators.selection.rvea_selection import _cosine_similarity as _cosine
from ...utils import nanmax, nanmin, rng
from .rvea import RVEA, _adapt_every, _adapted

__all__ = ["RVEAa"]


def _nan_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=t.dtype, device=t.device)


class RVEAa(RVEA):
    """RVEA with adaptive reference-vector regeneration for irregular
    Pareto fronts.  The working set holds ``2 * pop_size`` reference
    vectors (fixed and regenerated halves) and as many population slots.

    :meth:`_draws` may also supply a fourth draw, the (pop_size, m)
    uniforms of the regeneration."""

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed, v_seed) = rng.split(key.to(self.device), 2)
        p, d, m = self.pop_size, self.dim, self.n_objs
        pop = rng.uniform(init_seed, (p, d), self.dtype, self.device) * (self.ub - self.lb) + self.lb
        # Fixed Das-Dennis half + random regenerated half.
        v1 = rng.uniform(v_seed, (p, m), self.dtype, self.device)
        nan = _nan_like(pop)
        return State(
            key=key,
            **self._params(),
            # The initial second half of the slots is empty (NaN), filled
            # by selection.
            pop=torch.cat([pop, nan.expand(p, d)]),
            fit=torch.full((2 * p, m), float("nan"), dtype=self.dtype, device=self.device),
            reference_vector=torch.cat([self.init_v, v1], dim=0),
            gen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop[: self.pop_size])
        return state.replace(fit=torch.cat([fit, _nan_like(fit).expand(self.pop_size, self.n_objs)]))

    def _rv_regeneration(
        self, seed, pop_obj: torch.Tensor, v: torch.Tensor, rand_u: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Re-seed the reference vectors that attract no solution towards
        random points scaled by the current objective ranges.

        :param rand_u: the (r, m) uniforms to use instead of drawing them
            from ``seed``."""
        nv = v.shape[0]
        obj = pop_obj - nanmin(pop_obj, dim=0)
        cosine = _cosine(obj, v)
        masked = torch.where(torch.isnan(cosine), float("-inf"), cosine)
        associate = torch.argmax(masked, dim=1)
        # Rows with no finite cosine associate with no vector (slot nv).
        associate = torch.where(masked[:, 0] == float("-inf"), nv, associate)
        counts = torch.zeros((nv + 1,), dtype=torch.int64, device=v.device)
        counts = counts.index_add(0, associate, torch.ones_like(associate))[:nv]
        if rand_u is None:
            rand_u = rng.uniform(seed, tuple(v.shape), v.dtype, v.device)
        rand = rand_u * nanmax(pop_obj, dim=0)
        return torch.where((counts == 0)[:, None], rand, v)

    def _batch_truncation(
        self, pop: torch.Tensor, obj: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Final-generation crowding truncation: NaN out the half of the
        population that is most angularly crowded.  Empty (NaN) rows get
        the key ``-inf`` and are dropped first."""
        n = pop.shape[0] // 2
        cosine = _cosine(obj, obj)
        not_all_nan = ~torch.isnan(cosine).all(dim=1)
        eye = torch.eye(cosine.shape[0], dtype=torch.bool, device=cosine.device)
        cosine = torch.where(eye & not_all_nan[:, None], 0.0, cosine)
        # Similarity to the nearest neighbour: sort(-cosine)[:, 0].
        nearest = -nanmax(cosine, dim=1)
        nearest = torch.where(torch.isnan(nearest), float("-inf"), nearest)
        order = torch.argsort(nearest, stable=True)
        keep = torch.ones((pop.shape[0],), dtype=torch.bool, device=pop.device)
        keep = keep.scatter(0, order[:n], False)[:, None]
        return torch.where(keep, pop, _nan_like(pop)), torch.where(keep, obj, _nan_like(obj))

    def step(self, state: State, evaluate: EvalFn) -> State:
        gen = state.gen + 1
        key, mate_key, x_key, mut_key, regen_key = rng.split_keys(state.key, 5)
        state, draws = self._draws(state)
        offspring = self._offspring(state, (mate_key, x_key, mut_key), draws)
        off_fit = evaluate(offspring)
        merge_pop = torch.cat([state.pop, offspring], dim=0)
        merge_fit = torch.cat([state.fit, off_fit], dim=0)

        # Keep only the global Pareto front (NaN elsewhere); NaN rows are
        # ranked as +inf rows and masked out.  Only the first front is
        # consumed: the peel stops after it.
        nan_row = torch.isnan(merge_fit).any(dim=1)
        rank = non_dominate_rank(
            torch.where(nan_row[:, None], float("inf"), merge_fit), until_count=1
        )
        front = ((rank == 0) & ~nan_row)[:, None]
        merge_fit = torch.where(front, merge_fit, _nan_like(merge_fit))
        merge_pop = torch.where(front, merge_pop, _nan_like(merge_pop))

        survivor, survivor_fit = self.selection(
            merge_pop, merge_fit, state.reference_vector, self._theta(state, gen)
        )
        p = self.pop_size
        rand_u = None if draws is None or len(draws) < 4 else draws[3]
        v_regen = self._rv_regeneration(
            rng.child(regen_key), survivor_fit, state.reference_vector[p:], rand_u
        )
        adapt = gen % _adapt_every(state.fr) == 0
        v_adapt = torch.where(adapt, _adapted(self.init_v, survivor_fit), state.reference_vector[:p])
        last = (gen == state.max_gen.to(torch.int32))
        trunc_pop, trunc_fit = self._batch_truncation(survivor, survivor_fit)
        return state.replace(
            key=key,
            gen=gen,
            pop=torch.where(last, trunc_pop, survivor),
            fit=torch.where(last, trunc_fit, survivor_fit),
            reference_vector=torch.cat([v_adapt, v_regen], dim=0),
        )
