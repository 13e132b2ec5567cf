"""NSGA-III: reference-point based many-objective optimization (counterpart
of ``evox_tpu/algorithms/mo/nsga3.py``).

Survivors are the fronts below the boundary front, then boundary-front
members niched against a shuffled Das-Dennis reference set.  The JAX
package fills the niches with a ``lax.while_loop`` whose trip count depends
on the data; a captured CUDA graph cannot hold one, so :func:`_niche_fill`
computes the loop's outcome in closed form (sorts, scatters and prefix
sums of fixed shape, no host sync), equal to the loop bit for bit.  The
intercepts' (m, m) solve is ``torch.linalg.solve_ex`` with
``check_errors=False``, which reads nothing back; a singular extreme matrix
gives non-finite intercepts and the max-fallback, as in JAX.

References:
    [1] K. Deb and H. Jain, "An Evolutionary Many-Objective Optimization
        Algorithm Using Reference-Point-Based Nondominated Sorting Approach,
        Part I," IEEE TEVC 18(4), 2014.
"""

from __future__ import annotations

from typing import Callable

import torch

from ... import resolve_device
from ...core import Algorithm, EvalFn, State
from ...operators.crossover import simulated_binary
from ...operators.mutation import polynomial_mutation
from ...operators.sampling import uniform_sampling
from ...operators.selection import non_dominate_rank, tournament_selection_multifit
from ...utils import rng
from ..validation import validate_bounds

__all__ = ["NSGA3"]


def _perpendicular_distance(fit: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Distance of each fitness point to the line through each reference
    point: ``|f| * sqrt(1 - cos^2)``; the (n, r) table is made by one
    matrix product and finished in place."""
    fit_mag = torch.clamp(torch.linalg.vector_norm(fit, dim=1, keepdim=True), min=1e-10)
    fit_n = fit / fit_mag
    ref_n = ref / torch.clamp(torch.linalg.vector_norm(ref, dim=1, keepdim=True), min=1e-10)
    cos = fit_n @ ref_n.T
    # 1 - c² as -(c²) + 1: the same rounding, without a second table.
    return cos.mul_(cos).neg_().add_(1.0).clamp_(min=1e-10).sqrt_().mul_(fit_mag)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0) - x


def _niche_fill(
    rank: torch.Tensor,
    worst_rank: torch.Tensor,
    group_id: torch.Tensor,
    group_dist: torch.Tensor,
    nv: int,
    pop_size: int,
) -> torch.Tensor:
    """The ranks after niching: rows selected from the boundary front
    ``worst_rank`` get ``worst_rank - 1``, so exactly ``pop_size`` rows
    rank below ``worst_rank``.

    Stage 1 gives each vector with no selected row and some boundary-front
    member its closest member (ties to the lowest row).  JAX's stage-2
    loop then repeatedly gives every vector at the least niche count its
    next member in row order; a vector's p-th remaining member is taken at
    the level ``rho + p`` (``rho``: its count after stage 1), and each pass
    takes all members of the current least level, which rises by at least
    one a pass.  So the loop takes every member below the level ``L*`` at
    which the count first reaches the places left, and at ``L*`` drops the
    surplus, lowest rows first.  When stage 1 alone fills the places, the
    loop never runs and the surplus is dropped from stage 1's picks."""
    n = rank.shape[0]
    dev = rank.device
    rows = torch.arange(n, device=dev)
    gid = group_id.to(torch.int64)

    def per_vector(mask: torch.Tensor) -> torch.Tensor:
        return torch.zeros((nv,), dtype=torch.int64, device=dev).index_add(0, gid, mask.to(torch.int64))

    sel_mask = rank < worst_rank
    last_mask = rank == worst_rank
    rho = per_vector(sel_mask)
    rho_last = per_vector(last_mask)
    rho = torch.where(rho_last == 0, n, rho)
    selected = sel_mask.sum()

    # Stage 1: the closest member of each vector with no selected row
    # (NaN distances first, as argmin takes them).
    stage1 = rho == 0
    seg = torch.where(last_mask, gid, nv)
    dist = torch.where(torch.isnan(group_dist), float("-inf"), group_dist)
    dmin = torch.full((nv + 1,), float("inf"), dtype=dist.dtype, device=dev)
    dmin = dmin.scatter_reduce(0, seg, dist, "amin")
    closest = torch.where(last_mask & (dist == dmin[seg]), rows, n)
    closest = torch.full((nv + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(0, seg, closest, "amin")
    pick1 = torch.where(stage1, closest[:nv], n)
    chosen1 = torch.zeros((n + 1,), dtype=torch.bool, device=dev).scatter(0, pick1, True)[:n]
    rho_last = rho_last - stage1.to(torch.int64)
    rho = torch.where(stage1, 1, rho)
    rho = torch.where(rho_last == 0, n, rho)
    selected = selected + stage1.sum()

    # Stage 2: each remaining member's level rho + p, p its place among
    # its vector's remaining members in row order.
    member = last_mask & ~chosen1
    mseg = torch.where(member, gid, nv)
    by_vector = torch.argsort(mseg, stable=True)
    counts = torch.zeros((nv + 1,), dtype=torch.int64, device=dev).index_add(0, mseg, torch.ones_like(mseg))
    place = torch.empty_like(rows).scatter(0, by_vector, rows - _exclusive_cumsum(counts)[mseg[by_vector]])
    rho_ext = torch.cat([rho, rho.new_full((1,), n)])
    level = torch.where(member & (place < torch.cat([rho_last, rho_last.new_zeros(1)])[mseg]),
                        rho_ext[mseg] + place, 4 * n)
    need = pop_size - selected
    cut = torch.sort(level).values.index_select(0, torch.clamp(need - 1, 0, n - 1).reshape(1))
    at_cut = level == cut
    surplus = (level <= cut).sum() - need
    chosen2 = (level < cut) | (at_cut & (_exclusive_cumsum(at_cut.to(torch.int64)) >= surplus))
    # Stage 1 overshoot: drop its lowest picks.
    keep1 = chosen1 & (_exclusive_cumsum(chosen1.to(torch.int64)) >= -need)
    chosen = torch.where(need > 0, chosen1 | chosen2, keep1)
    return torch.where(chosen, worst_rank - 1, rank)


class NSGA3(Algorithm):
    """Tensorized NSGA-III with fixed-shape niching."""

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
        :param lb: 1-D lower bounds. :param ub: 1-D upper bounds.
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
        self.ref = uniform_sampling(pop_size, n_objs)[0].to(dtype=dtype, device=self.device)

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
            rank=torch.zeros((self.pop_size,), dtype=torch.int32, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, rank=non_dominate_rank(fit))

    def _normalize(self, fit: torch.Tensor, cand_mask: torch.Tensor) -> torch.Tensor:
        """Hyperplane normalization over the candidate rows: ideal-point
        shift, extreme-point intercepts by an (m, m) solve, the max-fallback
        when the intercepts are not finite and positive."""
        m = self.n_objs
        eye = torch.eye(m, dtype=self.dtype, device=fit.device)
        cand = cand_mask[:, None]
        ideal = torch.amin(torch.where(cand, fit, float("inf")), dim=0)
        norm_fit = fit - ideal
        masked_norm = torch.where(cand, norm_fit, float("inf"))
        # Extreme point per axis: argmin of the axis-weighted Chebyshev norm.
        w = eye + 1e-6
        ex_idx = torch.argmin(torch.amax(masked_norm[None, :, :] / w[:, None, :], dim=-1), dim=1)
        extreme = norm_fit[ex_idx]
        ones = torch.ones((m,), dtype=self.dtype, device=fit.device)
        hyperplane, _ = torch.linalg.solve_ex(extreme + 1e-12 * eye, ones, check_errors=False)
        intercepts = 1.0 / hyperplane
        fallback = torch.amax(torch.where(cand, norm_fit, float("-inf")), dim=0)
        ok = torch.isfinite(intercepts).all() & (intercepts > 1e-10).all()
        intercepts = torch.where(ok, intercepts, fallback)
        return norm_fit / torch.clamp(intercepts[None, :], min=1e-10)

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` makes them
        from the state's key.  A subclass may return ``(state, (mating_pool,
        sbx_draws, pm_draws, shuffle, ref_perm))`` to supply them — the
        (N,) mating pool, SBX's and the mutation's raw draws (as
        :class:`~evox_tpu_torch.algorithms.mo.nsga2.NSGA2` takes them), the
        permutation of the merged rows and that of the reference points;
        the parity tests inject the JAX package's draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, sel_key, x_key, mut_key, shuf_key, ref_key = rng.split_keys(state.key, 6)
        state, draws = self._draws(state)
        if draws is None:
            mating_pool = self.selection(sel_key, self.pop_size, [state.rank.to(self.dtype)])
            crossovered = self.crossover(x_key, state.pop[mating_pool])
            offspring = self.mutation(mut_key, crossovered, self.lb, self.ub)
        else:
            mating_pool, sbx, pm = draws[:3]
            crossovered = self.crossover(None, state.pop[mating_pool], draws=sbx)
            offspring = self.mutation(None, crossovered, self.lb, self.ub, draws=pm)
        offspring = torch.clamp(offspring, self.lb, self.ub)
        off_fit = evaluate(offspring)
        merge_pop = torch.cat([state.pop, offspring], dim=0)
        merge_fit = torch.cat([state.fit, off_fit], dim=0)
        n, nv = merge_pop.shape[0], self.ref.shape[0]
        if draws is None:
            shuffle = rng.permutation(rng.child(shuf_key), n, merge_pop.device)
            ref_perm = rng.permutation(rng.child(ref_key), nv, merge_pop.device)
        else:
            shuffle, ref_perm = draws[3], draws[4]
        merge_pop = merge_pop[shuffle]
        merge_fit = merge_fit[shuffle]

        # Ranks are only consumed up to the boundary front: the peel stops
        # once pop_size + 1 rows are ranked (deeper rows get the sentinel n).
        rank = non_dominate_rank(merge_fit, until_count=self.pop_size + 1)
        # The rank of the (pop_size + 1)-th best row: fronts below it fit
        # whole, the front at it is niched.
        worst_rank = torch.sort(rank).values[self.pop_size]
        norm_fit = self._normalize(merge_fit, rank <= worst_rank)
        distances = _perpendicular_distance(norm_fit, self.ref[ref_perm])
        group_dist, group_id = torch.min(distances, dim=1)
        del distances
        rank = _niche_fill(rank, worst_rank, group_id, group_dist, nv, self.pop_size)
        order = torch.argsort((rank >= worst_rank).to(torch.int32), stable=True)[: self.pop_size]
        return state.replace(
            key=key,
            pop=merge_pop[order],
            fit=merge_fit[order],
            rank=rank[order],
        )
