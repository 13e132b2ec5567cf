"""HypE: hypervolume-estimation based many-objective optimization
(counterpart of ``evox_tpu/algorithms/mo/hype.py``).

A Monte-Carlo estimate of each individual's hypervolume contribution
(:func:`cal_hv`) drives both mating selection and survivor truncation.
The removal budget ``k`` of the truncation is a device value: its alpha
weights are computed on the device for every dominance count, so nothing
is read back and a generation can be captured in a CUDA graph.  Survivor
ranking runs the port's dominance and front-peel kernels on the card.

References:
    [1] J. Bader and E. Zitzler, "HypE: An algorithm for fast
        hypervolume-based many-objective optimization," Evol. Comput. 19(1),
        2011.
"""

from __future__ import annotations

from typing import Callable

import torch

from ... import resolve_device
from ...core import Algorithm, EvalFn, State
from ...operators.crossover import simulated_binary
from ...operators.mutation import polynomial_mutation
from ...operators.selection import non_dominate_rank, tournament_selection
from ...utils import lexsort, rng
from ..validation import validate_bounds

__all__ = ["HypE", "cal_hv"]


def cal_hv(
    seed,
    fit: torch.Tensor,
    ref: torch.Tensor,
    k: torch.Tensor,
    n_sample: int,
    samples_u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Monte-Carlo hypervolume contribution of each row of ``fit`` (n, m)
    for a removal budget of ``k`` individuals (a 0-dim tensor).

    :param seed: a port seed of the ``(n_sample, m)`` uniform draw; unused
        when ``samples_u`` is given.
    :param samples_u: those uniforms, supplied from outside.
    """
    n, m = fit.shape
    dtype, dev = fit.dtype, fit.device
    i = torch.arange(1, n, dtype=dtype, device=dev)
    ratios = torch.cat([torch.ones((1,), dtype=dtype, device=dev), (k - i) / (n - i)])
    alpha = torch.cumprod(ratios, dim=0) / torch.arange(1, n + 1, dtype=dtype, device=dev)
    alpha = torch.nan_to_num(alpha)

    f_min = torch.amin(fit, dim=0)
    if samples_u is None:
        samples_u = rng.uniform(seed, (n_sample, m), dtype, dev)
    samples = samples_u * (ref - f_min) + f_min

    # pds[s, i]: individual i weakly dominates sample s (one objective at
    # a time: no (n_sample, n, m) table).
    pds = fit[None, :, 0] <= samples[:, None, 0]
    for j in range(1, m):
        pds &= fit[None, :, j] <= samples[:, None, j]
    ds = torch.clamp(pds.sum(dim=1) - 1, min=0)  # co-dominators per sample

    # Each individual collects alpha[ds] over the samples it dominates.
    f = torch.where(pds, alpha[ds][:, None], 0.0).sum(dim=0)
    return f * torch.prod(ref - f_min) / n_sample


class HypE(Algorithm):
    """Tensorized HypE with Monte-Carlo hypervolume contributions."""

    def __init__(
        self,
        pop_size: int,
        n_objs: int,
        lb,
        ub,
        n_sample: int = 10000,
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
        :param n_sample: Monte-Carlo samples per hypervolume estimate.
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
        self.n_sample = n_sample
        self.selection = selection_op or tournament_selection
        self.mutation = mutation_op or polynomial_mutation
        self.crossover = crossover_op or simulated_binary

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
            ref=torch.ones((self.n_objs,), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        # The reference point at 1.2x the worst value, kept on the device.
        ref = (torch.amax(fit) * 1.2).expand(self.n_objs).clone()
        return state.replace(fit=fit, ref=ref)

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` makes them
        from the state's key.  A subclass may return ``(state, (hv1_u,
        parents, sbx_draws, pm_draws, hv2_u))`` to supply them — the
        (n_sample, m) uniforms of the mating hypervolume estimate, the
        tournament's (N, 2) candidate indices, SBX's and the mutation's raw
        draws (as :class:`~evox_tpu_torch.algorithms.mo.nsga2.NSGA2` takes
        them) and the (n_sample, m) uniforms of the survivors' hypervolume
        estimate; the parity tests inject the JAX package's draws this
        way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        key, hv1_key, sel_key, x_key, mut_key, hv2_key = rng.split_keys(state.key, 6)
        state, draws = self._draws(state)
        hv1_u, parents, sbx, pm, hv2_u = draws if draws is not None else (None,) * 5
        budget = torch.full((), float(self.pop_size), dtype=self.dtype, device=self.device)
        hv = cal_hv(rng.child(hv1_key), state.fit, state.ref, budget, self.n_sample, hv1_u)
        if draws is None:
            mating_pool = self.selection(sel_key, self.pop_size, -hv)
            crossovered = self.crossover(x_key, state.pop[mating_pool])
            offspring = self.mutation(mut_key, crossovered, self.lb, self.ub)
        else:
            mating_pool = self.selection(None, self.pop_size, -hv, parents=parents)
            crossovered = self.crossover(None, state.pop[mating_pool], draws=sbx)
            offspring = self.mutation(None, crossovered, self.lb, self.ub, draws=pm)
        offspring = torch.clamp(offspring, self.lb, self.ub)
        off_fit = evaluate(offspring)

        merge_pop = torch.cat([state.pop, offspring], dim=0)
        merge_fit = torch.cat([state.fit, off_fit], dim=0)

        # Selection only consumes ranks up to the boundary front.
        rank = non_dominate_rank(merge_fit, until_count=self.pop_size)
        worst_rank = torch.sort(rank).values[self.pop_size - 1]
        mask = rank <= worst_rank
        k = mask.sum().to(self.dtype) - self.pop_size
        hv = cal_hv(rng.child(hv2_key), merge_fit, state.ref, k, self.n_sample, hv2_u)
        dis = torch.where(mask, hv, float("-inf"))

        combined = lexsort([-dis, rank.to(dis.dtype)])[: self.pop_size]
        return state.replace(key=key, pop=merge_pop[combined], fit=merge_fit[combined])
