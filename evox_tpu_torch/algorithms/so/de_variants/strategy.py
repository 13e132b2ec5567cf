"""Shared machinery of the strategy-coded DE variants (SaDE, CoDE, SHADE;
counterpart of ``evox_tpu/algorithms/so/de_variants/strategy.py``).

A strategy is the 4-code ``[base_vec_prim, base_vec_sec, diff_num,
cross_strategy]`` with ``base_vec: 0=rand, 1=best, 2=pbest, 3=current`` and
``cross_strategy: 0=bin, 1=exp, 2=arith``.  :func:`composite_trial` builds
one trial vector per individual under codes that are Python ints (the same
for every individual) or (n,) tensors (one per individual), by fixed-shape
selects, so a population with mixed strategies is one pass of tensor
operations.
"""

from __future__ import annotations

import torch

from ....operators.crossover import (
    DE_arithmetic_recombination,
    DE_binary_crossover,
    DE_differential_sum,
    DE_exponential_crossover,
)
from ....operators.selection import select_rand_pbest
from ....utils import rng

__all__ = [
    "RAND_1_BIN",
    "RAND_2_BIN",
    "RAND2BEST_2_BIN",
    "CURRENT2RAND_1",
    "CURRENT2PBEST_1_BIN",
    "TRIAL_SEEDS",
    "composite_trial",
]

# [base_vec_prim, base_vec_sec, diff_num, cross_strategy]
RAND_1_BIN = (0, 0, 1, 0)
RAND_2_BIN = (0, 0, 2, 0)
RAND2BEST_2_BIN = (0, 1, 2, 0)
CURRENT2RAND_1 = (0, 0, 1, 2)  # current2rand/1 == rand/1/arith
CURRENT2PBEST_1_BIN = (3, 2, 1, 0)

# Seeds one composite_trial call draws from: seed .. seed + 3 (the
# difference table, the p-best pick, the binary and the exponential
# crossover).
TRIAL_SEEDS = 4


def _pick(vtype, candidates: list[torch.Tensor]) -> torch.Tensor:
    """Per-individual base vector: ``candidates`` are [rand, best, pbest,
    current] (n, d); ``vtype`` an int (one candidate for all) or an (n,)
    tensor of codes."""
    if isinstance(vtype, int):
        return candidates[vtype]
    n = candidates[0].shape[0]
    merged = torch.stack(candidates)
    vtype = vtype.expand(n) if vtype.ndim == 0 else vtype
    return merged[vtype, torch.arange(n, device=merged.device)]


def _column(v):
    return v.reshape(-1, 1) if isinstance(v, torch.Tensor) else v


def composite_trial(
    seed,
    pop: torch.Tensor,
    fit: torch.Tensor,
    best_index: torch.Tensor,
    prim_type,
    sec_type,
    num_diff_vectors,
    cross_strategy,
    differential_weight,
    cross_probability,
    diff_padding_num: int,
    static_base_types: tuple[int, ...] | None = None,
    draws: tuple | None = None,
) -> torch.Tensor:
    """One trial vector per individual under (possibly per-individual)
    strategy codes: the core of the SaDE, CoDE and SHADE steps.

    :param seed: a :class:`~evox_tpu_torch.utils.rng.Seed` or key tensor;
        the call draws from ``seed`` .. ``seed + 3`` (:data:`TRIAL_SEEDS`).
    :param best_index: 0-dim index of the best individual (on the device).
    :param static_base_types: the base-vector codes when known at
        construction; candidate bases outside them (the p-best argsort, the
        best row) are neither drawn nor computed, as in the JAX package.
    :param draws: ``(diff, pbest, binary, exponential)``: the difference
        index table, the p-best positions, and the two crossovers' draws in
        the forms their operators take (an entry may be None where it is
        not used).  A crossover code given as an int computes that
        crossover alone; a tensor of codes computes all three and selects
        per row, as the JAX package does.
    """
    n, d = pop.shape
    diff_draws, pbest_draws, bin_draws, exp_draws = draws if draws is not None else (None,) * 4
    difference_sum, rand_vec_idx = DE_differential_sum(
        rng.as_seed(seed, 0), diff_padding_num, num_diff_vectors,
        torch.arange(n, device=pop.device), pop, draws=diff_draws,
    )
    needed = set(static_base_types) if static_base_types is not None else {0, 1, 2, 3}
    rand_vec = pop[rand_vec_idx] if 0 in needed else pop
    best_vec = pop.index_select(0, best_index.reshape(1)).expand(n, d) if 1 in needed else pop
    pbest_vec = (
        select_rand_pbest(rng.as_seed(seed, 1), 0.05, pop, fit, draws=pbest_draws) if 2 in needed else pop
    )
    candidates = [rand_vec, best_vec, pbest_vec, pop]
    base_prim = _pick(prim_type, candidates)
    base_sec = _pick(sec_type, candidates)

    F = _column(differential_weight)
    base = base_prim + F * (base_sec - base_prim)
    mutation = base + difference_sum * F

    CR = cross_probability

    def binary():
        return DE_binary_crossover(rng.as_seed(seed, 2), mutation, pop, CR, draws=bin_draws)

    def exponential():
        return DE_exponential_crossover(rng.as_seed(seed, 3), mutation, pop, CR, draws=exp_draws)

    def arithmetic():
        return DE_arithmetic_recombination(mutation, pop, CR)

    if isinstance(cross_strategy, int):
        return (binary, exponential, arithmetic)[cross_strategy]()
    cs = cross_strategy.expand(n) if cross_strategy.ndim == 0 else cross_strategy
    cs = cs[:, None]
    return torch.where(cs == 0, binary(), torch.where(cs == 1, exponential(), arithmetic()))
