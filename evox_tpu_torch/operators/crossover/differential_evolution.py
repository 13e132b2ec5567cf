"""Differential-evolution crossover family (counterpart of
``evox_tpu/operators/crossover/differential_evolution.py``): padded
difference-vector sums over replacement-sampled indices, and binary,
exponential and arithmetic recombination, all fixed-shape whole-population
tensor operations.

Each random operator makes its draws in ONE Philox launch from ``seed``
(a :class:`~evox_tpu_torch.utils.rng.Seed`, or a key tensor, which stands
for its child 0).  ``draws=`` supplies them from outside instead, in the
form each operator's docstring gives; the parity tests feed the JAX
package's draws this way.

As in the JAX package, the binary crossover's per-gene mask is a uniform
draw (the reference library draws a normal there), so ``CR`` is the
crossover probability.
"""

from __future__ import annotations

import torch

from ...ops.philox import philox_draws
from ...utils import rng

__all__ = [
    "DE_differential_sum",
    "DE_binary_crossover",
    "DE_exponential_crossover",
    "DE_arithmetic_recombination",
    "saturating_int32",
]

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def saturating_int32(v: torch.Tensor) -> torch.Tensor:
    """Float to int32 as XLA converts: truncation toward zero, +inf and
    values above the range to INT32_MAX, -inf and values below to
    INT32_MIN, NaN to 0 (a plain ``.to(torch.int32)`` leaves those
    undefined).  Returned as int64 holding the int32 values."""
    v = torch.nan_to_num(v, nan=0.0).clamp(-(2.0**31), 2.0**31)
    return v.to(torch.int64).clamp(_INT32_MIN, _INT32_MAX)


def DE_differential_sum(
    seed,
    diff_padding_num: int,
    num_diff_vectors,
    index: torch.Tensor,
    population: torch.Tensor,
    draws: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of ``num_diff_vectors`` random difference vectors per individual,
    over a fixed ``diff_padding_num``-wide index table, so the shape does
    not depend on the (possibly per-individual) number of pairs.

    :param num_diff_vectors: an int, or a (pop_size,) tensor of pair counts.
    :param index: (pop_size,) index of each individual (a drawn index equal
        to it becomes ``pop_size - 1``).
    :param draws: the (pop_size, diff_padding_num) int64 table of indices
        in ``[0, pop_size)``.
    :return: ``(difference_sum, first_rand_index)``.
    """
    n = population.shape[0]
    if draws is None:
        (draws,) = philox_draws(rng.as_seed(seed), n * diff_padding_num, [(0, n)], population.device)
        draws = draws.reshape(n, diff_padding_num)
    rand_indices = torch.where(draws == index[:, None], n - 1, draws)
    pop_permute = population[rand_indices]  # (n, pad, dim)
    # A scalar count broadcasts over the population, a vector is per row.
    select_len = _per_row(num_diff_vectors) * 2 + 1
    mask = torch.arange(diff_padding_num, device=population.device)[None, :] < select_len
    pop_padded = torch.where(mask[:, :, None], pop_permute, 0.0)
    diff_vectors = pop_padded[:, 1:]
    difference_sum = torch.sum(diff_vectors[:, 0::2], dim=1) - torch.sum(diff_vectors[:, 1::2], dim=1)
    return difference_sum, rand_indices[:, 0]


def _per_row(v):
    """A (pop_size,) tensor as a column; a scalar (tensor or number) as it
    is (a number never becomes a device tensor: no host copy)."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.ndim == 1 else v


def DE_binary_crossover(
    seed,
    mutation_vector: torch.Tensor,
    current_vector: torch.Tensor,
    CR,
    draws: tuple | None = None,
) -> torch.Tensor:
    """Binomial crossover: each gene comes from the mutant with probability
    ``CR`` (a scalar or a (pop_size,) vector); one random gene per row is
    always taken from the mutant.

    :param draws: ``(u, j)``: float32 uniforms of (pop_size, dim) for the
        mask, and each row's guaranteed mutant gene, int64 in ``[0, dim)``.
        Drawn in one launch: ``j`` is word 1 of each row's first element.
    """
    n, dim = mutation_vector.shape
    if draws is None:
        u, j = philox_draws(rng.as_seed(seed), n * dim, [torch.float32, (0, dim)], mutation_vector.device)
        draws = u.reshape(n, dim), j.reshape(n, dim)[:, 0]
    u, j = draws
    mask = u < _per_row(CR)
    jind = torch.arange(dim, device=u.device)[None, :] == j[:, None]
    return torch.where(mask | jind, mutation_vector, current_vector)


def DE_exponential_crossover(
    seed,
    mutation_vector: torch.Tensor,
    current_vector: torch.Tensor,
    CR,
    draws: tuple | None = None,
) -> torch.Tensor:
    """Exponential crossover: a contiguous (wrapping) segment of
    geometrically distributed length, starting at a random gene, comes from
    the mutant.  The length ``floor(log(u) / -log1p(CR))`` is converted to
    int32 as XLA converts (:func:`saturating_int32`): +inf at ``CR = 0``
    becomes INT32_MAX, NaN becomes 0.

    :param draws: ``(start, u)``: each row's first gene, int64 in ``[0,
        dim)``, and a float32 uniform for its segment length (one launch).
    """
    n, dim = mutation_vector.shape
    if draws is None:
        draws = philox_draws(rng.as_seed(seed), n, [(0, dim), torch.float32], mutation_vector.device)
    start, u = draws
    if not isinstance(CR, torch.Tensor):
        # A number: its float32 log1p, as the reference computes it, on the
        # host (no device tensor is made from it).
        CR = float(torch.log1p(torch.tensor(CR, dtype=torch.float32)))
        rate = -CR
    else:
        rate = -torch.log1p(CR)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    seg_len = saturating_int32(torch.floor(torch.log(u) / rate))
    length = torch.clamp(seg_len, max=dim) - 1
    cols = torch.arange(dim, device=u.device)
    base_mask = cols[None, :] < length[:, None]
    tiled = torch.cat([base_mask, base_mask], dim=1)
    mask = torch.take_along_dim(tiled, start[:, None] + cols[None, :], dim=1)
    return torch.where(mask, mutation_vector, current_vector)


def DE_arithmetic_recombination(
    mutation_vector: torch.Tensor, current_vector: torch.Tensor, K
) -> torch.Tensor:
    """Arithmetic recombination: ``x + K * (v - x)`` (``K`` a scalar or a
    (pop_size,) vector)."""
    return current_vector + _per_row(K) * (mutation_vector - current_vector)
