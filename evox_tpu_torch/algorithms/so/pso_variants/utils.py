"""Shared helpers for PSO variants (counterpart of
``evox_tpu/algorithms/so/pso_variants/utils.py``), and the swarm set-up
they share."""

from __future__ import annotations

from typing import Sequence

import torch

from ....utils import rng

__all__ = ["min_by", "max_by", "random_select_from_mask", "init_swarm"]


def _select_by(
    values: Sequence[torch.Tensor], keys: Sequence[torch.Tensor], pick
) -> tuple[torch.Tensor, torch.Tensor]:
    keys_cat = torch.cat([torch.atleast_1d(k) for k in keys])
    idx = pick(keys_cat).reshape(1)
    # The values are never concatenated: at pop=100k, dim=1000 a
    # concatenation would copy 400 MB per call.  Instead each candidate
    # tensor gives up one row (index clamped into its range) and the row
    # whose range holds ``idx`` is selected — all on the device, no sync.
    best = None
    offset = 0
    for v in values:
        v = torch.atleast_2d(v)
        n = v.shape[0]
        row = v.index_select(0, (idx - offset).clamp(0, n - 1))[0]
        best = row if best is None else torch.where(idx >= offset, row, best)
        offset += n
    return best, keys_cat.index_select(0, idx)[0]


def min_by(
    values: Sequence[torch.Tensor], keys: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The value/key at the overall minimum of ``keys`` over a list of
    candidate tensors (first occurrence on ties)."""
    return _select_by(values, keys, torch.argmin)


def max_by(
    values: Sequence[torch.Tensor], keys: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The value/key at the overall maximum of ``keys`` (first occurrence on
    ties)."""
    return _select_by(values, keys, torch.argmax)


def random_select_from_mask(seed, mask: torch.Tensor, gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """For each row of the boolean ``mask``, one True column chosen
    uniformly at random (int64); a row with no True entry gives 0.  The
    Gumbel-max over the mask, as the JAX package builds it: the first
    index of the largest ``where(mask, g, -inf)`` for standard Gumbel
    values ``g`` of ``mask``'s shape, made from one Philox uniform draw
    (:func:`~evox_tpu_torch.utils.rng.gumbel_from_uniform`), or ``gumbel``
    when given (the tests share JAX's)."""
    if gumbel is None:
        u = rng.uniform(seed, mask.shape, torch.float32, mask.device)
        gumbel = rng.gumbel_from_uniform(u)
    scores = torch.where(mask, gumbel, float("-inf"))
    return torch.argmax(scores, dim=-1)


def init_swarm(key, pop_size: int, lb, ub, mean=None, stdev=None, normal_velocity: bool = False):
    """``(key, pop, velocity)`` of a new swarm in the dtype and on the
    device of ``lb``, as the JAX variants make it from ``split(key, 3)``:
    positions uniform in ``[lb, ub]`` (or, given ``mean`` and ``stdev``,
    ``mean + stdev * N(0, 1)`` clipped to the box) and velocities
    ``(2 U - 1) (ub - lb)`` (or ``stdev * N(0, 1)`` with
    ``normal_velocity``).  One draw launch each."""
    key, (pop_seed, v_seed) = rng.split(key.to(lb.device), 2)
    shape = (pop_size, lb.shape[0])
    dtype, device = lb.dtype, lb.device
    length = ub - lb
    if mean is not None and stdev is not None:
        pop = torch.clamp(mean + stdev * rng.normal(pop_seed, shape, dtype, device), lb, ub)
    else:
        pop = rng.uniform(pop_seed, shape, dtype, device) * length + lb
    if normal_velocity and mean is not None and stdev is not None:
        velocity = stdev * rng.normal(v_seed, shape, dtype, device)
    else:
        velocity = (rng.uniform(v_seed, shape, dtype, device) * 2 - 1) * length
    return key, pop, velocity
