"""Shared helpers for PSO variants (counterpart of
``evox_tpu/algorithms/so/pso_variants/utils.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["min_by", "max_by"]


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
