"""Small tensor helpers (counterpart of ``evox_tpu/utils/ops.py``, the part
the multi-objective path needs): a stable multi-key argsort and NaN-ignoring
reductions, none of which PyTorch provides under the JAX package's
semantics."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lexsort", "nanmin", "nanmax"]


def lexsort(keys: Sequence[torch.Tensor] | torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable multi-key argsort along ``dim``; the last key is primary (the
    numpy/``jnp.lexsort`` convention).  A tensor ``keys`` is a stack of
    keys along its first axis.

    Chains stable argsorts from the least to the most significant key.
    ``torch.sort`` orders NaN after +inf and treats -0.0 and +0.0 as equal,
    as ``jnp.lexsort`` does, so the permutation is the same."""
    keys = list(keys.unbind(0)) if isinstance(keys, torch.Tensor) else list(keys)
    if not keys:
        raise ValueError("lexsort needs at least one key")
    order = torch.argsort(keys[0], dim=dim, stable=True)
    for k in keys[1:]:
        o = torch.argsort(torch.take_along_dim(k, order, dim=dim), dim=dim, stable=True)
        order = torch.take_along_dim(order, o, dim=dim)
    return order


def _nan_reduce(a: torch.Tensor, dim, keepdim: bool, fill: float, reduce) -> torch.Tensor:
    nan = torch.isnan(a)
    filled = torch.where(nan, torch.full((), fill, dtype=a.dtype, device=a.device), a)
    if dim is None:
        out, all_nan = reduce(filled), nan.all()
    else:
        out, all_nan = reduce(filled, dim=dim, keepdim=keepdim), nan.all(dim=dim, keepdim=keepdim)
    # An all-NaN slice gives NaN, as jnp.nanmin/nanmax do.
    return torch.where(all_nan, torch.full((), float("nan"), dtype=a.dtype, device=a.device), out)


def nanmin(a: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """NaN-ignoring minimum (= ``jnp.nanmin``)."""
    return _nan_reduce(a, dim, keepdim, float("inf"), torch.amin)


def nanmax(a: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """NaN-ignoring maximum (= ``jnp.nanmax``)."""
    return _nan_reduce(a, dim, keepdim, float("-inf"), torch.amax)
