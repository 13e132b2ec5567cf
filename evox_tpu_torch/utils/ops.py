"""Small tensor helpers (counterpart of ``evox_tpu/utils/ops.py``, the part
the multi-objective and DE paths need): a stable multi-key argsort and
NaN-ignoring reductions, none of which PyTorch provides under the JAX
package's semantics."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lexsort", "nanmin", "nanmax", "nanmedian"]


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


def nanmedian(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """NaN-ignoring median along ``dim`` as ``jnp.nanmedian`` computes it:
    the mean ``(lo + hi) * 0.5`` of the two middle values of the valid
    entries (the same value twice for an odd count), NaN for a slice with
    none.  ``torch.nanmedian`` returns the lower middle value instead."""
    s = torch.sort(a, dim=dim).values  # NaN last
    count = torch.sum(~torch.isnan(a), dim=dim, keepdim=True)
    lo = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.minimum(torch.div(count, 2, rounding_mode="floor"), count - 1), min=0)
    mid = (torch.take_along_dim(s, lo, dim=dim) + torch.take_along_dim(s, hi, dim=dim)) * 0.5
    return mid.squeeze(dim)
