"""Small tensor helpers (counterpart of ``evox_tpu/utils/ops.py``): a
stable multi-key argsort, NaN-ignoring reductions and the JAX package's
``nanmedian`` (none of which PyTorch provides under its semantics), the
select-by-label ``switch``, ``clamp``/``maximum``/``minimum`` with
``jnp.clip``'s and ``jnp.maximum``'s semantics for tensor or number
bounds, and ``randint`` with tensor bounds."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "switch",
    "clamp",
    "clamp_int",
    "clamp_float",
    "clip",
    "maximum",
    "minimum",
    "maximum_float",
    "minimum_float",
    "maximum_int",
    "minimum_int",
    "randint",
    "lexsort",
    "nanmin",
    "nanmax",
    "nanmedian",
]


def _like(v, a: torch.Tensor) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=a.device)


def switch(label: torch.Tensor, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise select by label: ``out[i] = values[label[i]][i]``, the
    label clipped into ``0 .. len(values) - 1``."""
    stacked = torch.stack(list(values), dim=0)
    label = torch.clamp(label.to(torch.int64), 0, stacked.shape[0] - 1)
    return torch.take_along_dim(stacked, label[None, ...], dim=0)[0]


def clamp(a: torch.Tensor, lo, hi) -> torch.Tensor:
    """``a`` clamped into ``[lo, hi]`` elementwise, as ``jnp.clip``:
    ``minimum(maximum(a, lo), hi)`` (NaN propagates; ``hi`` wins where
    ``lo > hi``).  ``clamp_int``/``clamp_float``/``clip`` are aliases."""
    return torch.minimum(torch.maximum(a, _like(lo, a)), _like(hi, a))


clamp_int = clamp_float = clip = clamp


def maximum(a, b) -> torch.Tensor:
    """Elementwise maximum (``jnp.maximum``: NaN propagates; numbers and
    tensors mix); ``maximum_float``/``maximum_int`` are aliases."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=getattr(b, "device", None))
    return torch.maximum(a, _like(b, a))


def minimum(a, b) -> torch.Tensor:
    """Elementwise minimum (``jnp.minimum``); ``minimum_float``/
    ``minimum_int`` are aliases."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=getattr(b, "device", None))
    return torch.minimum(a, _like(b, a))


maximum_float = maximum_int = maximum
minimum_float = minimum_int = minimum


def randint(seed, shape: Sequence[int], low, high, device=None) -> torch.Tensor:
    """Uniform integers in ``[low, high)`` (int64) of ``shape`` with bounds
    that may be tensors on the device (broadcast against ``shape``), from
    one Philox draw of ``seed`` (a key or a :class:`~evox_tpu_torch.utils.
    rng.Seed`): ``low + (word31 * (high - low)) >> 31``
    (:func:`~evox_tpu_torch.utils.rng.randint_below`), so no host reads a
    bound.  Needs ``1 <= high - low <= 2^31``.  It runs on ``device``, else
    on the device of a tensor bound, else on the key's: a key on the card
    draws there with no host sync."""
    from .. import resolve_device
    from . import rng

    seed = rng.as_seed(seed)
    if device is None:
        given = next((b for b in (low, high) if isinstance(b, torch.Tensor)), seed.key)
        device = given.device
    device = resolve_device(device)

    def bound(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.int64)
        # Filled on the device: a host-to-device copy would wait for the card.
        return torch.full((), int(v), dtype=torch.int64, device=device)

    low, high = bound(low), bound(high)
    return low + rng.randint_below(seed, shape, high - low, device)


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
