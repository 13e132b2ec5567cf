"""Exact lexicographic rank by a stable sort, and the masked top-k built on it
(counterpart of ``evox_tpu/ops/topk.py``).

:func:`lex_rank` gives each element its position under the strict
``(value, index)`` order of a stable ascending sort (NaN after +inf, ties
by index): a permutation of ``0..n-1``.  :func:`masked_top_k` selects the
``k`` smallest elements by scattering ``out[rank] = i`` for ``rank < k``.

On a CUDA tensor :func:`lex_rank` launches the stable radix sort of
``csrc/topk.cu`` (float32 or int32; other dtypes raise ``TypeError``): two
launches up to :func:`radix_capacity` elements, the multi-block route
beyond, no host sync either way.  On a CPU tensor it runs
:func:`lex_rank_plain`.  There is no other path.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = [
    "lex_rank",
    "lex_rank_plain",
    "masked_top_k",
    "masked_top_k_plain",
    "radix_capacity",
]

# Names of the JAX module that have another form here: reaching one raises
# ImportError naming the port's stand-in.
_STAND_INS = {
    "masked_top_k_xla": "the stable-argsort top-k is the plain version, masked_top_k_plain",
}


def __getattr__(name: str):
    if name in _STAND_INS:
        raise ImportError(f"evox_tpu_torch.ops.topk has no {name}: {_STAND_INS[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_DTYPES = {torch.float32: 0, torch.int32: 1}
_P = ctypes.c_void_p
_ARGS = (ctypes.c_int, _P, ctypes.c_int, _P, _P, _P)
# The kernels index elements with 32-bit ints and pad to whole warps and
# tiles (csrc/radix_sort.cuh).
_LIMIT = 2**31 - 256


def radix_capacity() -> int:
    """The most elements (rows, for crowding) that the radix kernels of
    ``csrc/radix_sort.cuh`` sort in one thread-block cluster; larger inputs
    take the multi-block route.  Builds the kernel library."""
    return _build.entry("topk", "radix_block_capacity", ())()


def _big(dtype: torch.dtype) -> float | int:
    """The rank-last fill of masked elements: +inf for floats, the dtype's
    maximum for integers (the index tie-break keeps the order strict)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _masked(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values
    big = torch.full((), _big(values.dtype), dtype=values.dtype, device=values.device)
    return torch.where(mask, values, big)


def lex_rank_plain(values: torch.Tensor) -> torch.Tensor:
    """Stable argsort, then its inverse permutation (int32)."""
    (n,) = values.shape
    order = torch.argsort(values, stable=True)
    rank = torch.empty((n,), dtype=torch.int32, device=values.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=values.device)
    return rank


@register_vmap_op(name="lex_rank")
def _lex_rank_op(values: torch.Tensor) -> torch.Tensor:
    if values.device.type == "cpu":
        return lex_rank_plain(values)
    if values.device.type != "cuda":
        raise ValueError(f"lex_rank: no kernel for device {values.device}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"lex_rank: the CUDA kernel takes float32 or int32, got {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("lex_rank: values must be contiguous")
    (n,) = values.shape
    if n >= _LIMIT:
        raise ValueError(f"lex_rank: the kernel takes n < 2^31 - 256, got {n}")
    rank = torch.empty((n,), dtype=torch.int32, device=values.device)
    ws = _build.workspace("topk", "lex_rank_workspace", values.device, n)
    fn = _build.entry("topk", "lex_rank", _ARGS)
    _build.launch(
        "lex_rank", fn, values.device, _DTYPES[values.dtype], values.data_ptr(), n,
        rank.data_ptr(), _build.pointer(ws),
    )
    lex_rank.launches += 1
    return rank


def lex_rank(values: torch.Tensor) -> torch.Tensor:
    """Exact rank (int32) of every element under the strict lexicographic
    ``(value, index)`` order — the stable-sort position of each element.
    An operator with the sequential batching rule: under
    ``torch.func.vmap``, one launch an instance."""
    if values.ndim != 1:
        raise ValueError(f"lex_rank: values must be (n,), got {list(values.shape)}")
    return _lex_rank_op(values)


def masked_top_k_plain(
    values: torch.Tensor, k: int, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest ``(value, index)`` elements with masked elements
    excluded, by a stable argsort (``masked_top_k_xla``,
    ``topk.py:121-131``).  Returns ``(values_k, indices_k)``."""
    values = _masked(values, mask)
    order = torch.argsort(values, stable=True)[:k]
    return values[order], order


def masked_top_k(
    values: torch.Tensor, k: int, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k through :func:`lex_rank`: equal to
    :func:`masked_top_k_plain`, element for element.  Masked elements rank
    after every valid one and are selected only when fewer than ``k`` valid
    elements exist.  Returns ``(values_k, indices_k)`` (indices int64)."""
    (n,) = values.shape
    if not 0 < k <= n:
        raise ValueError(f"k must be in 1..{n}, got {k}")
    values = _masked(values, mask)
    rank = lex_rank(values)
    # The ranks are a permutation, so the k selected elements land in
    # distinct slots; every element ranked >= k goes to the spare slot k,
    # which is dropped.
    slot = torch.where(rank < k, rank, k).to(torch.int64)
    idx = torch.zeros((k + 1,), dtype=torch.int64, device=values.device).scatter(
        0, slot, torch.arange(n, dtype=torch.int64, device=values.device)
    )[:k]
    return values[idx], idx


# Launches of the CUDA kernel (never bumped by the CPU path); reset to 0 to
# count the launches of one run.
lex_rank.launches = 0
