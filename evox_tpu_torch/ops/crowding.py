"""Crowding distance by per-objective lexicographic neighbours (counterpart
of ``evox_tpu/ops/crowding.py``).

For each objective, a row's crowding gap is ``(above - below) / range``,
where ``below``/``above`` are the values of its predecessor and successor
among the valid rows in a stable ascending sort of that objective (NaN
last, ties by index).  :func:`crowding_neighbors` finds them: on a CUDA
tensor with the per-objective stable radix sort and valid-row scans of
``csrc/crowding.cu`` (float32; other dtypes raise ``TypeError``; two launches
up to :func:`~evox_tpu_torch.ops.topk.radix_capacity` rows, no host sync),
on a CPU tensor with :func:`crowding_neighbors_plain`.
:func:`crowding_distance_kernel` builds the distance from them; it equals
:func:`crowding_distance_plain`, the sort-and-scatter formula, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import lexsort, nanmin
from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = [
    "crowding_neighbors",
    "crowding_neighbors_plain",
    "crowding_distance_kernel",
    "crowding_distance_plain",
    "order_key",
]

# Names of the JAX module that have another form here: reaching one raises
# ImportError naming the port's stand-in.
_STAND_INS = {
    "crowding_distance_pallas": "the crowding_neighbors kernel's distance is crowding_distance_kernel",
}


def __getattr__(name: str):
    if name in _STAND_INS:
        raise ImportError(f"evox_tpu_torch.ops.crowding has no {name}: {_STAND_INS[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_P = ctypes.c_void_p
_ARGS = (_P, _P, ctypes.c_int, ctypes.c_int) + (_P,) * 6
_LIMIT = 2**31 - 256  # as lex_rank's (csrc/radix_sort.cuh)


def order_key(values: torch.Tensor) -> torch.Tensor:
    """The 32-bit sort key of each float32 or int32 value that the radix
    kernels (``csrc/radix_sort.cuh``) use, as int64 in ``[0, 2^32)``: a
    stable ascending sort of the keys is a stable sort of the values.
    float32: NaN maps to the top key, -0.0 to +0.0's key, a negative value
    to its bits inverted, any other to its bits with the sign bit set;
    int32: the sign bit flipped."""
    u = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if values.dtype == torch.int32:
        return u ^ 2**31
    if values.dtype != torch.float32:
        raise TypeError(f"order_key takes float32 or int32, got {values.dtype}")
    u = torch.where((u & 0x7FFFFFFF) == 0, 0, u)
    key = torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)
    return torch.where(torch.isnan(values), 0xFFFFFFFF, key)


def _order_keys(costs: torch.Tensor) -> torch.Tensor:
    """int64 keys that order the (value, row) pairs of each column like a
    stable ascending sort: ``order_key(value) << 31 | row`` (the index in
    31 bits)."""
    row = torch.arange(costs.shape[0], dtype=torch.int64, device=costs.device)[:, None]
    return (order_key(costs) << 31) | row


def crowding_neighbors_plain(
    costs: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`crowding_neighbors`: each column's valid
    keys sorted once, each row's neighbours found by binary search."""
    if costs.dtype != torch.float32:
        raise TypeError(f"crowding_neighbors takes float32 costs, got {costs.dtype}")
    n, m = costs.shape
    keys = _order_keys(costs)  # (n, m)
    none = torch.iinfo(torch.int64).max
    valid_keys = torch.where(mask[:, None], keys, none)
    srt = torch.sort(valid_keys, dim=0).values.T.contiguous()  # (m, n)
    num_valid = mask.sum()
    q = keys.T.contiguous()  # (m, n)
    lo = torch.searchsorted(srt, q, right=False)  # valid keys below each row's
    hi = torch.searchsorted(srt, q, right=True)  # valid keys at or below
    has_below = lo > 0
    has_above = hi < num_valid
    # Row indices of the neighbours (row 0 where there is none).
    pred = torch.where(has_below, torch.gather(srt, 1, (lo - 1).clamp(min=0)) & (2**31 - 1), 0)
    succ = torch.where(has_above, torch.gather(srt, 1, hi.clamp(max=n - 1)) & (2**31 - 1), 0)
    cols = costs.T
    below = torch.where(has_below, torch.gather(cols, 1, pred), float("-inf")).T
    above = torch.where(has_above, torch.gather(cols, 1, succ), float("inf")).T
    return (
        below.contiguous(),
        above.contiguous(),
        has_below.T.to(torch.float32).contiguous(),
        has_above.T.to(torch.float32).contiguous(),
    )


@register_vmap_op(name="crowding_neighbors")
def _neighbors_op(costs: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if costs.device.type == "cpu":
        return crowding_neighbors_plain(costs, mask)
    what = "crowding_neighbors"
    if costs.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {costs.device}")
    if costs.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got {costs.dtype}")
    if mask.dtype != torch.bool or mask.device != costs.device:
        raise ValueError(f"{what}: mask must be a bool tensor on {costs.device}")
    if not costs.is_contiguous() or not mask.is_contiguous():
        raise ValueError(f"{what}: costs and mask must be contiguous")
    n, m = costs.shape
    if n >= _LIMIT:
        raise ValueError(f"{what}: the kernel takes n < 2^31 - 256, got {n}")
    dev = costs.device
    below, above, has_below, has_above = (
        torch.empty((n, m), dtype=torch.float32, device=dev) for _ in range(4)
    )
    ws = _build.workspace("crowding", "crowding_workspace", dev, n, m)
    fn = _build.entry("crowding", "crowding_neighbors", _ARGS)
    _build.launch(
        what, fn, dev, costs.data_ptr(), mask.data_ptr(), n, m, _build.pointer(ws),
        below.data_ptr(), above.data_ptr(), has_below.data_ptr(), has_above.data_ptr(),
    )
    crowding_neighbors.launches += 1
    return below, above, has_below, has_above


def crowding_neighbors(
    costs: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-objective lexicographic neighbour values of every row among the
    rows where ``mask`` holds: ``(below, above, has_below, has_above)``,
    each (n, m).  A NaN neighbour gives a NaN value; a real ±inf neighbour
    its value; a missing one -inf/+inf with its flag 0 (the flags, not the
    values, tell a missing neighbour from a ±inf one).  Masked-out rows get
    their neighbours among the valid rows too.  An operator with the
    sequential batching rule: under ``torch.func.vmap``, one launch an
    instance."""
    if costs.ndim != 2 or mask.shape != costs.shape[:1]:
        raise ValueError(
            f"crowding_neighbors: costs (n, m) and mask (n,), got "
            f"{list(costs.shape)} and {list(mask.shape)}"
        )
    return _neighbors_op(costs, mask)


def _row_sum(d: torch.Tensor) -> torch.Tensor:
    """Sum over the objectives in a fixed left-to-right order (both routes
    round the same way)."""
    out = d[:, 0]
    for k in range(1, d.shape[1]):
        out = out + d[:, k]
    return out


def crowding_distance_kernel(
    costs: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Crowding distance from :func:`crowding_neighbors` (counterpart of
    ``crowding_distance_pallas``): boundary rows ``inf``, masked-out rows
    ``-inf``; equal to :func:`crowding_distance_plain` bit for bit."""
    n, m = costs.shape
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=costs.device)
    below, above, has_below, has_above = crowding_neighbors(costs, mask)
    # The ends of the sorted valid column: the top end is NaN when any valid
    # value is NaN (amax propagates it), the bottom end the smallest non-NaN
    # value (nanmin; an all-NaN column gives NaN).
    neg_inf = torch.full((), float("-inf"), dtype=costs.dtype, device=costs.device)
    nan = torch.full((), float("nan"), dtype=costs.dtype, device=costs.device)
    mx = torch.amax(torch.where(mask[:, None], costs, neg_inf), dim=0)
    mn = nanmin(torch.where(mask[:, None], costs, nan), dim=0)
    rng = mx - mn
    boundary = (has_below <= 0.0) | (has_above <= 0.0)
    gaps = torch.where(boundary, -neg_inf, (above - below) / rng)
    gaps = torch.where(mask[:, None], gaps, neg_inf)
    return _row_sum(gaps)


def crowding_distance_plain(
    costs: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """NSGA-II crowding distance by the sort-and-scatter formula of
    ``non_dominate.py:268-302``: boundary rows ``inf``, masked-out rows
    ``-inf``.  No host sync (the valid count stays on the device)."""
    n, m = costs.shape
    dev = costs.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    num_valid = mask.sum()
    # Sort each objective column with invalid rows pushed to the end.
    inverted = (~mask)[:, None].to(costs.dtype).expand(n, m)
    order = lexsort([costs, inverted], dim=0)  # (n, m)
    sorted_costs = torch.gather(costs, 0, order)
    last = (num_valid - 1).remainder(n).reshape(1, 1).expand(1, m)
    rng = torch.gather(sorted_costs, 0, last)[0] - sorted_costs[0]
    distance = torch.zeros_like(costs)
    if n > 2:
        gaps = (sorted_costs[2:] - sorted_costs[:-2]) / rng
        distance.scatter_(0, order[1:-1], gaps)
    inf = torch.full((1, m), float("inf"), dtype=costs.dtype, device=dev)
    distance.scatter_(0, order[:1], inf)
    distance.scatter_(0, torch.gather(order, 0, last), inf)
    neg_inf = torch.full((), float("-inf"), dtype=costs.dtype, device=dev)
    distance = torch.where(mask[:, None], distance, neg_inf)
    return _row_sum(distance)


# Launches of the CUDA kernel (never bumped by the CPU path); reset to 0 to
# count the launches of one run.
crowding_neighbors.launches = 0
