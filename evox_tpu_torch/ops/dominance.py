"""Pareto dominance (counterpart of ``evox_tpu/ops/dominance.py``, and of
the bit-packed route ``_non_dominate_rank_packed`` of
``evox_tpu/operators/selection/non_dominate.py``).

* :func:`dominance_matrix` — the (n, n) bool matrix ``A[i, j] = f_i
  dominates f_j``;
* :func:`dominance_packed` — the same relation as (⌈n/32⌉, n) words, bit
  ``b`` of ``words[w, j]`` = row ``32w + b`` dominates ``j``; held in an
  int32 tensor (PyTorch's bit-exact 32-bit type), read as uint32;
* :func:`peel_count_plain` — ``Σ_w popcount(words[w, j] & front_mask[w])``
  for a (n,) bool front, or the dominate count with ``front=None``: the
  reference the front peel is built on (no kernel of its own);
* :func:`peel_fronts` — the non-domination rank of every column from the
  words: the whole front peel (the dominate count, then one popcount of
  each front over the words) in one cooperative kernel, with no host sync.

On a CUDA tensor each wrapper launches its kernel in ``csrc/dominance.cu``
(float32 or float64 objectives; any other dtype raises ``TypeError``); on a
CPU tensor it runs the plain version beside it.  There is no other path: a
cooperative launch the card refuses raises.  Each is an operator with the
sequential batching rule (:mod:`evox_tpu_torch.utils.vmap_ops`): under
``torch.func.vmap``, one launch an instance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = [
    "dominate_relation",
    "dominance_matrix",
    "dominance_matrix_plain",
    "dominance_packed",
    "dominance_packed_plain",
    "peel_count_plain",
    "peel_fronts",
    "peel_fronts_plain",
]

_DTYPES = {torch.float32: 0, torch.float64: 1}
_P = ctypes.c_void_p
_DOMINANCE_ARGS = (ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P, _P)
_FRONTS_ARGS = (_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)
# Dominator rows the plain version compares at a time; the kernels take
# n < 2^31 - _TILE rows.
_TILE = 256
# The peel's blocks have 1024 threads from this many word rows on, else
# 256: a front's word rows then need the loads in flight of a wide block,
# and a small peel is bound by its barriers, cheaper in small blocks.
_PEEL_WIDE_WORDS = 256


class PeelPlan(NamedTuple):
    """The front peel's launch: ``vec`` adjacent words a load, ``blocks``
    blocks of ``threads`` (all resident: one cooperative launch)."""

    vec: int
    blocks: int
    threads: int


def _peel_tiles(nw: int, blocks: int) -> list[tuple[int, int]]:
    """The 32-column tiles ``[t0, t1)`` each block of the peel owns: the
    ``nw`` tiles split evenly (sizes differ by at most one), as the kernel
    computes them (``b * nw // blocks``)."""
    return [(b * nw // blocks, (b + 1) * nw // blocks) for b in range(blocks)]


def _peel_plan(n: int, ptr: int, sms: int, blocks_per_sm) -> PeelPlan:
    """The launch of the front peel over n columns whose words start at
    address ``ptr``, on a card of ``sms`` SMs.  The load is the widest of 4,
    2, 1 words (16, 8, 4 bytes) that divides n (a load never crosses a word
    row) and to whose bytes ``ptr`` is aligned.  The grid is one block an
    SM, at most one a tile, of 1024 threads from ``_PEEL_WIDE_WORDS`` word
    rows on, else 256: resident at once if one block (with the shared
    memory of that grid) fits on an SM, ``blocks_per_sm(vec, blocks,
    threads)``; else it raises."""
    nw = _num_words(n)
    vec = next(v for v in (4, 2, 1) if n % v == 0 and ptr % (4 * v) == 0)
    blocks = min(nw, sms)
    threads = 1024 if nw >= _PEEL_WIDE_WORDS else 256
    if blocks_per_sm(vec, blocks, threads) < 1:
        raise RuntimeError(f"peel_fronts: no block of {blocks} fits on an SM for {n} columns")
    return PeelPlan(vec, blocks, threads)


@functools.cache
def _peel_blocks_per_sm(device_index: int, vec: int, nw: int, blocks: int, threads: int) -> int:
    fn = _build.entry("dominance", "peel_blocks_per_sm", (ctypes.c_int,) * 4)
    with torch.cuda.device(device_index):
        per_sm = fn(vec, nw, blocks, threads)
    if per_sm < 0:
        raise RuntimeError(f"peel_fronts: the card refused the occupancy query for {vec, nw, blocks, threads}")
    return per_sm


def _num_words(n: int) -> int:
    return -(-n // 32)


def dominate_relation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bool matrix ``A[i, j] = x_i dominates y_j`` (all objectives ``<=``,
    at least one ``<``) by the broadcast compare of
    ``non_dominate.py:32-37``."""
    le = torch.all(x[:, None, :] <= y[None, :, :], dim=-1)
    lt = torch.any(x[:, None, :] < y[None, :, :], dim=-1)
    return le & lt


def dominance_matrix_plain(f: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`dominance_matrix`."""
    return dominate_relation(f, f)


def _pack_bits(rows: torch.Tensor) -> torch.Tensor:
    """Pack a (32, ...) bool block into int32 words (bit b = row b),
    ``non_dominate.py:122-125``."""
    shift = torch.arange(32, dtype=torch.int64, device=rows.device)
    shift = shift.reshape((32,) + (1,) * (rows.ndim - 1))
    word = torch.sum(rows.to(torch.int64) << shift, dim=0)
    # The uint32 bits as int32 (two's complement).
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def dominance_packed_plain(f: torch.Tensor) -> torch.Tensor:
    """Packed words by the broadcast compare, 256 dominator rows at a time
    (the (n, n) bool matrix is never held whole).  Pad rows
    (index ≥ n) are all-+inf and dominate nothing."""
    n, m = f.shape
    nw = _num_words(n)
    fp = torch.cat([f, torch.full((nw * 32 - n, m), float("inf"), dtype=f.dtype, device=f.device)])
    words = []
    for r0 in range(0, nw * 32, _TILE):
        block = fp[r0 : r0 + _TILE]  # (32 * w, m)
        rel = dominate_relation(block, f)  # (32 * w, n)
        words.append(_pack_bits(rel.reshape(-1, 32, n).transpose(0, 1)))
    return torch.cat(words, dim=0) if words else torch.empty((0, n), dtype=torch.int32, device=f.device)


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR popcount on int64)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def peel_count_plain(words: torch.Tensor, front: torch.Tensor | None = None) -> torch.Tensor:
    """``count[j] = Σ_w popcount(words[w, j] & mask[w])``, int32; ``mask``
    packs ``front`` (all ones when ``front`` is None)."""
    nw, n = words.shape
    if front is None:
        masked = words
    else:
        pad = torch.zeros((nw * 32 - n,), dtype=torch.bool, device=front.device)
        mask = _pack_bits(torch.cat([front, pad]).reshape(nw, 32).T)  # (nw,)
        masked = words & mask[:, None]
    return torch.sum(_popcount32(masked), dim=0).to(torch.int32)


def peel_fronts_plain(words: torch.Tensor, until_count: int | None = None) -> torch.Tensor:
    """Non-domination rank (int32) of each of the n columns of ``words``:
    rank ``r`` for the r-th front peeled, the sentinel ``n`` for columns
    left unranked.  Peeling stops at an empty front, or before the next
    front once ``until_count`` columns are ranked (so the front crossing it
    is ranked whole), as ``_peel_fronts`` of the JAX package.  A loop on
    :func:`peel_count_plain` that reads each front's size back to the host."""
    n = words.shape[1]
    count = peel_count_plain(words)  # how many rows dominate each row
    rank = torch.full((n,), n, dtype=torch.int32, device=words.device)
    front = count == 0
    current, assigned = 0, 0
    while True:
        size = int(front.sum())
        if size == 0 or (until_count is not None and assigned >= until_count):
            break
        rank = torch.where(front, current, rank)
        assigned += size
        # Rows of the peeled front drop to -1 and never become a front again.
        count = count - peel_count_plain(words, front) - front.to(torch.int32)
        front = count == 0
        current += 1
    return rank


def _check_words(words: torch.Tensor, what: str) -> tuple[int, int]:
    if words.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {words.device}")
    if words.ndim != 2 or words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(f"{what}: words must be a contiguous (nw, n) int32 tensor")
    nw, n = words.shape
    if nw != _num_words(n):
        raise ValueError(f"{what}: {nw} words for {n} columns, expected {_num_words(n)}")
    return nw, n


def _check_f(f: torch.Tensor, what: str) -> None:
    if f.ndim != 2:
        raise ValueError(f"{what}: f must be (n, m), got {list(f.shape)}")
    if f.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {f.device}")
    if f.dtype not in _DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or float64, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError(f"{what}: f must be contiguous")
    # Too many objectives for a block's shared memory: the C entry point
    # refuses them, and the launch raises.
    n = f.shape[0]
    if n >= 2**31 - _TILE:
        raise ValueError(f"{what}: the kernel takes n < 2^31 - {_TILE} rows, got {n}")


def _dominance(f: torch.Tensor, packed: bool, what: str) -> torch.Tensor:
    _check_f(f, what)
    n, m = f.shape
    if packed:
        out = torch.empty((_num_words(n), n), dtype=torch.int32, device=f.device)
    else:
        out = torch.empty((n, n), dtype=torch.bool, device=f.device)
    fn = _build.entry("dominance", "dominance", _DOMINANCE_ARGS)
    _build.launch(what, fn, f.device, _DTYPES[f.dtype], int(packed), f.data_ptr(), n, m, out.data_ptr())
    return out


@register_vmap_op(name="dominance_matrix")
def _matrix_op(f: torch.Tensor) -> torch.Tensor:
    if f.device.type == "cpu":
        return dominance_matrix_plain(f)
    out = _dominance(f, packed=False, what="dominance_matrix")
    dominance_matrix.launches += 1
    return out


def dominance_matrix(f: torch.Tensor) -> torch.Tensor:
    """(n, n) bool matrix ``A[i, j] = f_i dominates f_j`` (all objectives
    ``<=``, at least one ``<``).  NaN rows dominate nothing and are
    dominated by nothing."""
    return _matrix_op(f)


@register_vmap_op(name="dominance_packed")
def _packed_op(f: torch.Tensor) -> torch.Tensor:
    if f.device.type == "cpu":
        return dominance_packed_plain(f)
    out = _dominance(f, packed=True, what="dominance_packed")
    dominance_packed.launches += 1
    return out


def dominance_packed(f: torch.Tensor) -> torch.Tensor:
    """The dominance relation as (⌈n/32⌉, n) int32 words (bit ``b`` of
    ``words[w, j]`` = row ``32w + b`` dominates ``j``): 1/8 of the bool
    matrix's bytes, the layout the front peel reads."""
    return _packed_op(f)


@register_vmap_op(name="peel_fronts")
def _peel_op(words: torch.Tensor, until: int) -> torch.Tensor:
    if words.device.type == "cpu":
        return peel_fronts_plain(words, None if until < 0 else until)
    what = "peel_fronts"
    nw, n = _check_words(words, what)
    rank = torch.empty((n,), dtype=torch.int32, device=words.device)
    if n == 0:
        return rank
    scratch = _build.workspace("dominance", "peel_fronts_workspace", words.device, n, nw)
    index = words.device.index if words.device.index is not None else torch.cuda.current_device()
    plan = _peel_plan(n, words.data_ptr(), _build.sm_count(index),
                      lambda vec, blocks, threads: _peel_blocks_per_sm(index, vec, nw, blocks, threads))
    fn = _build.entry("dominance", "peel_fronts", _FRONTS_ARGS)
    _build.launch(what, fn, words.device, words.data_ptr(), n, nw, until, rank.data_ptr(), scratch.data_ptr(),
                  plan.vec, plan.blocks, plan.threads)
    peel_fronts.launches += 1
    return rank


def peel_fronts(words: torch.Tensor, until_count: int | None = None) -> torch.Tensor:
    """Non-domination rank (int32) of each column of the (⌈n/32⌉, n)
    ``words`` (bit ``b`` of ``words[w, j]`` = row ``32w + b`` dominates
    ``j``): rank ``r`` for the r-th front, the sentinel ``n`` for columns
    left unranked once ``until_count`` columns are ranked (always after a
    whole front).  Equal to :func:`peel_fronts_plain`; on the card one
    cooperative kernel launch that reads nothing back to the host."""
    # The kernel stops once ``assigned >= until``; any count above n never
    # stops it, and a negative one stops it at once, as 0 does.  -1 is no
    # limit.
    n = words.shape[-1]
    until = -1 if until_count is None else min(max(int(until_count), 0), n + 1)
    return _peel_op(words, until)


# Launches of each CUDA kernel (never bumped by the CPU path); reset to 0 to
# count the launches of one run.
dominance_matrix.launches = 0
dominance_packed.launches = 0
peel_fronts.launches = 0
