"""Philox draws (the port's own kernel; the JAX package draws with
``jax.random`` inside XLA programs and has no Pallas kernel for it).

:func:`philox_draws` makes up to four draws of ``numel`` elements from one
Philox4x32-10 evaluation per element, output ``k`` from word ``k``, each in
its final form: a U[0, 1) of a float dtype (:func:`~evox_tpu_torch.utils.
rng.uniform_bits`) or an int64 in ``[low, high)``
(:func:`~evox_tpu_torch.utils.rng.randint_bits`).  On the card it launches
``csrc/philox.cu``, which reads the key from device memory and derives the
child seed itself: one device operation a call, no host read of the key.
On the CPU it runs :func:`philox_draws_plain`, the same bits in int64
PyTorch operations.  There is no other path: a CUDA device reaches the
kernel or the call raises.

A seed is a :class:`~evox_tpu_torch.utils.rng.Seed` (child ``index`` of a
key tensor) or a plain integer, the 64-bit Philox key itself.

:func:`philox_draws_batched` draws B streams, one a key of a (B, 2) stack,
in one launch.  Both entry points call one ``torch.library`` operator (a
solo draw is a stack of one key) whose batching rule
(:mod:`evox_tpu_torch.utils.vmap_ops`) merges the keys of a
``torch.func.vmap`` into that stack.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Union

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = ["philox_draws", "philox_draws_plain", "philox_draws_batched", "philox_draws_batched_plain",
           "seed_operands"]

# A draw's kind: a float dtype (a uniform) or ``(low, high)`` (int64).
Kind = Union[torch.dtype, tuple]

_FLOAT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2, torch.float16: 3}
_INT_KIND = 4
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = (
    (_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _LL, ctypes.c_int)
    + (ctypes.c_int,) * 4 + (_LL,) * 8 + (_P,) * 4 + (ctypes.c_int,) * 4 + (_P,)
)
# The kernel's largest block (threads) and the elements a thread makes at
# once on its vector route (a vector, aligned in the flat (batch, numel)
# output).
_THREADS = 256
_VEC = 4
# A thread an element (no vector) where the whole draw fits in this many
# blocks an SM: a small draw is latency-bound, and one chain a thread ends
# sooner than four.
_SCALAR_BLOCKS = 3
# A grid of one vector a thread is taken where it needs at most this many
# waves of the resident blocks; its blocks hold at most _ONE_PASS_BLOCK
# threads.
_ONE_PASS_WAVES = 2
_ONE_PASS_BLOCK = 128


class LaunchPlan(NamedTuple):
    """The kernel's grid for one call: ``vec`` elements a thread,
    ``blocks`` blocks of ``threads`` a stream (grid row), each thread taking
    up to ``passes`` vectors a grid-stride apart, 64-bit indices when
    ``wide``."""

    vec: int
    threads: int
    blocks: int
    passes: int
    wide: bool


def _stream_vectors(batch: int, numel: int, vec: int = _VEC) -> int:
    """The most vectors of ``vec`` elements one stream's elements touch:
    stream ``b`` covers flat elements ``b * numel ..`` and the vectors are
    aligned in the flat output, so a stream that starts ``s`` elements into
    a vector touches ``ceil((s + numel) / vec)`` of them (``s`` is ``b *
    numel mod vec``, periodic in ``b``)."""
    if numel == 0:
        return 0
    return max(-(-((b * numel) % vec + numel) // vec) for b in range(min(batch, vec)))


def _launch_plan(batch: int, numel: int, sms: int, blocks_per_sm) -> LaunchPlan:
    """The launch of ``batch`` streams of ``numel`` draws on a card of
    ``sms`` SMs that holds ``blocks_per_sm(wide, vec)`` of the kernel's
    blocks of ``_THREADS``.  A thread makes one element where the whole draw
    fits in ``_SCALAR_BLOCKS`` blocks an SM, else a vector of ``_VEC``.
    Where a vector a thread fits in ``_ONE_PASS_WAVES`` waves of the
    resident blocks, one pass: blocks no wider than a stream's vectors, and
    narrower (down to a warp) until a stream's blocks reach every SM.  Else
    a stream takes its share of the resident blocks (at least one), and its
    vectors are cut into the fewest passes those blocks can make and then
    spread evenly over them: whole passes (the last one short by less than
    a block a pass), so no stream's tail makes a serial pass of a few
    threads.  Indices are 32-bit below 2^31 elements in all (every index
    the kernel forms is then below 2^31 + _VEC)."""
    wide = batch * numel >= 2**31
    vec = 1 if batch * numel <= _SCALAR_BLOCKS * sms * _THREADS else _VEC
    vectors = _stream_vectors(batch, numel, vec)
    if vectors == 0:
        return LaunchPlan(vec, _THREADS, 0, 0, wide)
    resident = sms * blocks_per_sm(wide, vec)
    if vectors * batch <= _ONE_PASS_WAVES * resident * _THREADS:
        threads = _one_pass_threads(vectors, batch, sms)
        return LaunchPlan(vec, threads, -(-vectors // threads), 1, wide)
    share = max(1, resident // batch)
    passes = -(-vectors // (share * _THREADS))
    threads = -(-vectors // passes)
    return LaunchPlan(vec, _THREADS, -(-threads // _THREADS), passes, wide)


def _one_pass_threads(vectors: int, batch: int, sms: int) -> int:
    """The block of a one-pass grid: at most ``_ONE_PASS_BLOCK`` threads,
    and narrower (down to a warp) until a stream's blocks reach every
    SM."""
    spread = -(-sms // batch)  # blocks a stream needs to reach every SM
    return max(32, min(_ONE_PASS_BLOCK, 32 * (vectors // (32 * spread))))


@functools.cache
def _blocks_per_sm(device_index: int, count: int, wide: bool, vec: int) -> int:
    """Blocks of the kernel for ``count`` outputs and ``vec`` elements a
    thread that an SM of the card holds."""
    fn = _build.entry("philox", "philox_blocks_per_sm", (ctypes.c_int,) * 3)
    with torch.cuda.device(device_index):
        blocks = fn(count, int(wide), vec)
    if blocks < 1:
        raise RuntimeError(f"philox_draws: no resident block for {count} outputs (wide={wide}, vec={vec})")
    return blocks


def _check_kinds(kinds: Sequence[Kind]) -> list:
    kinds = list(kinds)
    if not 1 <= len(kinds) <= 4:
        raise ValueError(f"philox_draws: 1 to 4 draws a call, got {len(kinds)}")
    for k in kinds:
        if isinstance(k, tuple):
            low, high = (int(v) for v in k)
            if not 0 < high - low <= 1 << 31:
                raise ValueError(f"randint needs 0 < high - low <= 2^31, got [{low}, {high})")
        elif k not in _FLOAT_KINDS:
            raise TypeError(f"philox_draws: no uniform draw of {k}")
    return kinds


def philox_draws_plain(seed, numel: int, kinds: Sequence[Kind], device) -> list[torch.Tensor]:
    """The kernel's draws in plain PyTorch: one
    :func:`~evox_tpu_torch.utils.rng.philox_words` evaluation, then each
    word in its final form (flat tensors of ``numel``)."""
    from ..utils import rng

    kinds = _check_kinds(kinds)
    words = rng.philox_words(seed, numel, device)
    return [
        rng.randint_bits(w, *k) if isinstance(k, tuple) else rng.uniform_bits(w, k)
        for w, k in zip(words, kinds)
    ]


def seed_operands(seed, device: torch.device) -> tuple[torch.Tensor, int, int]:
    """``(key, index, derive)`` for a kernel that reads its Philox key from
    the device: a :class:`~evox_tpu_torch.utils.rng.Seed` is its key
    tensor (moved to ``device`` if it lies elsewhere) and index, derived in
    the kernel; an integer seed becomes a key tensor whose first word is
    used as it is (``derive`` 0), copied from the host on every call (so
    it waits for the host, and a captured CUDA graph refuses it: the
    workflows draw from keys).  The caller keeps the key alive across the
    launch."""
    from ..utils import rng

    if isinstance(seed, rng.Seed):
        k = rng.check_key(seed.key)
        return k.to(device), int(seed.index), 1
    k = torch.tensor([rng.signed64(int(seed)), 0], dtype=torch.int64)
    return k.to(device), 0, 0


def _codes(kinds: list) -> tuple[list[int], list[int], list[int]]:
    """The kernel's ``(kind codes, lows, spans)`` of checked ``kinds``."""
    codes, lows, spans = [], [], []
    for k in kinds:
        if isinstance(k, tuple):
            low, high = (int(v) for v in k)
            codes.append(_INT_KIND)
            lows.append(low)
            spans.append(high - low)
        else:
            codes.append(_FLOAT_KINDS[k])
            lows.append(0)
            spans.append(1)
    return codes, lows, spans


def _kinds(codes, lows, spans) -> list:
    """The inverse of :func:`_codes`."""
    dtypes = {v: k for k, v in _FLOAT_KINDS.items()}
    return [(lo, lo + sp) if c == _INT_KIND else dtypes[c] for c, lo, sp in zip(codes, lows, spans)]


def _check_numel(numel: int) -> int:
    numel = int(numel)
    if not 0 <= numel < 2**62:
        raise ValueError(f"philox_draws: numel must be in [0, 2^62), got {numel}")
    return numel


def philox_draws_batched_plain(keys: torch.Tensor, index: int, numel: int, kinds: Sequence[Kind],
                               derive: int = 1) -> list[torch.Tensor]:
    """The batched kernel's draws in plain PyTorch: for each of the B keys
    of ``keys`` (B, 2), :func:`philox_draws_plain` of child ``index`` of
    that key (or of its seed word, ``derive`` 0), stacked into (B, numel)
    tensors."""
    from ..utils import rng

    rows = [
        philox_draws_plain(rng.Seed(k, index) if derive else int(k[0]) & (2**64 - 1), numel, kinds, keys.device)
        for k in keys.unbind(0)
    ]
    return [torch.stack(col) for col in zip(*rows)]


def _launch(keys: torch.Tensor, index: int, derive: int, numel: int, codes, lows, spans, solo: int):
    """One launch of ``csrc/philox.cu`` drawing one stream of ``numel``
    elements for each of the B keys of ``keys`` (B, 2); returns the (B,
    numel) outputs and counts the launch on the solo entry point's
    ``.launches`` (``solo``) or the batched one's."""
    device = keys.device
    if device.type != "cuda":
        raise ValueError(f"philox_draws: no kernel for device {device}")
    batch = keys.shape[0]
    if not 1 <= batch < 65536:
        raise ValueError(f"philox_draws: the kernel takes 1 to 65535 streams a launch, got {batch}")
    if batch * numel >= 2**62:
        raise ValueError(f"philox_draws: batch * numel must be < 2^62, got {batch} x {numel}")
    keys = keys.contiguous()
    dtypes = _kinds(codes, lows, spans)
    outs = [torch.empty((batch, numel), dtype=torch.int64 if isinstance(k, tuple) else k, device=device)
            for k in dtypes]
    if numel == 0:
        return outs  # nothing to draw: no launch
    pad = 4 - len(codes)
    ptrs = [t.data_ptr() for t in outs] + [None] * pad
    index_of = device.index if device.index is not None else torch.cuda.current_device()
    plan = _launch_plan(batch, numel, _build.sm_count(index_of),
                        lambda wide, vec: _blocks_per_sm(index_of, len(codes), wide, vec))
    fn = _build.entry("philox", "philox_draw", _ARGTYPES)
    _build.launch(
        "philox_draws", fn, device, keys.data_ptr(), batch, index, derive, numel, len(codes),
        *(list(codes) + [0] * pad), *(list(lows) + [0] * pad), *(list(spans) + [1] * pad), *ptrs,
        plan.vec, plan.threads, plan.blocks, int(plan.wide),
    )
    # A solo call is a launch of one stream; a vmap merges into a batch.
    (philox_draws if solo else philox_draws_batched).launches += 1
    return outs


def _merge_rule(info, in_dims, keys, index, derive, numel, codes, lows, spans, solo):
    # Only ``keys`` is a tensor, so it is batched here: the level's V
    # stacks of B keys become one (V * B, 2) stack (B is 1 for a vmap of
    # the solo entry point).
    k = keys.movedim(in_dims[0], 0)
    v, b = k.shape[:2]
    outs = _op(k.reshape(v * b, 2), index, derive, numel, codes, lows, spans, 0)
    return [o.reshape(v, b, numel) for o in outs], [0] * len(outs)


@register_vmap_op(vmap_fn=_merge_rule, name="philox_draws")
def _op(keys: torch.Tensor, index: int, derive: int, numel: int, codes: list[int],
        lows: list[int], spans: list[int], solo: int) -> list[torch.Tensor]:
    if keys.device.type == "cpu":
        return philox_draws_batched_plain(keys, index, numel, _kinds(codes, lows, spans), derive)
    return _launch(keys, index, derive, numel, codes, lows, spans, solo)


def philox_draws(seed, numel: int, kinds: Sequence[Kind], device) -> list[torch.Tensor]:
    """Up to four draws of ``numel`` elements from one Philox evaluation per
    element: ``kinds[k]`` is a float dtype (a uniform in [0, 1)) or ``(low,
    high)`` (int64 in ``[low, high)``), drawn from word ``k``.  Returns flat
    tensors on ``device``.  The call is the batched operator on one key;
    under ``torch.func.vmap`` over the seed's key its rule merges the
    instances' keys, and one launch draws every instance's stream, each
    what a solo call with that instance's key draws."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"philox_draws: no kernel for device {device}")
    codes, lows, spans = _codes(_check_kinds(kinds))
    key, index, derive = seed_operands(seed, device)
    return [o[0] for o in _op(key[None], index, derive, _check_numel(numel), codes, lows, spans, 1)]


def philox_draws_batched(keys: torch.Tensor, index: int, numel: int, kinds: Sequence[Kind],
                         derive: int = 1) -> list[torch.Tensor]:
    """The batched route: for each of the B keys of ``keys`` (B, 2) on the
    card, the draws of child ``index`` of that key (``derive`` 1) or of its
    seed word (``derive`` 0), as (B, numel) tensors, in one launch.  Row
    ``b`` equals ``philox_draws(Seed(keys[b], index), ...)`` bit for bit
    (the Philox counter is the element's index within its stream).  On a
    CPU tensor, :func:`philox_draws_batched_plain`."""
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"philox_draws_batched: keys must be (B, 2) int64, got {keys.dtype}{list(keys.shape)}")
    codes, lows, spans = _codes(_check_kinds(kinds))
    return _op(keys, int(index), int(derive), _check_numel(numel), codes, lows, spans, 0)


# Launches of the CUDA kernel by each entry point: a solo call, and a
# batched call or a vmap of either (never bumped by the CPU path); reset
# them to 0 to count the launches of one run.
philox_draws.launches = 0
philox_draws_batched.launches = 0
