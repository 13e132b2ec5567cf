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
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from . import _build

__all__ = ["philox_draws", "philox_draws_plain", "seed_operands"]

# A draw's kind: a float dtype (a uniform) or ``(low, high)`` (int64).
Kind = Union[torch.dtype, tuple]

_FLOAT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2, torch.float16: 3}
_INT_KIND = 4
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = (
    (_P, ctypes.c_int, ctypes.c_int, _LL, ctypes.c_int)
    + (ctypes.c_int,) * 4 + (_LL,) * 8 + (_P,) * 4 + (ctypes.c_int, _P)
)
# Resident blocks a SM for the grid-stride loop.
_BLOCKS_PER_SM = 8


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


def philox_draws(seed, numel: int, kinds: Sequence[Kind], device) -> list[torch.Tensor]:
    """Up to four draws of ``numel`` elements from one Philox evaluation per
    element: ``kinds[k]`` is a float dtype (a uniform in [0, 1)) or ``(low,
    high)`` (int64 in ``[low, high)``), drawn from word ``k``.  Returns flat
    tensors on ``device``."""
    device = torch.device(device)
    numel = int(numel)
    if device.type == "cpu":
        return philox_draws_plain(seed, numel, kinds, device)
    if device.type != "cuda":
        raise ValueError(f"philox_draws: no kernel for device {device}")
    kinds = _check_kinds(kinds)
    if not 0 <= numel < 2**62:
        raise ValueError(f"philox_draws: numel must be in [0, 2^62), got {numel}")
    key, index, derive = seed_operands(seed, device)
    outs, codes, lows, spans = [], [], [], []
    for k in kinds:
        if isinstance(k, tuple):
            low, high = (int(v) for v in k)
            outs.append(torch.empty((numel,), dtype=torch.int64, device=device))
            codes.append(_INT_KIND)
            lows.append(low)
            spans.append(high - low)
        else:
            outs.append(torch.empty((numel,), dtype=k, device=device))
            codes.append(_FLOAT_KINDS[k])
            lows.append(0)
            spans.append(1)
    pad = 4 - len(kinds)
    ptrs = [t.data_ptr() for t in outs] + [None] * pad
    blocks = _BLOCKS_PER_SM * _build.sm_count(device.index if device.index is not None else torch.cuda.current_device())
    fn = _build.entry("philox", "philox_draw", _ARGTYPES)
    _build.launch(
        "philox_draws", fn, device, key.data_ptr(), index, derive, numel, len(kinds),
        *(codes + [0] * pad), *(lows + [0] * pad), *(spans + [1] * pad), *ptrs, blocks,
    )
    philox_draws.launches += 1
    return outs


# Launches of the CUDA kernel (never bumped by the CPU path); reset it to 0
# to count the launches of one run.
philox_draws.launches = 0
