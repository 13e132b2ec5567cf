"""Random streams of the port (replaces the JAX package's PRNG keys).

A key is a CPU ``int64`` tensor ``[seed, counter]``.  :func:`split` hands out
child seeds from a host-side integer hash (splitmix64 of the seed and the
counter) and returns the key with its counter advanced, so a key never
forces a device sync and is checkpointed like any other leaf.

Bulk draws come from Philox4x32-10 (Salmon et al., SC'11), counter-based:
element ``i`` of a draw keyed by a 64-bit seed uses the counter ``(i_lo,
i_hi, 0, 0)``.  :func:`philox4x32` is the plain-PyTorch version; the CUDA
kernel in ``csrc/pso_move.cu`` computes the same function, so a draw is the
same bits on the CPU and on the card.  Uniforms keep the JAX package's bit
choice (``ops/pso_step.py::_uniform_bits``): the 24 high bits for float32,
the 7 high bits for bfloat16, times 2^-m, so every value is exact in the
dtype and the upper bound 1 is strict.

:func:`philox_words` returns all four output words of each element, so an
operator that needs up to four draws of one shape makes one Philox
evaluation and takes one word per draw (:func:`uniform_bits`,
:func:`randint_bits`) instead of one evaluation per draw: in PyTorch ops
each evaluation is ~150 small launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import resolve_device

__all__ = [
    "key",
    "split",
    "split_keys",
    "philox4x32",
    "philox_words",
    "uniform_bits",
    "uniform",
    "randint_bits",
    "randint",
]

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# Philox4x32-10 constants (Random123's PHILOX_M4x32_* and PHILOX_W32_*).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _splitmix64(x: int) -> int:
    z = (x + _GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _signed(x: int) -> int:
    """A 64-bit unsigned value as the int64 that holds the same bits."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


def key(seed: int) -> torch.Tensor:
    """A fresh key ``[seed, 0]`` (CPU int64)."""
    return torch.tensor([_signed(int(seed)), 0], dtype=torch.int64)


def _unpack(k: torch.Tensor) -> tuple[int, int]:
    if k.dtype != torch.int64 or tuple(k.shape) != (2,) or k.device.type != "cpu":
        raise ValueError(
            f"a key is a CPU int64 tensor of shape (2,), got "
            f"{k.dtype}{list(k.shape)} on {k.device}"
        )
    seed, counter = k.tolist()
    return seed & _M64, counter


def split(k: torch.Tensor, num: int = 1) -> tuple[torch.Tensor, list[int]]:
    """Consume ``num`` child seeds (64-bit Python ints) from ``k``; returns
    the advanced key and the seeds."""
    seed, counter = _unpack(k)
    children = [
        _splitmix64(seed ^ _splitmix64(counter + i)) for i in range(num)
    ]
    return torch.tensor([_signed(seed), counter + num], dtype=torch.int64), children


def split_keys(k: torch.Tensor, num: int) -> list[torch.Tensor]:
    """``num`` independent child keys of ``k`` (the counterpart of
    ``jax.random.split(key, num)``)."""
    _, children = split(k, num)
    return [key(c) for c in children]


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product ``m * x`` for a 32-bit
    constant ``m`` and int64 ``x`` in [0, 2^32), without int64 overflow: the
    product is formed from two 48-bit partial products."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _M32


def philox4x32(
    counter: Sequence[torch.Tensor], seed: int
) -> list[torch.Tensor]:
    """Philox4x32-10 of four int64 tensors of 32-bit counter words under the
    64-bit ``seed`` (key words ``seed & 0xffffffff``, ``seed >> 32``);
    returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _mantissa_bits(dtype: torch.dtype) -> int:
    return 7 if dtype == torch.bfloat16 else 24


def uniform_bits(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Uniform [0, 1) of ``dtype`` from 32-bit words: the high m bits times
    2^-m (m = 7 for bfloat16, 24 otherwise)."""
    m = _mantissa_bits(dtype)
    return ((word >> (32 - m)).to(torch.float32) * (2.0**-m)).to(dtype)


def philox_words(
    seed: int, numel: int, device: torch.device | str
) -> list[torch.Tensor]:
    """The four Philox output words for element counters ``0..numel-1``."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    return philox4x32((idx & _M32, idx >> 32, zero, zero), seed)


def uniform(
    seed: int,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """U[0, 1) of ``shape`` from the first Philox word of each element — the
    same bits on every device (``None``: the CUDA card, as
    :func:`~evox_tpu_torch.resolve_device`)."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    word = philox_words(seed, numel, resolve_device(device))[0]
    return uniform_bits(word, dtype).reshape(shape)


def randint_bits(word: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """Integers in ``[low, high)`` from 32-bit words by multiply-shift
    (``low + (word * (high - low)) >> 32``), int64."""
    span = int(high) - int(low)
    if not 0 < span <= 1 << 31:
        raise ValueError(f"randint needs 0 < high - low <= 2^31, got [{low}, {high})")
    return int(low) + ((word * span) >> 32)


def randint(
    seed: int,
    shape: Sequence[int],
    low: int,
    high: int,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Uniform integers in ``[low, high)`` of ``shape`` (int64) from the
    first Philox word of each element — the same values on every device
    (``None``: the CUDA card, as :func:`~evox_tpu_torch.resolve_device`)."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    word = philox_words(seed, numel, resolve_device(device))[0]
    return randint_bits(word, low, high).reshape(shape)
