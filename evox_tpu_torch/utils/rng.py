"""Random streams of the port (replaces the JAX package's PRNG keys).

A key is an ``int64`` tensor ``[seed, counter]`` of shape (2,) on the device
of the state it belongs to.  :func:`split` returns the key with its counter
advanced, and ``num`` child seeds: :class:`Seed` ``(key, i)`` stands for
the 64-bit Philox key ``splitmix64(seed ^ splitmix64(counter + i))`` of
the key it was split from.  No host ever reads a key: on the card the draw
kernels (``csrc/philox.cu``, ``csrc/pso_move.cu``) read it from device
memory and derive the child themselves, and on the CPU it is derived in
int64 tensor operations.  So a key is checkpointed like any other leaf, and
a step captured in a CUDA graph draws anew on each replay from the key the
previous generation advanced.  :func:`split_keys` makes child keys
``[child, tag]`` on the device by the same hash in tensor operations.

Named streams: the top byte of the counter word is a stream tag, the
index of a key implementation name in :data:`IMPL_TAGS`
(``threefry2x32`` 0, ``rbg`` 1, ``unsafe_rbg`` 2; see
:mod:`evox_tpu_torch.precision.prng`).  Every key carries its tag into
the child seeds (the hash reads the whole counter word) and into the child
keys of :func:`split_keys`, so keys of different tags draw different
streams from one generator; tag 0 is the plain key ``[seed, counter]``.
PyTorch shifts int64 arithmetically, so every right shift is masked to the
logical one; sums and products wrap modulo 2^64, as the unsigned arithmetic
they stand for.

Bulk draws come from Philox4x32-10 (Salmon et al., SC'11), counter-based:
element ``i`` of a draw keyed by a 64-bit seed uses the counter ``(i_lo,
i_hi, 0, 0)``.  :func:`philox4x32` is the plain-PyTorch version;
``csrc/philox.cuh`` computes the same function on the card, so a draw is
the same bits on the CPU and on the card.  Uniforms keep the JAX package's
bit choice (``ops/pso_step.py::_uniform_bits``): the 24 high bits for
float32, the 7 high bits for bfloat16, times 2^-m, so every value is exact
in the dtype and the upper bound 1 is strict.

:func:`uniform`, :func:`normal`, :func:`categorical`, :func:`randint`,
:func:`randint_below` and :func:`permutation` make one draw through
:func:`~evox_tpu_torch.ops.philox.philox_draws`, which makes up to four
draws of one shape from one Philox evaluation (output ``k`` from word
``k``): an operator that needs several draws asks for all of them at once.
Normals and Gumbel-max categories are maps over those uniforms, built as
``jax.random.normal`` and ``jax.random.categorical`` build theirs
(:func:`normal_from_uniform`, :func:`gumbel_from_uniform`), so a test that
feeds both the same uniforms gets the same values up to the last bits of
``erfinv`` and ``log``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from .. import resolve_device

__all__ = [
    "Seed",
    "IMPL_TAGS",
    "key",
    "impl_tag",
    "fold_in",
    "split",
    "split_keys",
    "child",
    "child_seeds",
    "as_seed",
    "check_key",
    "seed_value",
    "signed64",
    "philox4x32",
    "philox_words",
    "uniform_bits",
    "uniform",
    "normal_from_uniform",
    "normal",
    "gumbel_from_uniform",
    "categorical",
    "randint_bits",
    "randint",
    "randint_below",
    "permutation",
]

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

# Philox4x32-10 constants (Random123's PHILOX_M4x32_* and PHILOX_W32_*).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def signed64(x: int) -> int:
    """A 64-bit unsigned value as the int64 that holds the same bits."""
    x &= _M64
    return x - (1 << 64) if x >= (1 << 63) else x


# splitmix64's constants as the int64 values with the same bits.
_GOLDEN = signed64(0x9E3779B97F4A7C15)
_MIX1 = signed64(0xBF58476D1CE4E5B9)
_MIX2 = signed64(0x94D049BB133111EB)


class Seed(NamedTuple):
    """Child ``index`` of the key tensor ``key``: the 64-bit Philox key
    ``splitmix64(seed ^ splitmix64(counter + index))``, derived where it is
    used (in the draw kernel on the card)."""

    key: torch.Tensor
    index: int


# The stream tag of each key implementation name: the top byte of a key's
# counter word.
IMPL_TAGS = {"threefry2x32": 0, "rbg": 1, "unsafe_rbg": 2}
_TAG_SHIFT = 56
_TAG_MASK = signed64(0xFF << _TAG_SHIFT)


def key(
    seed: int, device: torch.device | str | None = None, impl: str = "threefry2x32"
) -> torch.Tensor:
    """A fresh key ``[seed, tag << 56]`` of the stream family ``impl``
    (int64; ``[seed, 0]`` for the default; ``device=None`` is the CPU, as
    for ``torch.tensor``: a workflow makes its key on its algorithm's
    device)."""
    if impl not in IMPL_TAGS:
        raise ValueError(f"unknown key impl {impl!r}; expected one of {tuple(IMPL_TAGS)}")
    tag = signed64(IMPL_TAGS[impl] << _TAG_SHIFT)
    return torch.tensor([signed64(int(seed)), tag], dtype=torch.int64, device=device)


def check_key(k: torch.Tensor) -> torch.Tensor:
    """``k`` when it is a key (an int64 tensor of shape (2,)); raises
    :class:`ValueError` otherwise.  Reads no value."""
    if not isinstance(k, torch.Tensor) or k.dtype != torch.int64 or tuple(k.shape) != (2,):
        raise ValueError(
            f"a key is an int64 tensor of shape (2,), got "
            f"{getattr(k, 'dtype', type(k))}{list(getattr(k, 'shape', ()))}"
        )
    return k


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the int64 bits of ``z``."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def impl_tag(k: torch.Tensor) -> torch.Tensor:
    """The stream tag of the key ``k`` (2,), or of each key of a stack
    (..., 2): int64 tensors, read on the device."""
    return _srl(k[..., 1], _TAG_SHIFT)


def _splitmix64(z: torch.Tensor) -> torch.Tensor:
    z = z + _GOLDEN
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def child_seeds(k: torch.Tensor, index) -> torch.Tensor:
    """The child seeds ``splitmix64(seed ^ splitmix64(counter + index))``
    of the key ``k`` (2,), or of each key of a stack (..., 2), as int64
    tensors (``index`` an int or an int64 tensor)."""
    return _splitmix64(k[..., 0] ^ _splitmix64(k[..., 1] + index))


def split(k: torch.Tensor, num: int = 1) -> tuple[torch.Tensor, list[Seed]]:
    """Consume ``num`` child seeds from ``k``: returns the key with its
    counter advanced by ``num`` (made on ``k``'s device) and the seeds
    ``Seed(k, 0) .. Seed(k, num - 1)``."""
    check_key(k)
    advanced = torch.cat((k[:1], k[1:] + num))
    return advanced, [Seed(k, i) for i in range(num)]


def child(k: torch.Tensor, index: int = 0) -> Seed:
    """Child seed ``index`` of ``k`` without advancing it: what
    ``split(k)[1][index]`` gives, for a key that is consumed whole."""
    return Seed(check_key(k), index)


def as_seed(seed, offset: int = 0) -> Seed:
    """The seed ``offset`` places after ``seed``: child ``offset`` of a key
    tensor, or ``Seed(key, index + offset)`` of a :class:`Seed`.  An
    operator that launches the draw kernel k times draws from ``seed`` ..
    ``seed + k - 1``, so a caller hands consecutive operators seeds at
    least that far apart (see the DE family)."""
    if isinstance(seed, torch.Tensor):
        return child(seed, offset)
    return Seed(check_key(seed.key), seed.index + offset)


def split_keys(k: torch.Tensor, num: int) -> list[torch.Tensor]:
    """``num`` independent child keys ``[child_i, tag]`` of ``k`` (``tag``
    the top byte of ``k``'s counter word, so a child draws from its
    parent's stream family), made on ``k``'s device (the counterpart of
    ``jax.random.split(key, num)``)."""
    check_key(k)
    idx = torch.arange(num, dtype=torch.int64, device=k.device)
    keys = torch.stack((child_seeds(k, idx), (k[1] & _TAG_MASK).expand(num)), dim=1)
    return list(keys.unbind(0))


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The key ``[child, tag]`` of ``k`` for the int64 word ``data`` (a
    tensor, read on the device): child ``data`` of ``k``, the counterpart
    of ``jax.random.fold_in``."""
    check_key(k)
    return torch.stack((child_seeds(k, data), k[1] & _TAG_MASK))


def seed_value(seed, device: torch.device | str | None = None):
    """The 64-bit Philox key of ``seed``: a 0-dim int64 tensor (same bits)
    on ``device`` (default: the key's) for a :class:`Seed`, the integer
    itself for an integer."""
    if isinstance(seed, Seed):
        k = check_key(seed.key)
        if device is not None:
            k = k.to(device)
        return child_seeds(k, int(seed.index))
    return int(seed) & _M64


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product ``m * x`` for a 32-bit
    constant ``m`` and int64 ``x`` in [0, 2^32), without int64 overflow: the
    product is formed from two 48-bit partial products."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _M32


def philox4x32(counter: Sequence[torch.Tensor], seed) -> list[torch.Tensor]:
    """Philox4x32-10 of four int64 tensors of 32-bit counter words under the
    64-bit ``seed`` (an integer, or an int64 tensor holding its bits; key
    words ``seed & 0xffffffff``, ``seed >> 32``); returns the four output
    words as int64 tensors in [0, 2^32)."""
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


def philox_words(seed, numel: int, device: torch.device | str) -> list[torch.Tensor]:
    """The four Philox output words for element counters ``0..numel-1``
    under ``seed`` (a :class:`Seed` or an integer), in int64 tensor
    operations: the plain version of the draw kernels."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    return philox4x32((idx & _M32, idx >> 32, zero, zero), seed_value(seed, device))


def _numel(shape: Sequence[int]) -> int:
    numel = 1
    for s in shape:
        numel *= s
    return numel


def uniform(
    seed,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """U[0, 1) of ``shape`` from the first Philox word of each element — the
    same bits on every device (``None``: the CUDA card, as
    :func:`~evox_tpu_torch.resolve_device`)."""
    from ..ops.philox import philox_draws

    shape = tuple(shape)
    (u,) = philox_draws(seed, _numel(shape), [dtype], resolve_device(device))
    return u.reshape(shape)


def normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard normals from uniforms in [0, 1), as ``jax.random.normal``
    makes them: ``v = max(lo, u * (1 - lo) + lo)`` with ``lo`` the value of
    the dtype next above -1 (both in the dtype), then ``sqrt(2) *
    erfinv(v)``."""
    lo_t = torch.nextafter(torch.tensor(-1.0, dtype=u.dtype), torch.tensor(0.0, dtype=u.dtype))
    lo, span = float(lo_t), float(torch.tensor(1.0, dtype=u.dtype) - lo_t)
    v = torch.clamp(u * span + lo, min=lo)
    return torch.erfinv(v) * math.sqrt(2.0)


def normal(
    seed,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """N(0, 1) of ``shape``: :func:`normal_from_uniform` of one
    :func:`uniform` draw (one launch of the draw kernel on the card)."""
    return normal_from_uniform(uniform(seed, shape, dtype, device))


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel values from uniforms in [0, 1), as
    ``jax.random.gumbel`` makes them: ``-log(-log(v))`` of ``v = max(tiny,
    u * (1 - tiny) + tiny)`` (``tiny`` the dtype's smallest normal)."""
    tiny = torch.finfo(u.dtype).tiny
    span = float(torch.tensor(1.0, dtype=u.dtype) - torch.tensor(tiny, dtype=u.dtype))
    v = torch.clamp(u * span + tiny, min=tiny)
    return -torch.log(-torch.log(v))


def categorical(
    seed,
    logits: torch.Tensor,
    shape: Sequence[int],
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Categories of ``shape`` (int64) drawn from the last axis of
    ``logits`` (1-D, on the device), by the Gumbel-max construction of
    ``jax.random.categorical``: the first index of the largest
    ``gumbel + logits`` over a draw of ``(*shape, k)`` uniforms."""
    shape = tuple(shape)
    u = uniform(seed, shape + (logits.shape[-1],), logits.dtype, device)
    return torch.argmax(gumbel_from_uniform(u) + logits, dim=-1)


def randint_bits(word: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """Integers in ``[low, high)`` from 32-bit words by multiply-shift
    (``low + (word * (high - low)) >> 32``), int64."""
    span = int(high) - int(low)
    if not 0 < span <= 1 << 31:
        raise ValueError(f"randint needs 0 < high - low <= 2^31, got [{low}, {high})")
    return int(low) + ((word * span) >> 32)


def randint(
    seed,
    shape: Sequence[int],
    low: int,
    high: int,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Uniform integers in ``[low, high)`` of ``shape`` (int64) from the
    first Philox word of each element — the same values on every device
    (``None``: the CUDA card, as :func:`~evox_tpu_torch.resolve_device`)."""
    from ..ops.philox import philox_draws

    shape = tuple(shape)
    (v,) = philox_draws(seed, _numel(shape), [(int(low), int(high))], resolve_device(device))
    return v.reshape(shape)


def _words31(seed, shape: Sequence[int], device) -> torch.Tensor:
    """31-bit words (int64 in [0, 2^31)) of ``shape``, one Philox draw."""
    from ..ops.philox import philox_draws

    shape = tuple(shape)
    (w,) = philox_draws(seed, _numel(shape), [(0, 1 << 31)], resolve_device(device))
    return w.reshape(shape)


def randint_below(
    seed,
    shape: Sequence[int],
    span: torch.Tensor,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Uniform integers in ``[0, span)`` (int64) for a ``span`` held in a
    0-dim tensor on the device (1 <= span <= 2^31): 31-bit words mapped by
    the multiply-shift ``(word * span) >> 31``, so no host reads the bound
    and a captured graph draws with the span of each replay."""
    return (_words31(seed, shape, device) * span.to(torch.int64)) >> 31


def permutation(seed, shape, device: torch.device | str | None = None) -> torch.Tensor:
    """Random permutations of ``0 .. shape[-1] - 1`` along the last axis
    (int64 of ``shape``; an int ``shape`` is one permutation): the stable
    argsort of one draw of 31-bit words, ties broken by index (the
    counterpart of ``jax.random.permutation``)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.argsort(_words31(seed, shape, device), dim=-1, stable=True)
