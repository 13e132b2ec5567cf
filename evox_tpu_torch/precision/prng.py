"""Named key streams (counterpart of ``evox_tpu/precision/prng.py``, the
``key_impl`` knob).

**One generator, named streams.**  The JAX package's ``key_impl`` selects a
generator: Threefry (the default) or the TPU's hardware ``rbg``.  The port
has one generator, Philox4x32-10 (:mod:`evox_tpu_torch.utils.rng`, on the
card ``csrc/philox.cuh``), so here a ``key_impl`` name selects a **stream
family**, not a generator: every name draws with the same kernels at the
same throughput.  What carries over is the contract the knob gives:

* within one name, runs are deterministic as before (eager == fused,
  solo == vmapped);
* across names, the same seed draws different numbers, by construction;
* a key handed to a workflow pinned to another name is re-seeded
  deterministically (:func:`coerce_key`), never reinterpreted.

**Encoding.**  A key stays the (2,) int64 ``[seed, counter]``; the top
byte of the counter word is the name's tag (``threefry2x32`` 0, ``rbg`` 1,
``unsafe_rbg`` 2; :data:`~evox_tpu_torch.utils.rng.IMPL_TAGS`).  Child
seeds hash the whole counter word and :func:`~evox_tpu_torch.utils.rng.
split_keys` copies the tag into the child keys, so the streams of two tags
differ and no kernel changes.  Tag 0 leaves every key of the default
stream bit for bit what it was before the knob.

**Where the tag is read.**  :func:`coerce_key` is tensor operations only:
it selects between the key and its re-seeded form with ``torch.where`` on
the tag, so it reads no value on the host, runs under ``torch.func.vmap``
(``vmap(wf.init)(keys, ids)``) and inside a CUDA graph capture.  (JAX
decides this from the key's type, statically; a port key's name is data.)
:func:`key_impl_name` and :func:`state_key_impl` read the tag on the host,
for host-side records only.

:func:`resolve_key_impl` honours the ``EVOX_TPU_KEY_IMPL`` environment
variable, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from ..utils import rng

__all__ = [
    "KEY_IMPLS",
    "resolve_key_impl",
    "make_key",
    "coerce_key",
    "key_impl_name",
    "state_key_impl",
]

# The names, in tag order (rng.IMPL_TAGS).
KEY_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")

DEFAULT_KEY_IMPL = "threefry2x32"

_ENV_KEY_IMPL = "EVOX_TPU_KEY_IMPL"


def resolve_key_impl(impl: str | None) -> str:
    """Canonical name for a knob value: the explicit argument first, then
    the ``EVOX_TPU_KEY_IMPL`` environment variable, then the default
    (``threefry2x32``, the stream of every key made without the knob)."""
    name = impl or os.environ.get(_ENV_KEY_IMPL) or DEFAULT_KEY_IMPL
    if name not in KEY_IMPLS:
        raise ValueError(
            f"unknown PRNG key impl {name!r}; expected one of {KEY_IMPLS}"
        )
    return name


def make_key(
    seed: int, impl: str | None = None, device: torch.device | str | None = None
) -> torch.Tensor:
    """A key of the resolved stream family (on ``device``; ``None`` is the
    CPU, as for :func:`~evox_tpu_torch.utils.rng.key`)."""
    return rng.key(int(seed), device, impl=resolve_key_impl(impl))


def key_impl_name(key: torch.Tensor) -> str:
    """The name of a key's stream family (of the first key of a stack).
    Reads the key on the host."""
    tag = int(rng.impl_tag(key).reshape(-1)[0])
    if not 0 <= tag < len(KEY_IMPLS):
        raise ValueError(f"a key with stream tag {tag} names no key impl of {KEY_IMPLS}")
    return KEY_IMPLS[tag]


def _is_key(name: Any, leaf: Any) -> bool:
    return (
        name == "key"
        and isinstance(leaf, torch.Tensor)
        and leaf.dtype == torch.int64
        and leaf.ndim >= 1
        and leaf.shape[-1] == 2
    )


def state_key_impl(state: Any) -> str | None:
    """The stream family a state carries: that of its first key leaf (a
    leaf named ``key``) in tree order, or ``None`` when it has none.  Reads
    the key on the host."""

    def first(node: Any) -> torch.Tensor | None:
        if isinstance(node, Mapping):
            for name, leaf in node.items():
                if _is_key(name, leaf):
                    return leaf
                found = first(leaf)
                if found is not None:
                    return found
        elif isinstance(node, (tuple, list)):
            for leaf in node:
                found = first(leaf)
                if found is not None:
                    return found
        return None

    key = first(state)
    return None if key is None else key_impl_name(key)


def coerce_key(
    key_or_seed: Any, impl: str | None = None, device: torch.device | str | None = None
) -> torch.Tensor:
    """A key of the requested stream family, deterministically.

    * An ``int`` seed builds a fresh key of the family (on ``device``).
    * A key of the family comes back with the same value.
    * A key of another family is re-seeded: its two words are folded, in
      order, into a zero key of the target family
      (:func:`~evox_tpu_torch.utils.rng.fold_in`, the counterpart of
      ``jax.random.fold_in``).

    For a key, both forms are computed and one is selected on the device
    with ``torch.where``: no value is read on the host."""
    target = resolve_key_impl(impl)
    if not isinstance(key_or_seed, torch.Tensor):
        return make_key(int(key_or_seed), target, device)
    key = rng.check_key(key_or_seed)
    if device is not None:
        key = key.to(device)
    tag = rng.IMPL_TAGS[target]
    # The zero key of the target family, made on the device (a fill, not a
    # copy from the host).
    zero = torch.stack((torch.zeros_like(key[0]), torch.full_like(key[1], rng.signed64(tag << 56))))
    reseeded = rng.fold_in(rng.fold_in(zero, key[0]), key[1])
    return torch.where(rng.impl_tag(key) == tag, key, reseeded)
