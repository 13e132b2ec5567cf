"""Utilities of the port: random streams, state conversion, tensor helpers,
the parameters <-> vector adapter, operators with batching rules and the
checkpoint store (:mod:`.checkpoint`, the JAX package's archive format).
``tree_flatten``/``tree_unflatten`` are ``torch.utils._pytree``'s (the
reference EvoX's re-exports), which flatten the port's ``State``.

Not ported yet: the persistent executable cache (``exec_cache.py``:
``ExecutableCache``, ``ExecCacheStats``, ``abstract_signature``,
``enable_xla_compilation_cache``; ROADMAP Queue 1 item 13.2); importing one
of its names raises :class:`ImportError`."""

from torch.utils._pytree import tree_flatten, tree_unflatten

from . import checkpoint, convert, ops, rng, vmap_ops
from .checkpoint import (
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    CheckpointError,
    CheckpointStore,
    ReadOnlyCheckpointStore,
    atomic_write_text,
    load_state,
    quarantine_target,
    read_manifest,
    save_state,
    verify_checkpoint,
)
from .ops import (
    clamp,
    clamp_float,
    clamp_int,
    clip,
    lexsort,
    maximum,
    maximum_float,
    maximum_int,
    minimum,
    minimum_float,
    minimum_int,
    nanmax,
    nanmedian,
    nanmin,
    randint,
    switch,
)
from .params_vector import ParamsAndVector
from .vmap_ops import VmapInfo, host_op, register_vmap_op

__all__ = [
    "convert", "ops", "rng", "vmap_ops",
    "clamp", "clamp_float", "clamp_int", "clip", "lexsort", "maximum", "maximum_float", "maximum_int",
    "minimum", "minimum_float", "minimum_int", "nanmax", "nanmedian", "nanmin", "randint", "switch",
    "ParamsAndVector", "VmapInfo", "host_op", "register_vmap_op", "tree_flatten", "tree_unflatten",
    "checkpoint", "save_state", "atomic_write_text", "load_state", "read_manifest", "verify_checkpoint",
    "quarantine_target", "CheckpointError", "CheckpointCorruptError", "CheckpointStore", "ReadOnlyCheckpointStore",
    "AsyncCheckpointWriter",
]

_NOT_PORTED = ("ExecutableCache", "ExecCacheStats", "abstract_signature", "enable_xla_compilation_cache")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.utils.{name} is not ported yet: it belongs to the executable cache "
            f"(utils/exec_cache.py, ROADMAP Queue 1 item 13.2)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
