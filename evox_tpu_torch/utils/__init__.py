"""Utilities of the port: random streams, state conversion, tensor helpers,
the parameters <-> vector adapter, operators with batching rules, the
checkpoint store (:mod:`.checkpoint`, the JAX package's archive format) and
the persistent program cache (:mod:`.exec_cache`: capture records — the
kernel libraries and sink sites a capture needs — under the JAX package's
integrity contract).  ``tree_flatten``/``tree_unflatten`` are
``torch.utils._pytree``'s (the reference EvoX's re-exports), which flatten
the port's ``State``."""

from torch.utils._pytree import tree_flatten, tree_unflatten

from . import checkpoint, convert, exec_cache, ops, rng, vmap_ops
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
from .exec_cache import ExecCacheStats, ExecutableCache, abstract_signature, enable_xla_compilation_cache
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
    "AsyncCheckpointWriter", "exec_cache", "ExecutableCache", "ExecCacheStats", "abstract_signature",
    "enable_xla_compilation_cache",
]
