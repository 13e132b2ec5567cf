"""Utilities of the port: random streams, state conversion, tensor helpers,
the parameters <-> vector adapter and operators with batching rules.
``tree_flatten``/``tree_unflatten`` are ``torch.utils._pytree``'s (the
reference EvoX's re-exports), which flatten the port's ``State``."""

from torch.utils._pytree import tree_flatten, tree_unflatten

from . import convert, ops, rng, vmap_ops
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
]
