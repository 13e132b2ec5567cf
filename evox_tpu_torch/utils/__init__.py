"""Utilities of the port: random streams, state conversion and tensor
helpers."""

from . import convert, ops, rng
from .ops import lexsort, nanmax, nanmedian, nanmin

__all__ = ["convert", "ops", "rng", "lexsort", "nanmax", "nanmedian", "nanmin"]
