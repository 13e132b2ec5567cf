"""Utilities of the port: random streams and state conversion."""

from . import convert, rng

__all__ = ["convert", "rng"]
