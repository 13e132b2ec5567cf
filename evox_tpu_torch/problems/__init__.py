"""Problem library (counterpart of ``evox_tpu/problems``; numerical only so
far)."""

__all__ = ["numerical"]

from . import numerical
