"""Sampling operators (counterpart of ``evox_tpu/operators/sampling``;
Das-Dennis only so far)."""

__all__ = ["uniform_sampling"]

from .uniform import uniform_sampling
